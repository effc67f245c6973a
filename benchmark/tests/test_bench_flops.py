"""The frozen FLOP counts of the configuration files, recounted over the
reference on the meta device, and the attention sites the yardstick
counts against those the reference runs."""

import json
from pathlib import Path

import pytest
import torch

import flopcount
import yardstick as Y
from reference import nets

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
COUNTS = {"ldm-kl-lin": flopcount.ldm_counts, "vae-kl-gan": flopcount.vae_gan_counts}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_frozen_flops_match_a_recount(name):
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    assert COUNTS[name](config) == config["flops"]


def test_unet_attention_sites_are_the_references():
    config = json.loads((CONFIGS / "ldm-kl-lin.json").read_text())
    ua, r = nets.unet_arch(config), nets.latent_res(config["vae"])
    P = {l.name: torch.empty(l.shape, device="meta") for l in nets.unet_leaves(ua)}
    sites = []
    x = torch.empty(2, r, r, ua["z_dim"], device="meta")
    nets.unet(P, ua, x, torch.zeros(2, dtype=torch.long, device="meta"), sites=sites)
    assert [(N, C) for _, N, C, _ in sites] == Y.unet_attention_sites(ua, r)
    assert len(sites) == 14


def test_vae_attention_sites_are_the_references():
    config = json.loads((CONFIGS / "vae-kl-gan.json").read_text())
    P = {l.name: torch.empty(l.shape, device="meta") for l in nets.vae_leaves(config)}
    H, r = config["init_resolution"], nets.latent_res(config)
    enc, dec = [], []
    nets.vae_encode(P, config, torch.empty(1, H, H, 3, device="meta"), sites=enc)
    nets.vae_decode(P, config, torch.empty(1, r, r, config["z_dim"], device="meta"), sites=dec)
    want = Y.vae_attention_sites(config)
    assert [(N, C) for _, N, C, _ in enc] == want["encode"]
    assert [(N, C) for _, N, C, _ in dec] == want["decode"]


def test_attention_work_counts_each_operand_once():
    f, b = Y.attention_forward(2, 1024, 128)
    assert f == 4 * 2 * 1024 * 1024 * 128 and b == 8 * 2 * 1024 * 128
    f, b = Y.attention_backward(2, 1024, 128)
    assert f == 10 * 2 * 1024 * 1024 * 128 and b == 14 * 2 * 1024 * 128
    # bound by operations at N = 1024, by bytes at N = 16
    assert Y.least_seconds([Y.attention_forward(1, 1024, 128)]) == pytest.approx(
        4 * 1024 * 1024 * 128 / Y.PEAK_BF16_FLOPS)
    assert Y.least_seconds([Y.attention_forward(1, 16, 512)]) == pytest.approx(
        8 * 16 * 512 / Y.PEAK_BYTES)
