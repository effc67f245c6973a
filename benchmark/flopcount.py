"""Model FLOPs of the measured work, counted by `torch.utils.flop_counter`
over the reference on the meta device (shapes only): matrix products and
convolutions, two operations a multiply-add, forward and backward as the
reference's autograd takes them (no recomputation).  The configuration
files hold these counts frozen; `tests/test_bench_flops.py` recounts
them."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import nets, steps

META = torch.device("meta")


def _empty(leaves) -> dict:
    return {l.name: torch.empty(l.shape, device=META) for l in leaves}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def ldm_counts(config: dict) -> dict[str, int]:
    """unet_forward_per_row, unet_train_per_row (forward and backward of
    the loss), vae_decode_per_image."""
    ua, va = nets.unet_arch(config), config["vae"]
    r, z = nets.latent_res(va), ua["z_dim"]
    leaves = nets.unet_leaves(ua)
    P = _empty(leaves)
    x = torch.empty(1, r, r, z, device=META)
    t = torch.zeros(1, dtype=torch.long, device=META)
    c = torch.zeros(1, dtype=torch.long, device=META)
    m = torch.ones(1, 1, device=META)
    fwd = _count(lambda: nets.unet(P, ua, x, t, c, m))
    train = {"learning_rate": 1e-4, "warmup_steps": 0, "clip_grad": 1.0,
             "cond_drop_prob": config["cond_drop_prob"]}
    trainable = {l.name for l in leaves if l.trainable}
    ids = torch.zeros(2, dtype=torch.long, device=META)
    batch = [(torch.empty(2, r, r, 2 * z, device=META), ids)]
    draw = [(torch.empty(2, r, r, z, device=META), ids,
             torch.empty(2, r, r, z, device=META), torch.empty(2, device=META))]
    sched = nets.schedule(config)
    step = _count(lambda: steps.unet_train(P, trainable, ua, sched, train, batch, draw))
    Pv = _empty(nets.vae_leaves(va))
    dec = _count(lambda: nets.vae_decode(Pv, va, torch.empty(1, r, r, va["z_dim"], device=META)))
    return {"unet_forward_per_row": fwd, "unet_train_per_row": step // 2,
            "vae_decode_per_image": dec}


def vae_gan_counts(config: dict) -> dict[str, int]:
    """vae_gan_step_per_image: one stage-1 step with the discriminator
    active (VAE forward and backward, three discriminator passes and the
    backwards they need, LPIPS on both images and its backward)."""
    r, z = nets.latent_res(config), config["z_dim"]
    vleaves, dleaves = nets.vae_leaves(config), nets.disc_leaves(config["disc_channels"])
    H = config["init_resolution"]
    images = [torch.empty(2, H, H, 3, dtype=torch.uint8, device=META)]
    draws = [(torch.empty(2, dtype=torch.bool, device=META), torch.empty(2, r, r, z, device=META))]
    keys = ("learning_rate", "warmup_steps", "clip_grad", "recon_weight", "percept_weight",
            "prior_weight", "disc_weight")
    step = _count(lambda: steps.vae_gan_train(
        _empty(vleaves), {l.name for l in vleaves if l.trainable}, config,
        _empty(dleaves), {l.name for l in dleaves if l.trainable}, _empty(nets.lpips_leaves()),
        {k: config[k] for k in keys}, images, draws))
    return {"vae_gan_step_per_image": step // 2}
