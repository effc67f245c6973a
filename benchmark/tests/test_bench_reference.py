"""The plain reference against the port at small widths on the CPU, in
fp32 (where the port takes its plain attention path), and the reference's
independence: it imports nothing of the port, JAX or the JAX package."""

import ast
from pathlib import Path

import pytest
import torch

import tiny
from reference import nets, steps
from image_diffusion_torch.core.config import UNetArch, VAEArch, _build
from image_diffusion_torch.models import build_discriminator, build_unet, build_vae
from image_diffusion_torch.models.lpips import LPIPS
from image_diffusion_torch.ops import schedule as S

FORBIDDEN = {"image_diffusion_torch", "image_diffusion_tpu", "jax", "jaxlib", "flax", "optax"}
REFERENCE = Path(__file__).resolve().parents[1] / "reference"
TOL = 1e-4  # fp32 sums in another order


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port_or_jax(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_a_prefix_is_not_a_top_level_name():
    tree = "import image_diffusion_torchvision\nfrom image_diffusion_tpu.x import y\n"
    path = Path(__file__).with_name("_probe_imports.py")
    try:
        path.write_text(tree)
        assert imported_top_levels(path) & FORBIDDEN == {"image_diffusion_tpu"}
    finally:
        path.unlink()


def _unet():
    cfg = tiny.cell("ldm-kl-lin.train-b512").config
    ua = nets.unet_arch(cfg)
    P = nets.make_weights(nets.unet_leaves(ua), 11, "cpu")
    model = build_unet(_build(UNetArch, ua), dtype=torch.float32, device="cpu")
    model.load_state_dict(P)
    return cfg, ua, P, model


def test_unet_matches_the_port():
    _, ua, P, model = _unet()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, 16, 3, generator=g)
    t, c = torch.tensor([0, 400, 999]), torch.tensor([0, 1, 2])
    mask = torch.tensor([[1.], [0.], [1.]])
    with torch.no_grad():
        assert rel(nets.unet(P, ua, x, t, c, mask), model(x, t, c, mask)) < TOL


def test_ddim_update_matches_the_ports_guided_step():
    cfg, ua, P, model = _unet()
    sched = S.make_schedule(1000, cfg["beta_start"], cfg["beta_end"], cfg["noise_type"])
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    labels, scales = torch.tensor([1, 2]), torch.tensor([3.0, 5.0])
    for t, t_prev in ((999, 979), (20, 0), (0, -1)):
        tv, pv = torch.full((2,), t), torch.full((2,), t_prev)
        with torch.no_grad():
            e = model(torch.cat([x, x]), torch.cat([tv, tv]), torch.cat([labels, 0 * labels]),
                      torch.tensor([[1.], [1.], [0.], [0.]]))
            eps = e[2:] + scales.reshape(2, 1, 1, 1) * (e[:2] - e[2:])
            want, _ = S.ddim_step(sched, x, eps, tv, pv, torch.zeros_like(x))
            got = steps.ddim_update(P, ua, steps.alpha_bars(nets.schedule(cfg)), x, tv, pv,
                                    labels, scales)
        assert rel(got, want) < TOL


def test_vae_matches_the_port():
    va = dict(tiny.cell("vae-kl-gan.train-b48").config)
    P = nets.make_weights(nets.vae_leaves(va), 12, "cpu")
    model = build_vae(_build(VAEArch, va), dtype=torch.float32, device="cpu")
    model.load_state_dict(P)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    z = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert rel(nets.vae_encode(P, va, x), model.encode(x)[0]) < TOL
        assert rel(nets.vae_decode(P, va, z), model.decode(z)) < TOL


def test_discriminator_and_lpips_match_the_port():
    D = nets.make_weights(nets.disc_leaves([64, 128, 256]), 13, "cpu")
    disc = build_discriminator((64, 128, 256), torch.float32, "cpu")
    disc.load_state_dict(D)
    W = nets.make_weights(nets.lpips_leaves(), 14, "cpu")
    convs = [(W[f"conv.{i}.weight"], W[f"conv.{i}.bias"]) for i in range(13)]
    lpips = LPIPS(convs, [W[f"lin.{k}"] for k in range(5)])
    g = torch.Generator().manual_seed(4)
    a, b = (torch.rand(3, 32, 32, 3, generator=g) * 2 - 1 for _ in range(2))
    with torch.no_grad():
        assert rel(nets.discriminator(D, 4, a), disc(a)) < TOL
        assert abs(float(nets.lpips(W, a, b)) - float(lpips(a, b))) < TOL * float(lpips(a, b))
