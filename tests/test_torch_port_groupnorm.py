"""GroupNorm(+SiLU) on the CPU: the fused SiLU sites of the plain path, the
models' state-dict keys, the kernels' tiles, the backward kernels'
arithmetic against autograd, and the operator's autograd wiring (the
kernels replaced by their plain statements).  The kernels themselves are
held on the card by tests/test_torch_port_groupnorm_cuda.py."""

import hashlib
import importlib

import pytest
import torch
from torch import nn

from image_diffusion_torch import ops
from image_diffusion_torch.core.config import UNetArch, VAEArch
from image_diffusion_torch.models import build_unet, build_vae
from image_diffusion_torch.models.layers import GroupNorm
from image_diffusion_torch.models.unet import UNet
from image_diffusion_torch.models.vae import VAE

# the module (`ops.group_norm` is the function it defines)
gn = importlib.import_module("image_diffusion_torch.ops.group_norm")

TINY_UNET = UNetArch(channels=(16, 32), mid_channels=(32, 32), time_dim=16, num_res_layers=1,
                     num_heads=2, num_groups=4)
TINY_VAE = VAEArch(channels=(8, 16), z_dim=3, enc_num_res_blocks=1, dec_num_res_blocks=1,
                   init_resolution=16, num_groups=4)

# state-dict keys of the tiny models as the original implementation's
# layout names them, an nn.SiLU at every index now held by an nn.Identity
UNET_KEYS = """
    class_embedding.weight time_embedding.factor time_embedding.embeddings.0.weight
    time_embedding.embeddings.0.bias time_embedding.embeddings.2.weight
    time_embedding.embeddings.2.bias in_conv.weight in_conv.bias
    down_blocks.0.first_halfs.0.layers.0.weight down_blocks.0.first_halfs.0.layers.0.bias
    down_blocks.0.first_halfs.0.layers.2.weight down_blocks.0.first_halfs.0.layers.2.bias
    down_blocks.0.time_projs.0.1.weight down_blocks.0.time_projs.0.1.bias
    down_blocks.0.second_halfs.0.layers.0.weight down_blocks.0.second_halfs.0.layers.0.bias
    down_blocks.0.second_halfs.0.layers.2.weight down_blocks.0.second_halfs.0.layers.2.bias
    down_blocks.0.residuals.0.weight down_blocks.0.residuals.0.bias
    down_blocks.0.self_attns.0.groupnorm.weight down_blocks.0.self_attns.0.groupnorm.bias
    down_blocks.0.self_attns.0.to_q.weight down_blocks.0.self_attns.0.to_q.bias
    down_blocks.0.self_attns.0.to_k.weight down_blocks.0.self_attns.0.to_k.bias
    down_blocks.0.self_attns.0.to_v.weight down_blocks.0.self_attns.0.to_v.bias
    down_blocks.0.self_attns.0.out_proj.weight down_blocks.0.self_attns.0.out_proj.bias
    downsamples.0.down.weight downsamples.0.down.bias mid_blocks.0.first_halfs.0.layers.0.weight
    mid_blocks.0.first_halfs.0.layers.0.bias mid_blocks.0.first_halfs.0.layers.2.weight
    mid_blocks.0.first_halfs.0.layers.2.bias mid_blocks.0.time_projs.0.1.weight
    mid_blocks.0.time_projs.0.1.bias mid_blocks.0.second_halfs.0.layers.0.weight
    mid_blocks.0.second_halfs.0.layers.0.bias mid_blocks.0.second_halfs.0.layers.2.weight
    mid_blocks.0.second_halfs.0.layers.2.bias mid_blocks.0.residuals.0.weight
    mid_blocks.0.residuals.0.bias mid_blocks.0.self_attns.0.groupnorm.weight
    mid_blocks.0.self_attns.0.groupnorm.bias mid_blocks.0.self_attns.0.to_q.weight
    mid_blocks.0.self_attns.0.to_q.bias mid_blocks.0.self_attns.0.to_k.weight
    mid_blocks.0.self_attns.0.to_k.bias mid_blocks.0.self_attns.0.to_v.weight
    mid_blocks.0.self_attns.0.to_v.bias mid_blocks.0.self_attns.0.out_proj.weight
    mid_blocks.0.self_attns.0.out_proj.bias ups.0.first_halfs.0.layers.0.weight
    ups.0.first_halfs.0.layers.0.bias ups.0.first_halfs.0.layers.2.weight
    ups.0.first_halfs.0.layers.2.bias ups.0.time_projs.0.1.weight ups.0.time_projs.0.1.bias
    ups.0.second_halfs.0.layers.0.weight ups.0.second_halfs.0.layers.0.bias
    ups.0.second_halfs.0.layers.2.weight ups.0.second_halfs.0.layers.2.bias
    ups.0.residuals.0.weight ups.0.residuals.0.bias ups.0.self_attns.0.groupnorm.weight
    ups.0.self_attns.0.groupnorm.bias ups.0.self_attns.0.to_q.weight
    ups.0.self_attns.0.to_q.bias ups.0.self_attns.0.to_k.weight ups.0.self_attns.0.to_k.bias
    ups.0.self_attns.0.to_v.weight ups.0.self_attns.0.to_v.bias
    ups.0.self_attns.0.out_proj.weight ups.0.self_attns.0.out_proj.bias upsamples.0.conv.weight
    upsamples.0.conv.bias out_conv.0.weight out_conv.0.bias out_conv.2.weight out_conv.2.bias
""".split()
VAE_KEYS = """
    encoder.down.0.weight encoder.down.0.bias encoder.down.1.branch.0.weight
    encoder.down.1.branch.0.bias encoder.down.1.branch.2.weight encoder.down.1.branch.2.bias
    encoder.down.1.branch.3.weight encoder.down.1.branch.3.bias encoder.down.1.branch.5.weight
    encoder.down.1.branch.5.bias encoder.down.1.residual_wrapper.weight
    encoder.down.1.residual_wrapper.bias encoder.down.2.down.weight encoder.down.2.down.bias
    encoder.down.3.branch.0.weight encoder.down.3.branch.0.bias encoder.down.3.branch.2.weight
    encoder.down.3.branch.2.bias encoder.down.3.branch.3.weight encoder.down.3.branch.3.bias
    encoder.down.3.branch.5.weight encoder.down.3.branch.5.bias encoder.down.4.groupnorm.weight
    encoder.down.4.groupnorm.bias encoder.down.4.to_q.weight encoder.down.4.to_q.bias
    encoder.down.4.to_k.weight encoder.down.4.to_k.bias encoder.down.4.to_v.weight
    encoder.down.4.to_v.bias encoder.down.4.out_proj.weight encoder.down.4.out_proj.bias
    encoder.down.5.branch.0.weight encoder.down.5.branch.0.bias encoder.down.5.branch.2.weight
    encoder.down.5.branch.2.bias encoder.down.5.branch.3.weight encoder.down.5.branch.3.bias
    encoder.down.5.branch.5.weight encoder.down.5.branch.5.bias encoder.down.6.weight
    encoder.down.6.bias encoder.down.8.weight encoder.down.8.bias encoder.down.9.weight
    encoder.down.9.bias decoder.up.0.weight decoder.up.0.bias decoder.up.1.weight
    decoder.up.1.bias decoder.up.2.branch.0.weight decoder.up.2.branch.0.bias
    decoder.up.2.branch.2.weight decoder.up.2.branch.2.bias decoder.up.2.branch.3.weight
    decoder.up.2.branch.3.bias decoder.up.2.branch.5.weight decoder.up.2.branch.5.bias
    decoder.up.3.groupnorm.weight decoder.up.3.groupnorm.bias decoder.up.3.to_q.weight
    decoder.up.3.to_q.bias decoder.up.3.to_k.weight decoder.up.3.to_k.bias
    decoder.up.3.to_v.weight decoder.up.3.to_v.bias decoder.up.3.out_proj.weight
    decoder.up.3.out_proj.bias decoder.up.4.branch.0.weight decoder.up.4.branch.0.bias
    decoder.up.4.branch.2.weight decoder.up.4.branch.2.bias decoder.up.4.branch.3.weight
    decoder.up.4.branch.3.bias decoder.up.4.branch.5.weight decoder.up.4.branch.5.bias
    decoder.up.5.branch.0.weight decoder.up.5.branch.0.bias decoder.up.5.branch.2.weight
    decoder.up.5.branch.2.bias decoder.up.5.branch.3.weight decoder.up.5.branch.3.bias
    decoder.up.5.branch.5.weight decoder.up.5.branch.5.bias decoder.up.5.residual_wrapper.weight
    decoder.up.5.residual_wrapper.bias decoder.up.6.conv.weight decoder.up.6.conv.bias
    decoder.up.7.branch.0.weight decoder.up.7.branch.0.bias decoder.up.7.branch.2.weight
    decoder.up.7.branch.2.bias decoder.up.7.branch.3.weight decoder.up.7.branch.3.bias
    decoder.up.7.branch.5.weight decoder.up.7.branch.5.bias decoder.up.8.weight
    decoder.up.8.bias decoder.up.10.weight decoder.up.10.bias
""".split()
# (count, sha256 of the space-joined keys) at the shipped widths
FULL_WIDTH_KEYS = {
    "unet": (332, "337c0e725b056d0d1909cc7dd6d8b94e256ae0a155938974e76662b46e2e0456"),
    "kl": (196, "672c224e3f4561811f64ed588d85502485d0cdd3208b52df7aa55b4010625b06"),
    "vq": (199, "b1c37b8c7411db20f4f8231067af8db65b5b410e9db900320418c4752040efab"),
}

# (C, H*W) of every GroupNorm of the shipped UNet (32x32 latents) and VAE
# (128x128 images)
UNET_SHAPES = [(128, 1024), (256, 1024), (512, 1024), (256, 256), (384, 256), (768, 256),
               (384, 64), (512, 64), (1024, 64), (512, 16)]
VAE_SHAPES = [(128, 16384), (256, 16384), (128, 4096), (256, 4096), (384, 4096), (256, 1024),
              (384, 1024)]


def _x(shape, shift=0.0, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2.0 + shift
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _affine(C, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0.0, 30.0])
def test_silu_site_on_the_plain_path_is_groupnorm_then_silu(dtype, shift):
    """`GroupNorm(g, c, silu=True)` on the CPU equals `GroupNorm` followed by
    `nn.SiLU` to the bit, in fp32 and in bf16."""
    x = _x((2, 32, 6, 6), shift, dtype)
    fused, plain = GroupNorm(8, 32, silu=True), GroupNorm(8, 32)
    w, b = _affine(32)
    for m in (fused, plain):
        m.weight.data.copy_(w)
        m.bias.data.copy_(b)
    with torch.no_grad():
        assert torch.equal(fused(x), nn.SiLU()(plain(x)))


@pytest.mark.parametrize("build,keys", [
    (lambda: build_unet(TINY_UNET, torch.float32, "cpu"), UNET_KEYS),
    (lambda: build_vae(TINY_VAE, torch.float32, "cpu"), VAE_KEYS),
], ids=["unet", "vae"])
def test_state_dict_keys_are_the_original_layouts(build, keys):
    assert list(build().state_dict()) == keys


@pytest.mark.parametrize("name", list(FULL_WIDTH_KEYS))
def test_full_width_state_dict_keys_are_unchanged(name):
    arch = {"unet": UNetArch(), "kl": VAEArch(),
            "vq": VAEArch(bottleneck="vq", codebook_size=1024)}[name]
    with torch.device("meta"):
        model = UNet(arch) if name == "unet" else VAE(arch)
    keys = list(model.state_dict())
    assert (len(keys), hashlib.sha256(" ".join(keys).encode()).hexdigest()) == FULL_WIDTH_KEYS[name]


def test_silu_is_fused_at_the_models_gn_silu_sites_alone():
    """The shipped UNet: 43 norms, the 29 before a conv fused (not the 14
    attention pre-norms); the VAE: every norm but the encoder's and the
    decoder's attention pre-norm.  Each fused norm sits before the
    Identity that holds its SiLU's index."""
    with torch.device("meta"):
        unet, vae = UNet(UNetArch()), VAE(VAEArch())
    for model, counts in ((unet, (43, 29)), (vae.encoder, (18, 17)), (vae.decoder, (22, 21))):
        norms = [m for m in model.modules() if isinstance(m, GroupNorm)]
        assert (len(norms), sum(m.silu for m in norms)) == counts
        for seq in (m for m in model.modules() if isinstance(m, nn.Sequential)):
            mods = list(seq)
            for m, after in zip(mods, mods[1:]):
                if isinstance(m, GroupNorm):
                    assert m.silu and isinstance(after, nn.Identity)


@pytest.mark.parametrize("C,HW", UNET_SHAPES + VAE_SHAPES)
def test_tiles_cover_each_row_within_the_kernels_bounds(C, HW):
    """Whole pixel lanes of 16-byte vectors, at most 256 threads, every
    pixel in exactly one tile and no tile empty, at least half of 16,384
    elements a tile where the row holds that many (tiles are evened out),
    at most 16 tiles a row; the fp32
    partials (a forward tile's G group sums, a backward tile's C channel
    sums) are under a sixteenth of the bytes the kernels stream."""
    threads, P, T = gn.tiling(HW, C)
    V = C // 8
    assert threads % V == 0 and threads <= 256 and 0 < P <= HW
    assert P * T >= HW > P * (T - 1)
    assert T <= 16 and P * C >= min(16384, HW * C) / 2
    assert (P % (threads // V) == 0) or P == HW
    assert T * C * 8 <= HW * C * 10 / 16  # backward: per-channel float2 a tile vs 10 B an element


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shift", [0.0, 30.0])
def test_backward_statement_matches_autograd_of_the_formula(silu, shift):
    """`reference_group_norm_bwd` (the backward kernels' arithmetic, fp32)
    against autograd of the plain formula in float64 on the same values."""
    B, C, G = 3, 48, 4
    x = _x((B, C, 5, 7), shift).double().requires_grad_()
    w, b = (t.double().requires_grad_() for t in _affine(C))
    y = ops.reference_group_norm(x, w, b, G, silu)
    dy = _x(y.shape, seed=3).double()
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), dy)
    xs = x.detach().reshape(B, G, -1)
    mean = xs.mean(-1)
    rstd = torch.rsqrt((xs * xs).mean(-1) - mean * mean + gn.EPS)
    dx, dw, db = ops.reference_group_norm_bwd(dy.float(), x.detach().float(), w.detach().float(),
                                              b.detach().float(), mean.float(), rstd.float(), G, silu)
    rel = lambda a, r: float((a.double() - r).norm() / r.norm())  # noqa: E731
    # fp32 arithmetic on fp32-rounded inputs; at a mean of 30 x - mean loses ~5 bits
    assert rel(dx, gx) < (1e-5 if shift == 0 else 1e-4)
    assert rel(dw, gw) < (1e-5 if shift == 0 else 1e-4)
    assert rel(db, gb) < 1e-5


def _emulate_kernels(monkeypatch):
    """Replace the checks and the launches of `ops/group_norm.py` by plain
    statements of the kernels' arithmetic, so the operator runs on CPU
    tensors; count the calls."""
    calls = {"fwd": 0, "bwd": 0}

    def forward(x, weight, bias, num_groups, silu, with_stats, eps=gn.EPS):
        calls["fwd"] += 1
        B = x.shape[0]
        xs = x.float().reshape(B, num_groups, -1)
        mean = xs.sum(-1) / xs.shape[-1]
        var = torch.clamp((xs * xs).sum(-1) / xs.shape[-1] - mean * mean, min=0.0)
        y = ops.reference_group_norm(x.float(), weight, bias, num_groups, silu, eps).to(x.dtype)
        y = y.contiguous(memory_format=torch.channels_last)
        return (y, mean, torch.rsqrt(var + eps)) if with_stats else (y, None, None)

    def backward(*args):
        calls["bwd"] += 1
        return ops.reference_group_norm_bwd(*args)

    monkeypatch.setattr(gn, "_check", lambda *a, **k: None)
    monkeypatch.setattr(gn, "_launch_forward", forward)
    monkeypatch.setattr(gn, "group_norm_bwd", backward)
    return calls


@pytest.mark.parametrize("silu", [False, True])
def test_operator_hands_its_statistics_and_gradients_through_autograd(silu, monkeypatch):
    """With grad enabled `ops.group_norm` runs as the operator
    `group_norm_fwd`: one forward a call, and its backward gets dy, x,
    weight, bias and the forward's own mean and rstd and returns dx,
    dweight, dbias to the right inputs; under no_grad the forward runs
    alone."""
    calls = _emulate_kernels(monkeypatch)
    B, C, G = 2, 32, 8
    x = _x((B, C, 4, 6), 1.0, torch.bfloat16).requires_grad_()
    w, b = (t.requires_grad_() for t in _affine(C))
    y = ops.group_norm(x, w, b, G, silu)
    dy = _x(y.shape, seed=5, dtype=torch.bfloat16)
    y.backward(dy)
    assert calls == {"fwd": 1, "bwd": 1}
    xs = x.detach().float().reshape(B, G, -1)
    mean = xs.mean(-1)
    rstd = torch.rsqrt(torch.clamp((xs * xs).mean(-1) - mean * mean, min=0.0) + gn.EPS)
    dx, dw, db = ops.reference_group_norm_bwd(dy, x.detach(), w.detach(), b.detach(), mean, rstd,
                                              G, silu)
    torch.testing.assert_close(x.grad.float(), dx.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(w.grad, dw, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(b.grad, db, atol=1e-4, rtol=1e-4)
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == b.grad.dtype == torch.float32
    with torch.no_grad():
        out = ops.group_norm(x, w, b, G, silu)
    assert calls == {"fwd": 2, "bwd": 1} and torch.equal(out, y.detach())


def test_kernel_wrapper_refuses_cpu_tensors():
    x = _x((2, 32, 4, 4), dtype=torch.bfloat16)
    w, b = _affine(32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.group_norm(x, w, b, 8, True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.group_norm(x, w, b, 8, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_takes_the_plain_formula_on_the_cpu(dtype, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path on a CPU tensor")

    monkeypatch.setattr(ops, "group_norm", refuse)
    m = GroupNorm(8, 32, silu=True)
    x = _x((2, 32, 4, 4), dtype=dtype)
    assert torch.equal(m(x), ops.reference_group_norm(x, m.weight, m.bias, 8, True))
