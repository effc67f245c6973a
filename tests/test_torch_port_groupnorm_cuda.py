"""GroupNorm(+SiLU)'s kernel pair (`ops/group_norm.py`,
`ops/csrc/group_norm.cu`) against the plain formula, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_port_groupnorm_cuda.py -q -m cuda --noconftest

Without a card every test skips.
"""

import math

import pytest
import torch

from image_diffusion_torch.ops import group_norm, group_norm_bwd, reference_group_norm

G = 32
# (C, H*W) of every GroupNorm of the shipped UNet (32x32 latents) and VAE
# (128x128 images), each with the rows it is held at: the host-paced paths'
# 2 and a grid's 54-60 for the UNet's, 2 and a decode of 27 below 128x128
UNET_SHAPES = [(128, 1024), (256, 1024), (512, 1024), (256, 256), (384, 256), (768, 256),
               (384, 64), (512, 64), (1024, 64), (512, 16)]
VAE_SHAPES = [(128, 16384), (256, 16384), (128, 4096), (256, 4096), (384, 4096), (256, 1024),
              (384, 1024)]
SHAPES = ([(C, HW, B) for C, HW in UNET_SHAPES for B in (2, 60)]
          + [(C, HW, B) for C, HW in VAE_SHAPES for B in ((2,) if HW == 16384 else (2, 27))])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(B, C, HW, shift=0.0, seed=0):
    """x bf16 (B, C, H, W) in channels_last memory, its mean `shift`; the
    fp32 weight and bias; dy bf16."""
    g = torch.Generator().manual_seed(seed)
    H = int(math.isqrt(HW))
    x = (torch.randn(B, C, H, HW // H, generator=g) * 2.0 + shift).to(torch.bfloat16)
    w = torch.rand(C, generator=g) + 0.5
    b = torch.randn(C, generator=g) * 0.5
    dy = torch.randn(B, C, H, HW // H, generator=g).to(torch.bfloat16)
    cl = torch.channels_last
    return (x.cuda().contiguous(memory_format=cl), w.cuda(), b.cuda(),
            dy.cuda().contiguous(memory_format=cl))


def _ulp(ref: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude of `ref`."""
    return 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)


def _max_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("C,HW,B", SHAPES)
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shift", [0.0, 30.0])
def test_forward_is_nearer_the_fp32_formula_than_the_plain_bf16_path(card, C, HW, B, silu, shift):
    """The kernel's largest error against the plain formula in fp32 on the
    same bf16 input is at most the plain bf16 path's plus one bf16 ulp;
    also at a mean of 30, where E[x^2] - E[x]^2 cancels."""
    x, w, b, _ = _inputs(B, C, HW, shift)
    ref = reference_group_norm(x.float(), w, b, G, silu)
    plain = reference_group_norm(x, w, b, G, silu)
    before = group_norm.launches
    with torch.no_grad():
        y = group_norm(x, w, b, G, silu)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    assert _max_err(y, ref) <= _max_err(plain, ref) + _ulp(ref)


@pytest.mark.cuda
@pytest.mark.parametrize("C,HW,B", SHAPES)
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shift", [0.0, 30.0])
def test_backward_is_nearer_autograd_of_the_fp32_formula_than_the_plain_bf16_path(
        card, C, HW, B, silu, shift):
    """dx against autograd of the fp32 formula on the same bf16 input and
    dy: at most the plain bf16 path's largest error plus one bf16 ulp;
    dweight and dbias (fp32) within 1e-3 relative L2.  One forward and one
    backward launch."""
    x, w, b, dy = _inputs(B, C, HW, shift)
    grads = {}
    for name in ("fp32", "plain", "kernel"):
        xi = (x.float() if name == "fp32" else x.clone()).requires_grad_()
        wi, bi = w.clone().requires_grad_(), b.clone().requires_grad_()
        fwd, bwd = group_norm.launches, group_norm_bwd.launches
        if name == "kernel":
            y = group_norm(xi, wi, bi, G, silu)
        else:
            y = reference_group_norm(xi, wi, bi, G, silu)
        y.backward(dy.to(y.dtype))
        torch.cuda.synchronize()
        launched = (group_norm.launches - fwd, group_norm_bwd.launches - bwd)
        assert launched == ((1, 1) if name == "kernel" else (0, 0))
        grads[name] = (xi.grad, wi.grad, bi.grad)
    (rx, rw, rb), (px, _, _), (kx, kw, kb) = grads["fp32"], grads["plain"], grads["kernel"]
    assert kx.dtype == torch.bfloat16 and kw.dtype == kb.dtype == torch.float32
    assert _max_err(kx, rx) <= _max_err(px, rx) + _ulp(rx)
    for got, ref in ((kw, rw), (kb, rb)):
        assert float((got - ref).norm() / ref.norm()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("C,HW,B", [(128, 1024, 60), (384, 256, 27), (128, 16384, 2)])
@pytest.mark.parametrize("silu", [False, True])
def test_outputs_and_gradients_are_the_same_bits_on_every_run(card, C, HW, B, silu):
    """Two runs of forward and backward give equal bits (no atomics), and a
    row alone gives the bits it gives inside the batch (the tiles follow
    the row's shape, not the batch)."""
    x, w, b, dy = _inputs(B, C, HW, 1.0, seed=7)
    runs = []
    for _ in range(2):
        xi, wi, bi = x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
        y = group_norm(xi, wi, bi, G, silu)
        y.backward(dy)
        runs.append((y.detach(), xi.grad, wi.grad, bi.grad))
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    with torch.no_grad():
        alone = group_norm(x[1:2], w, b, G, silu)
    assert torch.equal(alone, runs[0][0][1:2])


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_does_not_take(card):
    x, w, b, dy = _inputs(2, 128, 64)
    bad = {
        "channels_last": (x.contiguous(), w, b),
        "bfloat16": (x.float(), w, b),
        "CUDA": (x.cpu(), w, b),
        "weight": (x, w.to(torch.bfloat16), b),
    }
    for match, args in bad.items():
        for grad in (False, True):
            with torch.set_grad_enabled(grad), pytest.raises(ValueError, match=match):
                group_norm(*args, G, True)
    with pytest.raises(ValueError, match="multiple of"):
        group_norm(x, w, b, 3, False)
    mean = torch.zeros(2, G, device="cuda")
    with pytest.raises(ValueError, match="channels_last"):
        group_norm_bwd(dy.contiguous(), x, w, b, mean, mean, G, True)
    with pytest.raises(ValueError, match="mean"):
        group_norm_bwd(dy, x, w, b, mean[:, :16], mean, G, True)


@pytest.mark.cuda
def test_full_width_models_launch_the_forward_once_a_norm(card):
    """The shipped UNet's forward launches the forward kernels 43 times (one
    a GroupNorm), the KL-VAE's decode 22 times, and neither the backward."""
    from image_diffusion_torch.core.config import UNetArch, VAEArch
    from image_diffusion_torch.models import build_unet, build_vae

    g = torch.Generator().manual_seed(0)
    unet = build_unet(UNetArch(), device="cuda", generator=g)
    vae = build_vae(VAEArch(), device="cuda", generator=g)
    x, z = torch.randn(2, 32, 32, 3, generator=g), torch.randn(2, 32, 32, 3, generator=g)
    t, c = torch.tensor([3, 700]), torch.tensor([0, 2])
    for run, n in ((lambda: unet(x.cuda(), t.cuda(), c.cuda()), 43), (lambda: vae.decode(z.cuda()), 22)):
        fwd, bwd = group_norm.launches, group_norm_bwd.launches
        with torch.inference_mode():
            out = run()
        torch.cuda.synchronize()
        assert (group_norm.launches - fwd, group_norm_bwd.launches - bwd) == (n, 0)
        assert torch.isfinite(out.float()).all()
