"""The port's flash attention (`ops/attention.py`) against the JAX
package's `_flash_kernel` run in interpret mode on the CPU, its gradient
through `FlashAttention` against `jax.grad` of JAX `flash_attention`, and
the route that sends the VAE's wide one-head sites to it."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.ops.pallas.attention import attention as jattention
from image_diffusion_tpu.ops.pallas.attention import flash_attention as jflash_attention
from image_diffusion_torch import ops
from image_diffusion_torch.core.config import VAEArch
from image_diffusion_torch.models import build_vae
from image_diffusion_torch.ops.attention import (
    FlashAttention,
    flash_attention,
    reference_attention_heads,
    reference_flash_attention,
)


def _qkv(B, H, N, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, N, D)).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("H", [1, 2])
@pytest.mark.parametrize("N", [64, 256])
@pytest.mark.parametrize("D", [48, 128, 384])
def test_plain_version_matches_interpret_mode_kernel(H, N, D):
    """bf16 inputs on both sides.  The JAX kernel feeds fp32 weights to its
    P.V product; the plain version (like the Hopper kernel) rounds them to
    bf16, one bf16 ulp (2^-8 relative) of each weight, and both round the
    output to bf16.  Bar: |port - jax| <= 1e-2 * max|jax| elementwise
    (measured 2.2e-3 to 6.5e-3).  `attention` zero-pads D = 48 to 128 and must give
    the same function."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(2, H, N, D, seed=N + D + H))
    scale = 1.0 / math.sqrt(D)
    ref = np.asarray(jax.jit(lambda q, k, v: jflash_attention(q, k, v, scale, min(256, N), True))(
        q, k, v).astype(jnp.float32))
    padded = np.asarray(jax.jit(lambda q, k, v: jattention(q, k, v, head_dim=D, interpret=True))(
        q, k, v).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    with torch.no_grad():
        got = flash_attention(tq, tk, tv, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (2, H, N, D)
    torch.testing.assert_close(got, reference_flash_attention(tq, tk, tv, scale), atol=0, rtol=0)
    bar = 1e-2 * np.abs(ref).max()
    assert np.abs(got.float().numpy() - ref).max() <= bar
    assert np.abs(got.float().numpy() - padded).max() <= bar


@pytest.mark.parametrize("B,H,N,D", [(1, 1, 64, 64), (2, 1, 64, 384), (1, 2, 128, 128)])
def test_gradient_through_flash_attention_matches_jax(B, H, N, D):
    """fp32 on both sides.  The JAX custom VJP and `FlashAttention` both
    differentiate the einsum path, so the loss sum(out * w), whose output
    gradient w does not depend on the forward's roundings, must give the
    same dq, dk, dv up to fp32 summation order: atol 1e-5 (the gradients
    are O(1))."""
    q, k, v = _qkv(B, H, N, D, seed=D)
    w = np.random.default_rng(1).standard_normal((B, H, N, D)).astype(np.float32)
    scale = 1.0 / math.sqrt(D)
    ref = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jflash_attention(q, k, v, scale, min(256, N), True) * w),
                           argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, scale)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_flash_attention_backward_is_the_einsum_paths_autograd():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 2, 64, 128, seed=3))
    do = torch.randn(1, 2, 64, 128, generator=torch.Generator().manual_seed(0))
    FlashAttention.apply(q, k, v, 0.1).backward(do)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    reference_attention_heads(q, k, v, 0.1).backward(do)
    for a, t in zip(got, (q, k, v)):
        torch.testing.assert_close(a, t.grad, atol=0, rtol=0)


def _emulate_kernel_schedule(q, k, v, scale, keys=64):
    """The Hopper kernel's arithmetic in plain torch: per tile of `keys`
    keys, fp32 scores scaled by an fp32 scale * log2(e); the tile's own row
    max ml, weights exp2(s - ml) and their row sum; then the running max
    m_new = max(m_old, ml), the weights moved to it by exp2(ml - m_new) and
    rounded to bf16 for the P.V product (fp32 sums), and the rescale
    factor exp2(m_old - m_new) applied to the fp32 row sum and accumulator;
    one division by the row sum at the end, output bf16."""
    bf = torch.bfloat16
    scale_log2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    qf, kf, vf = (t.to(bf).float() for t in (q, k, v))
    *lead, N, D = q.shape
    m = torch.full((*lead, N, 1), -math.inf)
    l = torch.zeros(*lead, N, 1)
    acc = torch.zeros(*lead, N, D)
    for j in range(0, N, keys):
        s = torch.matmul(qf, kf[..., j:j + keys, :].transpose(-1, -2)) * scale_log2
        ml = s.amax(dim=-1, keepdim=True)
        w = torch.exp2(s - ml)
        m_new = torch.maximum(m, ml)
        f, alpha = torch.exp2(ml - m_new), torch.exp2(m - m_new)
        l = l * alpha + w.sum(dim=-1, keepdim=True) * f
        acc = acc * alpha + torch.matmul((w * f).to(bf).float(), vf[..., j:j + keys, :])
        m = m_new
    return (acc / l).to(bf)


@pytest.mark.parametrize("B,H,N,D", [(2, 1, 1024, 384), (3, 2, 256, 128)])
def test_kernel_tile_schedule_meets_the_card_bars(B, H, N, D):
    """The kernel's schedule (64-key tiles, bf16 weights rounded at the
    running max) against the plain version, within the bars the card holds
    the kernel to: |err| <= 2e-2 + 2e-2 |plain| elementwise and
    max|err| / max|plain| < 2e-2.

    It is the same function up to roundings: each weight's bf16 rounding
    (half an ulp, at most 2^-8 of it) falls at another scale, and each
    output's too, so |got - plain| <= 2^-7 (softmax . |v| + |plain|)
    elementwise, with 64-key tiles and with one tile of all keys (measured
    at most 0.27 of that).  A schedule without the rescale, without moving
    the weights to the running max, or with exp for exp2, exceeds it 20x or
    more."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(B, H, N, D, seed=B * N + D))
    scale = 1.0 / math.sqrt(D)
    got = _emulate_kernel_schedule(q, k, v, scale).float()
    ref = reference_flash_attention(q, k, v, scale).float()
    diff = (got - ref).abs()
    assert float((diff / (2e-2 + 2e-2 * ref.abs())).max()) <= 1.0
    assert float(diff.max() / ref.abs().max()) < 2e-2
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    rounding = 2.0 ** -7 * (torch.matmul(p, v.float().abs()) + ref.abs())
    one_tile = _emulate_kernel_schedule(q, k, v, scale, keys=N).float()
    for emulated in (got, one_tile):
        assert bool(((emulated - ref).abs() <= rounding).all())


def test_site_route():
    # the VAE's mid-block sites of the shipped config: N = 32*32, C = 384, one head
    assert ops.site_route(1024, 384, 1, torch.bfloat16) == "flash"
    assert ops.site_route(1024, 384, 1, torch.float32) == "plain"
    # the 14 UNet sites stay on the packed kernel
    for N, C in [(1024, 256), (256, 384), (64, 512), (16, 512), (64, 384), (256, 256), (1024, 128)]:
        assert ops.site_route(N, C, 8, torch.bfloat16) == "kernel"
        assert ops.site_route(N, C, 8, torch.float32) == "plain"
    assert ops.site_route(1000, 384, 1, torch.bfloat16) == "plain"  # N not a multiple of 64
    assert ops.site_route(1024, 320, 1, torch.bfloat16) == "plain"  # d outside the kernel's set


def _tiny_vae(dtype, param_dtype=None):
    """Both VAE attention sites at C = 128, one head, N = 8*8: the flash
    route in bf16."""
    arch = VAEArch(channels=(16, 128), enc_num_res_blocks=1, dec_num_res_blocks=1,
                   init_resolution=16, num_groups=8)
    g = torch.Generator().manual_seed(0)
    state = build_vae(arch, torch.float32, "cpu", g).state_dict()
    model = build_vae(arch, dtype, "cpu", param_dtype=param_dtype)
    model.load_state_dict(state)
    x = torch.randn(2, 16, 16, 3, generator=g)
    noise = torch.randn(2, 8, 8, 3, generator=g)
    return model, x, noise


def test_vae_sites_take_the_flash_route_in_bf16():
    """A bf16 VAE forward logs both sites as "flash" and agrees with the
    fp32 forward (plain route) to bf16 accuracy: relative L2 < 5e-2."""
    model, x, noise = _tiny_vae(torch.bfloat16)
    ref_model, _, _ = _tiny_vae(torch.float32)
    with torch.no_grad(), ops.record_sites() as sites:
        out, _, _ = model(x, sample=True, noise=noise)
    with torch.no_grad(), ops.record_sites() as ref_sites:
        ref, _, _ = ref_model(x, sample=True, noise=noise)
    assert [s[-1] for s in sites] == ["flash", "flash"] and [s[1:4] for s in sites] == [(64, 128, 1)] * 2
    assert [s[-1] for s in ref_sites] == ["plain", "plain"]
    assert float((out.float() - ref).norm() / ref.norm()) < 5e-2


def test_vae_attention_gradients_flow_through_flash_attention():
    """bf16 compute on fp32 parameters: the q/k/v projections of both sites
    get gradients through `FlashAttention`, close to those of the plain
    route on the same parameters (relative L2 < 0.1: the forwards round at
    other points)."""
    grads = []
    for route in ("flash", "plain"):
        model, x, noise = _tiny_vae(torch.bfloat16, param_dtype=torch.float32)
        if route == "plain":
            for m in model.modules():
                if hasattr(m, "to_q"):
                    m.forward = _plain_attention(m)
        out, prior, _ = model(x, sample=True, noise=noise)
        (out.float().square().mean() + prior).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if any(f".{w}.weight" in n for w in ("to_q", "to_k", "to_v"))})
    flash, plain = grads
    assert len(flash) == 6
    for n in flash:
        assert flash[n].abs().sum() > 0
        assert float((flash[n] - plain[n]).norm() / plain[n].norm()) < 0.1, n


def _plain_attention(m):
    def forward(x):
        B, C, H, W = x.shape
        tokens = m.groupnorm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        attn = ops.reference_attention(m.to_q(tokens), m.to_k(tokens), m.to_v(tokens), m.num_heads)
        return m.out_proj(attn).reshape(B, H, W, C).permute(0, 3, 1, 2) + x
    return forward
