"""The port's packed-attention kernel module: its plain version against the
JAX packed kernel in interpret mode, the einsum path, the site route and
the wrapper's refusals.  The CUDA kernel itself is held against its plain
version in tests/test_torch_port_cuda.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.ops.pallas.attention import _packed_forward
from image_diffusion_torch import ops
from image_diffusion_torch.ops.attention import (
    packed_attention,
    reference_attention,
    reference_packed_attention,
)


def _qkv(B, N, C, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, N, C)) * scale).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("d", [16, 32, 48, 64])
def test_plain_version_matches_jax_packed_kernel(n, d):
    heads = 2
    q, k, v = _qkv(2, n, heads * d, seed=n + d)
    scale = 1.0 / math.sqrt(d)
    ref = np.asarray(jax.jit(lambda q, k, v: _packed_forward(q, k, v, heads, scale, True))(q, k, v))
    got = reference_packed_attention(*(torch.from_numpy(t) for t in (q, k, v)), heads)
    assert got.dtype == torch.float32
    # both use bf16 operands with fp32 accumulation (tests/test_pallas.py bar)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-2, rtol=3e-2)


def test_plain_version_extreme_logits_stay_finite():
    q, k, v = _qkv(2, 64, 128, seed=3)
    out = reference_packed_attention(torch.from_numpy(q * 1e3), torch.from_numpy(k * 1e3),
                                     torch.from_numpy(v), 8)
    assert torch.isfinite(out).all()


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(3, 32, 64, seed=4))
    before = packed_attention.launches
    out = packed_attention(q, k, v, 2)
    assert packed_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, reference_packed_attention(q, k, v, 2), atol=0, rtol=0)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_wrapper_raises_off_the_cpu_instead_of_falling_back():
    q = torch.empty(2, 16, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        packed_attention(q, q, q, 2)


def test_einsum_path_matches_jax_xla_route():
    """The plain einsum path (fp32 verification mode) against
    the JAX layer's XLA formula, fp32 at 2e-5."""
    q, k, v = _qkv(2, 64, 96, seed=5)
    heads, d = 3, 32

    def jax_path(q, k, v):
        split = lambda t: t.reshape(2, 64, heads, d).transpose(0, 2, 1, 3)  # noqa: E731
        s = jnp.einsum("bhnd,bhmd->bhnm", split(q), split(k), precision="highest") / math.sqrt(d)
        w = jax.nn.softmax(s, axis=-1)
        o = jnp.einsum("bhnm,bhmd->bhnd", w, split(v), precision="highest")
        return o.transpose(0, 2, 1, 3).reshape(2, 64, heads * d)

    ref = np.asarray(jax.jit(jax_path)(q, k, v))
    got = reference_attention(*(torch.from_numpy(t) for t in (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("N,C,heads,dtype,route", [
    (1024, 256, 8, torch.bfloat16, "kernel"),
    (1024, 128, 8, torch.bfloat16, "kernel"),
    (256, 384, 8, torch.bfloat16, "kernel"),
    (16, 512, 8, torch.bfloat16, "kernel"),
    (1024, 384, 1, torch.bfloat16, "flash"),   # VAE mid-block, d=384
    (1024, 256, 8, torch.float32, "plain"),    # verification mode
    (24, 128, 8, torch.bfloat16, "plain"),     # N not a multiple of 16
    (64, 40, 2, torch.bfloat16, "plain"),      # d=20
])
def test_site_route(N, C, heads, dtype, route):
    assert ops.site_route(N, C, heads, dtype) == route


def test_record_sites_logs_only_inside_the_block():
    ops.log_site(1, 16, 64, 2, "kernel")
    with ops.record_sites() as log:
        ops.log_site(2, 64, 128, 8, "kernel")
    ops.log_site(3, 16, 64, 2, "plain")
    assert log == [(2, 64, 128, 8, "kernel")]
