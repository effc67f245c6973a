"""The port's packed-attention backward: its plain version against the JAX
packed kernel's VJP (the Pallas backward kernel in interpret mode), and the
autograd pairing `PackedAttention` on the CPU.  The CUDA kernel itself is
held against its plain version in tests/test_torch_port_cuda.py."""

import math

import jax
import numpy as np
import pytest
import torch

from image_diffusion_tpu.ops.pallas.attention import _packed_forward
from image_diffusion_torch.ops.attention import (
    PackedAttention,
    packed_attention,
    packed_attention_bwd,
    reference_packed_attention,
    reference_packed_attention_bwd,
)


def _arrays(B, N, C, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(n)]


# the shapes of tests/test_pallas.py's backward test: N=96 does not divide
# the TPU kernel's 256-row Q block, C=384 is a d=48 site
@pytest.mark.parametrize("n,heads,c", [(256, 8, 128), (64, 4, 64), (256, 8, 256),
                                        (64, 8, 384), (96, 4, 64)])
def test_plain_backward_matches_jax_kernel_vjp(n, heads, c):
    q, k, v, w = _arrays(2, n, c, 4, seed=n + c)
    scale = 1.0 / math.sqrt(c // heads)
    grad = jax.jit(jax.grad(lambda q, k, v: (_packed_forward(q, k, v, heads, scale, True) * w).sum(),
                            (0, 1, 2)))
    ref = [np.asarray(g) for g in grad(q, k, v)]
    got = reference_packed_attention_bwd(*(torch.from_numpy(t) for t in (q, k, v, w)), heads)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        # both run bf16 operands with fp32 sums; JAX scales the scores after
        # the product, the port rounds q*scale*log2(e) to bf16 first (the
        # tests/test_pallas.py bar)
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() < 2e-2, name


@pytest.mark.parametrize("B,N,C,heads", [(2, 64, 64, 4), (1, 48, 96, 2), (2, 16, 128, 2)])
def test_autograd_function_matches_autograd_of_plain_forward(B, N, C, heads):
    """fp32 inputs on the CPU: the Function's gradients (the plain backward)
    against autograd through the plain forward, cosine > 0.999 per operand
    (the bf16 roundings inside give ~1e-2 relative noise elementwise)."""
    q, k, v, w = (torch.from_numpy(t) for t in _arrays(B, N, C, 4, seed=B * N + C))
    grads = []
    for fn in (lambda *a: PackedAttention.apply(*a, heads),
               lambda *a: reference_packed_attention(*a, heads)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        cos = float(torch.dot(a.flatten(), b.flatten()) / (a.norm() * b.norm()))
        assert cos > 0.999, (name, cos)


def test_packed_attention_with_grad_is_the_function_and_without_grad_is_not():
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16).requires_grad_()
               for t in _arrays(2, 32, 64, 3, seed=1))
    launches = packed_attention.launches, packed_attention_bwd.launches
    out = packed_attention(q, k, v, 2)
    assert type(out.grad_fn).__name__ == "PackedAttentionBackward"
    out.float().sum().backward()
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16 for t in (q, k, v))
    with torch.no_grad():
        assert packed_attention(q, k, v, 2).grad_fn is None
    # the CPU takes the plain versions: no kernel launches counted
    assert (packed_attention.launches, packed_attention_bwd.launches) == launches


def test_plain_backward_dtypes_follow_the_inputs():
    q, k, v, do = (torch.from_numpy(t) for t in _arrays(1, 16, 32, 4, seed=2))
    dq, dk, dv = packed_attention_bwd(q, k.to(torch.bfloat16), v, do, 2)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float32, torch.bfloat16, torch.float32)
    ref = reference_packed_attention_bwd(q, k.to(torch.bfloat16), v, do, 2)
    for a, b in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
