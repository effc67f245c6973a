"""The port's packed-attention backward: its plain version, and the plain
statement of the kernels' arithmetic from the forward's saved output and
row sums, against the JAX packed kernel's VJP (the Pallas backward kernel in
interpret mode), and the autograd pairing of the operators
`packed_attention_fwd` and `packed_attention_bwd_op` on the CPU.  The CUDA kernel itself is
held against its plain version in tests/test_torch_port_cuda.py."""

import math

import jax
import numpy as np
import pytest
import torch

from image_diffusion_tpu.ops.pallas.attention import _packed_forward
from image_diffusion_torch.ops.attention import (
    LOG2E,
    merge_heads,
    packed_attention,
    packed_attention_bwd,
    packed_attention_fwd,
    reference_packed_attention,
    reference_packed_attention_bwd,
    reference_packed_attention_bwd_from_stats,
    split_heads,
)


def _arrays(B, N, C, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(n)]


# the shapes of tests/test_pallas.py's backward test: N=96 does not divide
# the TPU kernel's 256-row Q block, C=384 is a d=48 site
CASES = [(256, 8, 128), (64, 4, 64), (256, 8, 256), (64, 8, 384), (96, 4, 64)]


@pytest.mark.parametrize("n,heads,c", CASES)
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


def _from_stats(q, k, v, w, heads, dtype):
    """(dq, dk, dv) from the forward's saved output and row sums, with the
    operands in `dtype` as the card holds them (bf16) or in fp32."""
    q, k, v, w = (torch.from_numpy(t).to(dtype) for t in (q, k, v, w))
    out, row_sum = reference_packed_attention(q, k, v, heads, return_row_sum=True)
    return reference_packed_attention_bwd_from_stats(q, k, v, out, w, row_sum, heads), (q, k, v, w)


@pytest.mark.parametrize("n,heads,c", CASES)
def test_backward_from_saved_statistics_matches_plain_backward(n, heads, c):
    """bf16 operands and a bf16 saved output, as on the card.  P is the same
    (the row sums are the plain backward's own, summed once), so dv is equal
    bit for bit.  delta = rowsum(dO * O) differs from rowsum(dP * P): O is
    the product of the bf16-rounded weights with V, rounded to bf16 again,
    while rowsum(dP * P) uses the fp32 P (the difference is P's rounding
    inside O, not O's own:
    `test_delta_gap_comes_from_the_rounded_weights_not_from_the_rounded_output`).
    A row's delta error shifts that row's dS, which flips bf16 roundings of
    dS, dq and dk: one bf16 ulp of an element is 3.9e-3 of it.  Over these
    cases the two backwards differ by 1.8e-3 to 2.3e-3 in relative L2 (held
    to 5e-3) and by 3.1e-3 to 7.8e-3 of the largest element (held to 1e-2,
    half the 2e-2 bar the card's kernels are held to against the plain
    backward)."""
    q, k, v, w = _arrays(2, n, c, 4, seed=n + c)
    got, bf = _from_stats(q, k, v, w, heads, torch.bfloat16)
    ref = reference_packed_attention_bwd(*bf, heads)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        a, b = a.float(), b.float()
        assert float((a - b).norm() / b.norm()) < 5e-3, name
        assert float((a - b).abs().max() / b.abs().max()) < 1e-2, name
    torch.testing.assert_close(got[2], ref[2], atol=0, rtol=0)  # dv takes no delta


@pytest.mark.parametrize("n,heads,c", CASES)
def test_delta_gap_comes_from_the_rounded_weights_not_from_the_rounded_output(n, heads, c):
    """Why the forward does not also save an fp32 output for delta.  The same
    bf16 q, k, v, dO and row sums, and three outputs O to take delta from:
    the saved bf16 one; the same product bf16(w) . v / l left in fp32, which
    is the most the forward kernel could save; and fp32 P . v with the
    weights not rounded, which the tensor cores' bf16 product cannot give.
    Against the plain backward the first two differ alike (a rounding flip
    of the largest element is 3.9e-3 to 7.8e-3 of it, so no bar under one
    bf16 ulp can hold), the third by under 1e-3: the gap is the weights'
    rounding inside the product."""
    q, k, v, w = (torch.from_numpy(t).to(torch.bfloat16) for t in _arrays(2, n, c, 4, seed=n + c))
    ref = reference_packed_attention_bwd(q, k, v, w, heads)
    saved, row_sum = reference_packed_attention(q, k, v, heads, return_row_sum=True)
    unrounded, _ = reference_packed_attention(q.float(), k.float(), v.float(), heads,
                                              return_row_sum=True)
    qs = (q.float() * (LOG2E / math.sqrt(c // heads))).to(torch.bfloat16)
    s = split_heads(qs, heads).float() @ split_heads(k, heads).float().transpose(-1, -2)
    exact = merge_heads(torch.exp2(s.clamp(-100.0, 100.0)) / row_sum.unsqueeze(-1)
                        @ split_heads(v, heads).float())
    assert saved.dtype == torch.bfloat16 and unrounded.dtype == exact.dtype == torch.float32

    def gap(out):
        got = reference_packed_attention_bwd_from_stats(q, k, v, out, w, row_sum, heads)
        return max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                   for a, b in zip(got[:2], ref[:2]))  # dq, dk; dv takes no delta

    assert 3e-3 < gap(saved) < 1e-2
    assert 3e-3 < gap(unrounded) < 1e-2
    assert gap(exact) < 1e-3


@pytest.mark.parametrize("n,heads,c", CASES)
def test_backward_from_saved_statistics_matches_jax_kernel_vjp(n, heads, c):
    """The same inputs through the JAX packed kernel's VJP (interpret mode)
    and the port's backward from saved statistics, at the tolerance of
    `test_plain_backward_matches_jax_kernel_vjp`: the two differ in where q
    is scaled and, now, in delta's operands, both inside the bf16 bar."""
    q, k, v, w = _arrays(2, n, c, 4, seed=n + c)
    scale = 1.0 / math.sqrt(c // heads)
    grad = jax.jit(jax.grad(lambda q, k, v: (_packed_forward(q, k, v, heads, scale, True) * w).sum(),
                            (0, 1, 2)))
    ref = [np.asarray(g) for g in grad(q, k, v)]
    got, _ = _from_stats(q, k, v, w, heads, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() < 2e-2, name


def test_backward_takes_both_saved_statistics_or_neither():
    q, k, v, do = (torch.from_numpy(t) for t in _arrays(1, 16, 32, 4, seed=3))
    out, row_sum = reference_packed_attention(q, k, v, 2, return_row_sum=True)
    with pytest.raises(ValueError, match="both out and row_sum"):
        packed_attention_bwd(q, k, v, do, 2, out=out)
    got = packed_attention_bwd(q, k, v, do, 2, out, row_sum)
    ref = reference_packed_attention_bwd_from_stats(q, k, v, out, do, row_sum, 2)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("B,N,C,heads", [(2, 64, 64, 4), (1, 48, 96, 2), (2, 16, 128, 2)])
def test_autograd_function_matches_autograd_of_plain_forward(B, N, C, heads):
    """fp32 inputs on the CPU: the forward operator's gradients (the plain backward)
    against autograd through the plain forward, cosine > 0.999 per operand
    (the bf16 roundings inside give ~1e-2 relative noise elementwise)."""
    q, k, v, w = (torch.from_numpy(t) for t in _arrays(B, N, C, 4, seed=B * N + C))
    grads = []
    for fn in (lambda *a: packed_attention_fwd(*a, heads)[0],
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
    # the gradient of the forward operator, whose backward is packed_attention_bwd_op
    assert "packed_attention_fwd" in type(out.grad_fn).__name__
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
