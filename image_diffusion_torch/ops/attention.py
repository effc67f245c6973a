"""Self-attention on the packed (B, N, C) layout: the Hopper forward and
backward kernels paired in an autograd Function, their plain PyTorch
versions, and the plain einsum path for the other sites.

Heads sit in contiguous channel bands: head h owns channels
[h*d, (h+1)*d) with d = C / num_heads (the reference "(h d)" split).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .build import load_library

LOG2E = 1.4426950408889634
HEAD_DIMS = (16, 32, 48, 64)


def _split(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C = t.shape
    return t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    B, h, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, h * d)


def reference_packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """Plain PyTorch statement of the kernel's math (bf16 operands, fp32
    scores and sums, clamped-exp2 softmax), output in q's dtype.  Products
    of bf16 values are exact in fp32, so fp32 matmuls of the bf16-rounded
    operands give the bf16-operand / fp32-accumulation products."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    bf = torch.bfloat16
    qs = (q.float() * (scale * LOG2E)).to(bf)
    s = torch.matmul(_split(qs, num_heads).float(),
                     _split(k.to(bf), num_heads).float().transpose(-1, -2))
    w = torch.exp2(torch.clamp(s, -100.0, 100.0))
    p = (w / w.sum(dim=-1, keepdim=True)).to(bf)
    out = torch.matmul(p.float(), _split(v.to(bf), num_heads).float())
    return _merge(out).to(q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Plain einsum path: fp32 scores, max-shifted softmax, weights cast to
    the compute dtype (q's) before the AV product."""
    d = q.shape[-1] // num_heads
    qh, kh, vh = (_split(t, num_heads) for t in (q, k, v))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(d)
    weights = F.softmax(scores, dim=-1).to(q.dtype)
    return _merge(torch.matmul(weights, vh))


def reference_packed_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   do: torch.Tensor, num_heads: int):
    """Plain PyTorch statement of the backward kernel's math -> (dq, dk, dv).

    bf16 operands; P recomputed from the forward's clamped-exp2 scores (q
    pre-scaled by scale*log2(e) and rounded to bf16) and normalized in fp32;
    dV = bf16(P)^T dO_h and dP = dO_h V_h^T in fp32; delta = rowsum(dP * P);
    dS = bf16(P * (dP - delta) * scale) with the natural-domain scale;
    dQ = dS K_h and dK = dS^T Q_h in fp32.  dq comes back in q's dtype, dk
    and dv cast from their fp32 sums to k's and v's.  The clamp's zero
    derivative is ignored, as in the TPU kernel."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    bf = torch.bfloat16
    qs = (q.float() * (scale * LOG2E)).to(bf)
    qh, kh, vh, doh = (_split(t.to(bf), num_heads).float() for t in (q, k, v, do))
    s = torch.matmul(_split(qs, num_heads).float(), kh.transpose(-1, -2))
    w = torch.exp2(torch.clamp(s, -100.0, 100.0))
    p = w / w.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(bf).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(bf).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return _merge(dq).to(q.dtype), _merge(dk).to(k.dtype), _merge(dv).to(v.dtype)


def _bind_forward(lib: ctypes.CDLL):
    fn = lib.packed_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bind_backward(lib: ctypes.CDLL):
    fn = lib.packed_attention_backward
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(op: str, tensors: dict[str, torch.Tensor], num_heads: int) -> None:
    q = tensors["q"]
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{op}: {name} on {t.device}, expected q's CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{op}: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.dim() != 3 or t.shape != q.shape:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, expected (B, N, C) = {tuple(q.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be contiguous and 16-byte aligned")
    B, N, C = q.shape
    if num_heads <= 0 or C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"{op}: head dim C/heads = {C}/{num_heads} not in {HEAD_DIMS}")
    if N <= 0 or N % 16:
        raise ValueError(f"{op}: N = {N} must be a positive multiple of 16")
    if not 0 < B <= 65535:
        raise ValueError(f"{op}: batch {B} outside 1..65535")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _packed_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """The forward: plain version on CPU tensors, else the kernel of
    `csrc/packed_attention.cu` (built at first use) or an error.  Each
    launch adds one to `packed_attention.launches`."""
    if _on_cpu(q, k, v):
        return reference_packed_attention(q, k, v, num_heads)
    _check_kernel_inputs("packed_attention", {"q": q, "k": k, "v": v}, num_heads)
    B, N, C = q.shape
    fn = _bind_forward(load_library("packed_attention"))
    out = torch.empty_like(q)
    qscale = (1.0 / math.sqrt(C // num_heads)) * LOG2E
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, N, C, num_heads, qscale, stream)
    if err != 0:
        raise RuntimeError(f"packed_attention kernel launch failed: cudaError {err}")
    packed_attention.launches += 1
    return out


def packed_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, num_heads: int):
    """Backward of packed self-attention -> (dq, dk, dv), each (B, N, C).

    CPU tensors take the plain version; CUDA tensors launch the kernels of
    `csrc/packed_attention_bwd.cu` (built at first use) or raise.  Each
    launch adds one to `packed_attention_bwd.launches`."""
    if _on_cpu(q, k, v, do):
        return reference_packed_attention_bwd(q, k, v, do, num_heads)
    _check_kernel_inputs("packed_attention_bwd", {"q": q, "k": k, "v": v, "do": do}, num_heads)
    B, N, C = q.shape
    fn = _bind_backward(load_library("packed_attention_bwd"))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per-row 1/sum(w) and delta, written by the dq kernel, read by dk/dv's
    stats = torch.empty(2, B, num_heads, N, dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(C // num_heads)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                 B, N, C, num_heads, scale * LOG2E, scale, stream)
    if err != 0:
        raise RuntimeError(f"packed_attention_bwd kernel launch failed: cudaError {err}")
    packed_attention_bwd.launches += 1
    return dq, dk, dv


packed_attention_bwd.launches = 0


class PackedAttention(torch.autograd.Function):
    """Packed self-attention with the kernel pair: the forward kernel (or
    its plain version on the CPU) and, as its gradient, the backward kernel
    (or its plain version).  q, k and v are saved for the backward, which
    recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        return _packed_forward(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = packed_attention_bwd(q, k, v, do.contiguous(), ctx.num_heads)
        return dq, dk, dv, None


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Packed self-attention (B, N, C) -> (B, N, C).

    With grad enabled it runs as `PackedAttention`, so its gradient comes
    from the backward kernel; under `no_grad`/`inference_mode` the forward
    runs alone.  CPU tensors take the plain versions; CUDA tensors launch
    the kernels or raise.  Each forward launch adds one to
    `packed_attention.launches`."""
    if torch.is_grad_enabled():
        return PackedAttention.apply(q, k, v, num_heads)
    return _packed_forward(q, k, v, num_heads)


packed_attention.launches = 0
