"""Self-attention on the packed (B, N, C) layout: the Hopper kernel, its
plain PyTorch version, and the plain einsum path for the other sites.

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


def _bind(lib: ctypes.CDLL):
    fn = lib.packed_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, k, v, num_heads: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"packed_attention: {name} on {t.device}, expected q's CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"packed_attention: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.dim() != 3 or t.shape != q.shape:
            raise ValueError(f"packed_attention: {name} has shape {tuple(t.shape)}, expected (B, N, C) = {tuple(q.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"packed_attention: {name} must be contiguous and 16-byte aligned")
    B, N, C = q.shape
    if num_heads <= 0 or C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"packed_attention: head dim C/heads = {C}/{num_heads} not in {HEAD_DIMS}")
    if N <= 0 or N % 16:
        raise ValueError(f"packed_attention: N = {N} must be a positive multiple of 16")
    if not 0 < B <= 65535:
        raise ValueError(f"packed_attention: batch {B} outside 1..65535")


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Packed self-attention (B, N, C) -> (B, N, C).

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    `csrc/packed_attention.cu` (built at first use) or raise.  Each launch
    adds one to `packed_attention.launches`."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return reference_packed_attention(q, k, v, num_heads)
    _check_kernel_inputs(q, k, v, num_heads)
    B, N, C = q.shape
    fn = _bind(load_library("packed_attention"))
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


packed_attention.launches = 0
