"""Self-attention kernels and their plain PyTorch versions.

  * The packed (B, N, C) layout: the Hopper forward and backward kernels,
    paired as the dispatcher operators `packed_attention_fwd` (output and
    row sums) and `packed_attention_bwd_op` (its gradient).  Heads sit in
    contiguous channel bands:
    head h owns channels [h*d, (h+1)*d) with d = C / num_heads (the
    reference "(h d)" split).
  * The head-major (B, H, N, D) layout: the blockwise (flash) forward
    kernel for wide heads, in `FlashAttention` with the einsum path's
    autograd as its gradient.
  * The plain einsum path for the other sites.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .build import load_library

LOG2E = 1.4426950408889634
HEAD_DIMS = (16, 32, 48, 64)
# head dims and Q/key tile of the flash kernel (`csrc/flash_attention.cu`)
FLASH_HEAD_DIMS = (128, 256, 384)
FLASH_TILE = 64


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, heads, N, d), a view."""
    B, N, C = t.shape
    return t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, heads, N, d) -> (B, N, heads * d)."""
    B, h, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, h * d)


def reference_packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int, return_row_sum: bool = False):
    """Plain PyTorch statement of the kernel's math (bf16 operands, fp32
    scores and sums, clamped-exp2 softmax), output in q's dtype.  Products
    of bf16 values are exact in fp32, so fp32 matmuls of the bf16-rounded
    operands give the bf16-operand / fp32-accumulation products.  With
    `return_row_sum` also each row's fp32 sum of weights, (B, heads, N):
    what the forward kernel hands to the backward."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    bf = torch.bfloat16
    qs = (q.float() * (scale * LOG2E)).to(bf)
    s = torch.matmul(split_heads(qs, num_heads).float(),
                     split_heads(k.to(bf), num_heads).float().transpose(-1, -2))
    w = torch.exp2(torch.clamp(s, -100.0, 100.0))
    row_sum = w.sum(dim=-1, keepdim=True)
    p = (w / row_sum).to(bf)
    out = torch.matmul(p.float(), split_heads(v.to(bf), num_heads).float())
    out = merge_heads(out).to(q.dtype)
    return (out, row_sum.squeeze(-1)) if return_row_sum else out


def reference_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """The einsum path on the head-major (B, H, N, D) layout: fp32 scores
    times `scale`, max-shifted softmax, weights cast to v's dtype before
    the AV product.  Its autograd is the flash kernel's gradient, as the
    JAX package differentiates its `reference_attention` there."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = F.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Plain einsum path on the packed (B, N, C) layout: fp32 scores times
    1/sqrt(d), max-shifted softmax, weights cast to the compute dtype
    before the AV product."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    heads = (split_heads(t, num_heads) for t in (q, k, v))
    return merge_heads(reference_attention_heads(*heads, scale))


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
    qh, kh, vh, doh = (split_heads(t.to(bf), num_heads).float() for t in (q, k, v, do))
    s = torch.matmul(split_heads(qs, num_heads).float(), kh.transpose(-1, -2))
    w = torch.exp2(torch.clamp(s, -100.0, 100.0))
    p = w / w.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(bf).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(bf).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return merge_heads(dq).to(q.dtype), merge_heads(dk).to(k.dtype), merge_heads(dv).to(v.dtype)


def reference_packed_attention_bwd_from_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                              out: torch.Tensor, do: torch.Tensor,
                                              row_sum: torch.Tensor, num_heads: int):
    """Plain PyTorch statement of the backward kernels' arithmetic ->
    (dq, dk, dv): as `reference_packed_attention_bwd`, but with what the
    forward saved.  P = w / row_sum from the forward's fp32 row sums (B,
    heads, N) instead of a sum of its own, and delta = rowsum(dO_h * O_h)
    from the forward's output instead of rowsum(dP * P): the two deltas are
    equal up to P's rounding to bf16 inside O's product and O's own
    rounding to its dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    bf = torch.bfloat16
    qs = (q.float() * (scale * LOG2E)).to(bf)
    qh, kh, vh, doh = (split_heads(t.to(bf), num_heads).float() for t in (q, k, v, do))
    oh = split_heads(out, num_heads).float()  # as saved: bf16 on the card
    s = torch.matmul(split_heads(qs, num_heads).float(), kh.transpose(-1, -2))
    p = torch.exp2(torch.clamp(s, -100.0, 100.0)) / row_sum.float().unsqueeze(-1)
    dv = torch.matmul(p.to(bf).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(bf).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return merge_heads(dq).to(q.dtype), merge_heads(dk).to(k.dtype), merge_heads(dv).to(v.dtype)


def _bind_forward(lib: ctypes.CDLL):
    fn = lib.packed_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bind_backward(lib: ctypes.CDLL):
    fn = lib.packed_attention_backward
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_tensors(op: str, tensors: dict[str, torch.Tensor], layout: str) -> None:
    """Every tensor bf16, contiguous, 16-byte aligned, on q's CUDA device,
    with q's shape, whose dims `layout` names (e.g. "(B, N, C)")."""
    q = tensors["q"]
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{op}: {name} on {t.device}, expected q's CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{op}: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.dim() != layout.count(",") + 1 or t.shape != q.shape:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, expected {layout} = {tuple(q.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be contiguous and 16-byte aligned")


def _check_kernel_inputs(op: str, tensors: dict[str, torch.Tensor], num_heads: int) -> None:
    _check_tensors(op, tensors, "(B, N, C)")
    B, N, C = tensors["q"].shape
    if num_heads <= 0 or C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"{op}: head dim C/heads = {C}/{num_heads} not in {HEAD_DIMS}")
    if N <= 0 or N % 16:
        raise ValueError(f"{op}: N = {N} must be a positive multiple of 16")
    if not 0 < B <= 65535:
        raise ValueError(f"{op}: batch {B} outside 1..65535")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_row_sum(op: str, row_sum: torch.Tensor, q: torch.Tensor, num_heads: int) -> None:
    B, N, _ = q.shape
    if (row_sum.device != q.device or row_sum.dtype != torch.float32
            or row_sum.shape != (B, num_heads, N) or not row_sum.is_contiguous()
            or row_sum.data_ptr() % 16):
        raise ValueError(f"{op}: row_sum must be a contiguous, 16-byte aligned float32 "
                         f"(B, heads, N) = {(B, num_heads, N)} tensor on q's device, got "
                         f"{row_sum.dtype} {tuple(row_sum.shape)} on {row_sum.device}")


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    with_row_sum: bool):
    """Launch the kernel of `csrc/packed_attention.cu` (built at first use)
    on checked CUDA tensors -> (out, row_sum or None).  Without
    `with_row_sum` the kernel gets a null pointer and writes no sums.  Adds
    one to `packed_attention.launches`."""
    B, N, C = q.shape
    fn = _bind_forward(load_library("packed_attention"))
    out = torch.empty_like(q)
    row_sum = (torch.empty(B, num_heads, N, dtype=torch.float32, device=q.device)
               if with_row_sum else None)
    qscale = (1.0 / math.sqrt(C // num_heads)) * LOG2E
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 row_sum.data_ptr() if with_row_sum else None,
                 B, N, C, num_heads, qscale, stream)
    if err != 0:
        raise RuntimeError(f"packed_attention kernel launch failed: cudaError {err}")
    packed_attention.launches += 1
    return out, row_sum


def _packed_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    return_row_sum: bool = False):
    """The forward -> out, or (out, row_sum) with `return_row_sum`: plain
    version on CPU tensors, else the kernel or an error."""
    if _on_cpu(q, k, v):
        return reference_packed_attention(q, k, v, num_heads, return_row_sum)
    _check_kernel_inputs("packed_attention", {"q": q, "k": k, "v": v}, num_heads)
    out, row_sum = _launch_forward(q, k, v, num_heads, return_row_sum)
    return (out, row_sum) if return_row_sum else out


def packed_attention_with_row_sum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  num_heads: int):
    """The forward alone -> (out (B, N, C), row_sum (B, heads, N) float32):
    what the forward operator saves for `packed_attention_bwd`.  No gradient
    flows through it."""
    return _packed_forward(q, k, v, num_heads, return_row_sum=True)


def packed_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         do: torch.Tensor, num_heads: int,
                         out: torch.Tensor | None = None, row_sum: torch.Tensor | None = None):
    """Backward of packed self-attention -> (dq, dk, dv), each (B, N, C).

    `out` and `row_sum` are the forward's output and fp32 row sums (B,
    heads, N) for the same q, k, v, as the forward operator saves them; given
    neither, they are computed first (on the card by a launch of the
    forward kernel, which adds one to `packed_attention.launches`).  CPU
    tensors take the plain versions; CUDA tensors launch the kernels of
    `csrc/packed_attention_bwd.cu` (built at first use) or raise.  Each call
    that launches them adds one to `packed_attention_bwd.launches`."""
    if (out is None) != (row_sum is None):
        raise ValueError("packed_attention_bwd: pass both out and row_sum, or neither")
    if _on_cpu(q, k, v, do):
        if out is None:
            return reference_packed_attention_bwd(q, k, v, do, num_heads)
        return reference_packed_attention_bwd_from_stats(q, k, v, out, do, row_sum, num_heads)
    tensors = {"q": q, "k": k, "v": v, "do": do}
    if out is not None:
        tensors["out"] = out
    _check_kernel_inputs("packed_attention_bwd", tensors, num_heads)
    if out is None:
        out, row_sum = _launch_forward(q, k, v, num_heads, with_row_sum=True)
    _check_row_sum("packed_attention_bwd", row_sum, q, num_heads)
    B, N, C = q.shape
    fn = _bind_backward(load_library("packed_attention_bwd"))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per-row delta, written by the dq kernel, read by dk/dv's
    delta = torch.empty(B, num_heads, N, dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(C // num_heads)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                 row_sum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), B, N, C, num_heads, scale * LOG2E, scale, stream)
    if err != 0:
        raise RuntimeError(f"packed_attention_bwd kernel launch failed: cudaError {err}")
    packed_attention_bwd.launches += 1
    return dq, dk, dv


packed_attention_bwd.launches = 0


# The packed pair as dispatcher operators.  A ctypes launch inside a Python
# function is invisible to the dispatcher; as operators, the forward's two
# outputs are what a selective-checkpoint policy (`models/unet.py`'s remat)
# can save, so a recomputed block never launches the forward kernel again.
# Each keeps the wrapper's checks, its raise and its CPU route inside.


@torch.library.custom_op("image_diffusion_torch::packed_attention_fwd", mutates_args=())
def packed_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward with its row sums -> (out, row_sum), as an operator whose
    gradient is `packed_attention_bwd_op`: the kernel (its plain version on
    CPU tensors) with the fp32 row sums (B, heads, N) the backward takes."""
    return _packed_forward(q, k, v, num_heads, return_row_sum=True)


@torch.library.custom_op("image_diffusion_torch::packed_attention_bwd", mutates_args=())
def packed_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, out: torch.Tensor, row_sum: torch.Tensor,
                            num_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `packed_attention_fwd` -> (dq, dk, dv).  On the card
    the backward kernels rebuild P in one pass from the forward's output and
    row sums; on the CPU the plain backward recomputes P and delta from q, k
    and v alone, as it always has (the saved statistics go unused there)."""
    if _on_cpu(q, k, v, do):
        return reference_packed_attention_bwd(q, k, v, do, num_heads)
    return packed_attention_bwd(q, k, v, do, num_heads, out, row_sum)


@packed_attention_fwd.register_fake
def _fwd_fake(q, k, v, num_heads):
    """Shapes only (the meta device); a device other than the CPU or a card
    raises, as the operator does."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed_attention: q on {q.device}, expected the CPU or a CUDA device")
    B, N, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, num_heads, N), dtype=torch.float32)


def _fwd_setup_context(ctx, inputs, output):
    q, k, v, num_heads = inputs
    ctx.num_heads = num_heads
    ctx.save_for_backward(q, k, v, *output)


def _fwd_backward(ctx, do, _d_row_sum):
    q, k, v, out, row_sum = ctx.saved_tensors
    dq, dk, dv = packed_attention_bwd_op(q, k, v, do.contiguous(), out, row_sum, ctx.num_heads)
    return dq, dk, dv, None


torch.library.register_autograd("image_diffusion_torch::packed_attention_fwd", _fwd_backward,
                                setup_context=_fwd_setup_context)


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Packed self-attention (B, N, C) -> (B, N, C).

    With grad enabled it runs as the operator `packed_attention_fwd`, so its
    gradient comes from the backward kernel; under `no_grad`/
    `inference_mode` the forward runs alone, without row sums.  CPU tensors
    take the plain versions; CUDA tensors launch the kernels or raise.  Each
    launch of the forward kernel, from here or from `packed_attention_bwd`
    called without the forward's statistics, adds one to
    `packed_attention.launches`."""
    if torch.is_grad_enabled():
        return packed_attention_fwd(q, k, v, num_heads)[0]
    return _packed_forward(q, k, v, num_heads)


packed_attention.launches = 0


# ---------------------------------------------------------------- flash


def reference_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Plain PyTorch statement of the flash kernel's math on (B, H, N, D):
    bf16 operands, fp32 scores s = scale * q k^T, the max-shifted natural
    exp w = exp(s - rowmax(s)) with an fp32 row sum, w rounded to bf16 for
    the product with bf16 v, fp32 accumulation, division by the row sum,
    output in q's dtype.  (The kernel shifts by the running max of the K/V
    tiles seen so far and rescales; the function is the same, the bf16
    rounding of w falls at another scale, within one ulp.)"""
    bf = torch.bfloat16
    s = torch.matmul(q.to(bf).float(), k.to(bf).float().transpose(-1, -2)) * scale
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(w.to(bf).float(), v.to(bf).float()) / w.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def _bind_flash(lib: ctypes.CDLL):
    fn = lib.flash_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_flash_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_tensors("flash_attention", {"q": q, "k": k, "v": v}, "(B, H, N, D)")
    B, H, N, D = q.shape
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {FLASH_HEAD_DIMS}")
    if N <= 0 or N % FLASH_TILE:
        raise ValueError(f"flash_attention: N = {N} must be a positive multiple of {FLASH_TILE}")
    if not 0 < B * H <= 65535:
        raise ValueError(f"flash_attention: batch x heads {B * H} outside 1..65535")


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The forward: plain version on CPU tensors, else the kernel of
    `csrc/flash_attention.cu` (built at first use) or an error.  Each
    launch adds one to `flash_attention.launches`."""
    if _on_cpu(q, k, v):
        return reference_flash_attention(q, k, v, scale)
    _check_flash_inputs(q, k, v)
    B, H, N, D = q.shape
    fn = _bind_flash(load_library("flash_attention"))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B * H, N, D, scale * LOG2E, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """Flash attention whose forward is the kernel (or its plain version on
    the CPU) and whose gradient is autograd of `reference_attention_heads`
    recomputed from the saved q, k and v: the JAX package's custom VJP,
    which has no backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention_heads(*inputs, ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, inputs, do)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Blockwise self-attention (B, H, N, D) -> (B, H, N, D).

    With grad enabled it runs as `FlashAttention`; under `no_grad`/
    `inference_mode` the forward runs alone.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.  Each launch adds one
    to `flash_attention.launches`."""
    if torch.is_grad_enabled():
        return FlashAttention.apply(q, k, v, scale)
    return _flash_forward(q, k, v, scale)


flash_attention.launches = 0
