"""GroupNorm, optionally fused with the SiLU after it: the plain formula and
the Hopper kernel pair.

  * `reference_group_norm`: the JAX package's formula in plain PyTorch
    (fp32 sums of x and x^2 per group, var = max(E[x^2] - E[x]^2, 0), eps
    1e-5 unless given, as the KL-f8 decoder's 1e-6; in bf16 the affine
    x * a + b runs in bf16 from fp32 a and b),
    then SiLU when asked.  `models/layers.py:GroupNorm` takes it on the CPU
    and in fp32 (verification) mode.
  * `group_norm`: the kernels of `csrc/group_norm.cu` on bf16 CUDA tensors
    in channels_last memory: the same statistics, then act(x * a + b) in
    fp32 registers, rounded to bf16 once.  With grad enabled it runs as the
    dispatcher operator `group_norm_fwd` (y and the fp32 mean and rstd per
    row and group), whose gradient is `group_norm_bwd_op`; so a selective
    checkpoint policy (`models/unet.py`) sees one operator and recomputes
    it.  Under `no_grad`/`inference_mode` the forward runs alone.  Anything
    the kernels do not take raises: there is no fallback inside.

The block tiles follow the shape (`tiling`), so every site of every model
runs the same two forward kernels and three backward kernels.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from .attention import _count_launch
from .build import load_library

EPS = 1e-5
VEC = 8                 # bf16 values in a thread's 16-byte access
BLOCK_THREADS = 256     # threads a block, rounded down to whole pixel lanes
TILE_ELEMENTS = 16384   # least elements a block's tile
MAX_TILES = 16          # most tiles a row
MAX_C = 2048            # at most 256 threads a pixel lane (the kernels' launch bound)


def reference_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, silu: bool = False, eps: float = EPS) -> torch.Tensor:
    """GroupNorm of NCHW `x` with fp32 statistics, output in x's dtype, then
    SiLU when `silu`: the JAX package's formula."""
    B, C, H, W = x.shape
    G = num_groups
    cg = C // G
    n = cg * H * W
    x32 = x.float()
    g1 = x32.sum(dim=(2, 3)).view(B, G, cg).sum(-1)
    g2 = (x32 * x32).sum(dim=(2, 3)).view(B, G, cg).sum(-1)
    mean = g1 / n
    # E[x^2]-E[x]^2 can go slightly negative by cancellation
    var = torch.clamp(g2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(cg, dim=1) * weight.float()
    b = bias.float() - mean.repeat_interleave(cg, dim=1) * a
    a, b = a[:, :, None, None], b[:, :, None, None]
    if x.dtype == torch.bfloat16:
        y = x * a.to(torch.bfloat16) + b.to(torch.bfloat16)
    else:
        y = (x32 * a + b).to(x.dtype)
    return F.silu(y) if silu else y


def reference_group_norm_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                             num_groups: int, silu: bool):
    """Plain PyTorch statement of the backward kernels' arithmetic -> (dx in
    x's dtype, dweight, dbias in fp32), from the forward's fp32 mean and
    rstd (B, G): z = x * a + b recomputed (a = w * rstd, b = bias - mean *
    a), dz = dy * act'(z), xhat = (x - mean) * rstd; per channel and row the
    sums of dz and dz * xhat; dweight and dbias their sums over rows;
    c1, c2 the group means of w * dz and w * dz * xhat; dx = rstd * (w * dz
    - c1 - xhat * c2)."""
    B, C, H, W = x.shape
    cg = C // num_groups
    n = cg * H * W
    per_channel = lambda t: t.repeat_interleave(cg, dim=1)[:, :, None, None]  # noqa: E731
    m, r = per_channel(mean.float()), per_channel(rstd.float())
    w = weight.float()[None, :, None, None]
    x32, dy32 = x.float(), dy.float()
    a = w * r
    z = x32 * a + (bias.float()[None, :, None, None] - m * a)
    if silu:
        s = torch.sigmoid(z)
        dz = dy32 * s * (1.0 + z * (1.0 - s))
    else:
        dz = dy32
    xhat = (x32 - m) * r
    sdz, sdzx = dz.sum(dim=(2, 3)), (dz * xhat).sum(dim=(2, 3))  # (B, C)
    wv = weight.float()[None, :]
    c1 = per_channel((wv * sdz).view(B, num_groups, cg).sum(-1) / n)
    c2 = per_channel((wv * sdzx).view(B, num_groups, cg).sum(-1) / n)
    dx = r * (w * dz - c1 - xhat * c2)
    return dx.to(x.dtype), sdzx.sum(0), sdz.sum(0)


@lru_cache(maxsize=1024)
def tiling(HW: int, C: int) -> tuple[int, int, int]:
    """(threads, P, T) of the kernels' blocks for rows of HW pixels and C
    channels: a block takes P pixels of one row, all C channels, T =
    ceil(HW / P) tiles a row.  A block is C / 8 threads a pixel lane times
    as many lanes as fit BLOCK_THREADS; its tile holds at least
    TILE_ELEMENTS elements, and a row at most MAX_TILES tiles, of
    whole lanes of pixels as even as those allow.  The row
    count plays no part, so a row's outputs are the same bits whatever
    batch it comes in."""
    V = C // VEC
    lanes = max(1, BLOCK_THREADS // V)
    per_tile = max(TILE_ELEMENTS, -(-HW * C // MAX_TILES))
    P = min(HW, lanes * -(-per_tile // (C * lanes)))
    T = -(-HW // P)
    P = min(HW, lanes * -(-HW // (T * lanes)))  # the same tile count, evened out
    return lanes * V, P, -(-HW // P)


_ARGTYPES = {
    # x, y, mean, rstd, weight, bias, part; B, HW, C, G, P, T, threads; eps; silu; stream
    "group_norm_forward": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    # x, dy, mean, rstd, weight, bias, dx, dweight, dbias, part_c, part_g; B, HW, C, G,
    # P, T, threads, silu; stream
    "group_norm_backward": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}
_ENTRIES: dict = {}


def _entry(name: str):
    """The C entry point `name` of `csrc/group_norm.cu`, built, loaded and
    bound at first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(load_library("group_norm"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _on_device(device: torch.device, launch) -> int:
    """`launch(stream)` with `device` current and its current stream's
    handle; the device is switched only when another is current (a norm is
    a short call, and the switch and the stream object cost more host time
    than the raw handle)."""
    if device.index == torch.cuda.current_device():
        return launch(torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return launch(torch._C._cuda_getCurrentRawStream(device.index))


def _check(op: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           num_groups: int, **more: torch.Tensor) -> None:
    """x (and each of `more` with x's shape) bf16, channels_last-contiguous,
    16-byte aligned, on a CUDA device; weight and bias fp32 (C,) there; C a
    multiple of 8 and of the group count, at most MAX_C."""
    if x.device.type != "cuda":
        raise ValueError(f"{op}: x on {x.device}, the kernel takes a CUDA tensor")
    if x.dim() != 4:
        raise ValueError(f"{op}: x has shape {tuple(x.shape)}, expected (B, C, H, W)")
    B, C, H, W = x.shape
    for name, t in {"x": x, **more}.items():
        if t.device != x.device:
            raise ValueError(f"{op}: {name} on {t.device}, expected x's device {x.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{op}: {name} is {t.dtype}, the kernel takes bfloat16")
        if t.shape != x.shape:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, expected x's {tuple(x.shape)}")
        if not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be channels_last-contiguous and 16-byte aligned")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous float32 ({C},) tensor on x's "
                             f"device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if num_groups <= 0 or C % num_groups or C % VEC or C > MAX_C:
        raise ValueError(f"{op}: C = {C} must be a multiple of {VEC} and of the group count "
                         f"{num_groups}, at most {MAX_C}")
    if not 0 < B <= 65535 or H * W <= 0 or (C // num_groups) * H * W > 1 << 24:
        raise ValueError(f"{op}: {B} rows of {H}x{W} pixels outside what the kernels take")


def _launch_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, silu: bool, with_stats: bool, eps: float = EPS):
    """The forward kernels on checked tensors -> (y, mean, rstd), the fp32
    (B, G) statistics only `with_stats` (else None).  Adds one to
    `group_norm.launches`."""
    B, C, H, W = x.shape
    threads, P, T = tiling(H * W, C)
    y = torch.empty_like(x)  # channels_last, as x is
    part = x.new_empty((B, T, num_groups, 2), dtype=torch.float32)
    mean = rstd = None
    if with_stats:
        mean, rstd = (x.new_empty((B, num_groups), dtype=torch.float32) for _ in range(2))
    err = _on_device(x.device, lambda stream: _entry("group_norm_forward")(
        x.data_ptr(), y.data_ptr(), mean.data_ptr() if with_stats else None,
        rstd.data_ptr() if with_stats else None, weight.data_ptr(), bias.data_ptr(),
        part.data_ptr(), B, H * W, C, num_groups, P, T, threads, eps, int(silu), stream))
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed: cudaError {err}")
    _count_launch(group_norm)
    return y, mean, rstd


def group_norm_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor, num_groups: int, silu: bool):
    """Gradient of act(GroupNorm(x)) -> (dx bf16, dweight, dbias fp32) from
    dy, x and the forward's fp32 (B, G) mean and rstd: the kernels of
    `csrc/group_norm.cu` (built at first use) on checked CUDA tensors, or
    an error.  Adds one to `group_norm_bwd.launches`."""
    _check("group_norm_bwd", x, weight, bias, num_groups, dy=dy)
    B, C, H, W = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.device != x.device or t.dtype != torch.float32 or t.shape != (B, num_groups)
                or not t.is_contiguous()):
            raise ValueError(f"group_norm_bwd: {name} must be a contiguous float32 "
                             f"{(B, num_groups)} tensor on x's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    threads, P, T = tiling(H * W, C)
    dx = torch.empty_like(x)
    dweight, dbias = (torch.empty(C, dtype=torch.float32, device=x.device) for _ in range(2))
    part_c = x.new_empty((B, T, C, 2), dtype=torch.float32)
    part_g = x.new_empty((B, T, num_groups, 2), dtype=torch.float32)
    err = _on_device(x.device, lambda stream: _entry("group_norm_backward")(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), part_c.data_ptr(),
        part_g.data_ptr(), B, H * W, C, num_groups, P, T, threads, int(silu), stream))
    if err != 0:
        raise RuntimeError(f"group_norm_bwd kernel launch failed: cudaError {err}")
    _count_launch(group_norm_bwd)
    return dx, dweight, dbias


group_norm_bwd.launches = 0


@torch.library.custom_op("image_diffusion_torch::group_norm_fwd", mutates_args=())
def group_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                   silu: bool, eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward with its statistics -> (y, mean, rstd), as an operator
    whose gradient is `group_norm_bwd_op`."""
    _check("group_norm", x, weight, bias, num_groups)
    return _launch_forward(x, weight, bias, num_groups, silu, with_stats=True, eps=eps)


@torch.library.custom_op("image_diffusion_torch::group_norm_bwd", mutates_args=())
def group_norm_bwd_op(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                      num_groups: int, silu: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `group_norm_fwd` -> (dx, dweight, dbias)."""
    return group_norm_bwd(dy, x, weight, bias, mean, rstd, num_groups, silu)


@group_norm_fwd.register_fake
def _fwd_fake(x, weight, bias, num_groups, silu, eps=EPS):
    B = x.shape[0]
    stats = x.new_empty((B, num_groups), dtype=torch.float32)
    return torch.empty_like(x, memory_format=torch.channels_last), stats, torch.empty_like(stats)


@group_norm_bwd_op.register_fake
def _bwd_fake(dy, x, weight, bias, mean, rstd, num_groups, silu):
    return (torch.empty_like(x, memory_format=torch.channels_last), torch.empty_like(weight),
            torch.empty_like(bias))


def _fwd_setup_context(ctx, inputs, output):
    x, weight, bias, num_groups, silu, _eps = inputs
    ctx.num_groups, ctx.silu = num_groups, silu
    ctx.save_for_backward(x, weight, bias, output[1], output[2])
    ctx.set_materialize_grads(False)  # no zero-filled gradients of mean and rstd


def _fwd_backward(ctx, dy, _d_mean, _d_rstd):
    if dy is None:
        return None, None, None, None, None, None
    x, weight, bias, mean, rstd = ctx.saved_tensors
    dy = dy.contiguous(memory_format=torch.channels_last)
    dx, dweight, dbias = group_norm_bwd_op(dy, x, weight, bias, mean, rstd, ctx.num_groups,
                                           ctx.silu)
    return dx, dweight, dbias, None, None, None


torch.library.register_autograd("image_diffusion_torch::group_norm_fwd", _fwd_backward,
                                setup_context=_fwd_setup_context)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
               silu: bool = False, eps: float = EPS) -> torch.Tensor:
    """act(GroupNorm(x)) on a bf16 CUDA tensor in channels_last memory, act
    SiLU or the identity: the kernels, or an error.  With grad enabled it
    runs as the operator `group_norm_fwd`; under `no_grad`/`inference_mode`
    the forward runs alone, without statistics.  Each launch of the forward
    kernels adds one to `group_norm.launches`."""
    if torch.is_grad_enabled():
        return group_norm_fwd(x, weight, bias, num_groups, silu, eps)[0]
    _check("group_norm", x, weight, bias, num_groups)
    return _launch_forward(x, weight, bias, num_groups, silu, with_stats=False, eps=eps)[0]


group_norm.launches = 0
