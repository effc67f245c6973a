"""Building blocks of the UNet and the VAE, as `nn.Module`s.

Modules take and return NCHW tensors held in `torch.channels_last` memory
format, so an attention site's (B, N, C) token view is free.  Module and
parameter names follow the original PyTorch implementation
(`first_halfs.0.layers.0`, `self_attns.0.to_q`, `branch.2`, ...), so its
state dicts load with a plain `load_state_dict`.

Precision: conv and linear weights are held in the parameter dtype and
cast to their input's dtype (the compute dtype) at use.  Sampling holds them
in the compute dtype, so the cast is a no-op; training holds them in fp32
with bf16 compute, the JAX package's policy (`param_dtype=float32`), so the
optimizer state and updates are fp32.  GroupNorm parameters stay fp32 and
its statistics are fp32 sums.
Numerics follow the JAX package's layers:
  * GroupNorm: var = max(E[x^2] - E[x]^2, 0), eps 1e-5 (the KL-f8
    decoder's 1e-6 where a module is given it); in bf16 mode on
    the CPU the per-element affine x*a + b runs in bf16 from fp32-computed
    a, b; on a card the kernel pair runs it, and the SiLU after it where
    the model has one, in fp32 and rounds once (`ops/group_norm.py`).
  * SpatialSelfAttention: GN pre-norm, separate q/k/v, contiguous "(h d)"
    head split, residual add inside; the attention itself takes the route
    `ops.site_route` gives the site.
  * Downsample: 3x3 stride-2 VALID conv, then a (0,1,0,1) zero pad.
  * Upsample: nearest 2x, then a 3x3 conv.
  * TimeEmbedding: factor 10000^(i/half), concat(sin, cos), cast to the
    compute dtype before the MLP.
  * DiffusionBlock: skip concat [x, skip] on channels before layer 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..core.profiling import span
from ..ops.group_norm import EPS as GN_EPS


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose weight and bias (if any) are cast to the input's
    dtype at use."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast to the input's dtype at use."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def conv(cin: int, cout: int, k: int = 3, stride: int = 1, valid: bool = False) -> Conv2d:
    """k x k conv, 'SAME' padding unless `valid`."""
    return Conv2d(cin, cout, k, stride=stride, padding=0 if valid else k // 2)


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics (eps 1e-5 unless given); output in the
    input dtype.

    With `silu` the SiLU that follows the norm in the model is applied
    here, so a bf16 tensor on a card takes one fused kernel pair
    (`ops.group_norm`) for both; every other input (the CPU, fp32
    verification mode) takes the plain formula (`ops.reference_group_norm`),
    then `F.silu`.  A site built with `silu` keeps an `nn.Identity` where
    its `nn.SiLU` was, so module indices and state-dict keys stay those of
    the original implementation."""

    def __init__(self, num_groups: int, channels: int, silu: bool = False,
                 eps: float = GN_EPS):
        super().__init__()
        self.num_groups = num_groups
        self.silu = silu
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("groupnorm"):
            if x.is_cuda and x.dtype == torch.bfloat16:
                return ops.group_norm(x, self.weight.float(), self.bias.float(),
                                      self.num_groups, self.silu, self.eps)
            return ops.reference_group_norm(x, self.weight, self.bias, self.num_groups, self.silu,
                                            self.eps)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention of (B, N, C) q, k, v, heads as contiguous "(h d)"
    channel bands, by the route `ops.site_route` gives the site (logged by
    `ops.log_site`)."""
    B, N, C = q.shape
    route = ops.site_route(N, C, num_heads, q.dtype)
    ops.log_site(B, N, C, num_heads, route)
    if route == "kernel":
        return ops.packed_attention(q, k, v, num_heads)
    if route == "flash":
        heads = (ops.split_heads(t, num_heads).contiguous() for t in (q, k, v))
        return ops.merge_heads(ops.flash_attention(*heads, 1.0 / math.sqrt(C // num_heads)))
    return ops.reference_attention(q, k, v, num_heads)


class Residual(nn.Module):
    """VAE residual block: (GN + SiLU, conv) x 2 plus skip, 1x1 projection
    on a channel change."""

    def __init__(self, cin: int, cout: int, num_groups: int):
        super().__init__()
        self.branch = nn.Sequential(
            GroupNorm(num_groups, cin, silu=True), nn.Identity(), conv(cin, cout),
            GroupNorm(num_groups, cout, silu=True), nn.Identity(), conv(cout, cout),
        )
        self.residual_wrapper = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        skip = x if self.residual_wrapper is None else self.residual_wrapper(x)
        return self.branch(x) + skip


class SpatialSelfAttention(nn.Module):
    """Multi-head self-attention over the H*W tokens, residual add inside."""

    def __init__(self, channels: int, num_heads: int, num_groups: int):
        super().__init__()
        self.num_heads = num_heads
        self.groupnorm = GroupNorm(num_groups, channels)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.out_proj = Linear(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        tokens = self.groupnorm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        out = self.out_proj(attend(q, k, v, self.num_heads))
        return out.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class Downsample(nn.Module):
    """Stride-2 VALID conv, then an asymmetric (0,1,0,1) zero pad."""

    def __init__(self, channels: int):
        super().__init__()
        self.down = conv(channels, channels, 3, stride=2, valid=True)

    def forward(self, x):
        return F.pad(self.down(x), (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def sinusoid_factor(dim: int) -> torch.Tensor:
    half = dim // 2
    return 10000.0 ** (torch.arange(half, dtype=torch.float32) / half)


class TimeEmbedding(nn.Module):
    """Sinusoidal timestep embedding (fp32) and an MLP dim -> 4 dim -> dim
    run in the compute dtype `dtype`."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.register_buffer("factor", sinusoid_factor(dim))
        self.embeddings = nn.Sequential(Linear(dim, 4 * dim), nn.SiLU(), Linear(4 * dim, dim))

    def reset_state(self, generator=None):
        self.factor.copy_(sinusoid_factor(self.dim))

    def forward(self, t):
        angles = t.float()[:, None] / self.factor
        emb = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
        return self.embeddings(emb.to(self.dtype))


class ConvBlock(nn.Module):
    """GN + SiLU, 3x3 conv: half of a UNet res layer."""

    def __init__(self, cin: int, cout: int, num_groups: int):
        super().__init__()
        self.layers = nn.Sequential(GroupNorm(num_groups, cin, silu=True), nn.Identity(),
                                    conv(cin, cout))

    def forward(self, x):
        return self.layers(x)


class DiffusionBlock(nn.Module):
    """UNet stage: num_layers x [ConvBlock, + time projection, ConvBlock,
    + 1x1 residual, self-attention].  The skip tensor is concatenated
    after x on the channel axis before layer 0."""

    def __init__(self, cin: int, cout: int, num_layers: int, num_heads: int,
                 num_groups: int, time_dim: int):
        super().__init__()
        ins = [cin] + [cout] * (num_layers - 1)
        self.first_halfs = nn.ModuleList(ConvBlock(c, cout, num_groups) for c in ins)
        self.time_projs = nn.ModuleList(
            nn.Sequential(nn.SiLU(), Linear(time_dim, cout)) for _ in ins)
        self.second_halfs = nn.ModuleList(ConvBlock(cout, cout, num_groups) for _ in ins)
        self.residuals = nn.ModuleList(conv(c, cout, 1) for c in ins)
        self.self_attns = nn.ModuleList(
            SpatialSelfAttention(cout, num_heads, num_groups) for _ in ins)

    def forward(self, x, temb, out_down=None):
        if out_down is not None:
            x = torch.cat([x, out_down], dim=1)
        for first, proj, second, res, attn in zip(self.first_halfs, self.time_projs,
                                                  self.second_halfs, self.residuals,
                                                  self.self_attns):
            h = first(x) + proj(temb)[:, :, None, None]
            h = second(h) + res(x)
            x = attn(h)
        return x


@torch.no_grad()
def materialize(model: nn.Module, dtype: torch.dtype, device: torch.device,
                generator: torch.Generator | None = None) -> nn.Module:
    """Allocate a model built on the meta device on `device` and fill it.

    With `generator`, weights are drawn from it (on the CPU, in module
    order) with torch's default statistics: U(+-1/sqrt(fan_in)) for conv
    and linear weights and biases, N(0, 1) for embeddings.  Without one,
    weights are zero, ready for `load_state_dict`.  GroupNorm starts at
    (1, 0).  Modules with buffers, or whose state has its own initial
    distribution (the VQ codebook), then set it (`reset_state(generator)`).
    Conv and linear parameters are then cast to `dtype` (the parameter
    dtype), and 4-D weights go to channels_last."""
    model.to_empty(device=device)

    def fill(p, draw):
        p.copy_(draw(torch.empty(p.shape)) if generator is not None else torch.zeros(p.shape))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for p in (m.weight, m.bias):
                fill(p, lambda t: t.uniform_(-bound, bound, generator=generator))
        elif isinstance(m, nn.Embedding):
            fill(m.weight, lambda t: t.normal_(0.0, 1.0, generator=generator))
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
    for m in model.modules():
        if hasattr(m, "reset_state"):
            m.reset_state(generator)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype=dtype, memory_format=torch.channels_last)
    return model
