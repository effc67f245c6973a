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
  * GroupNorm: var = max(E[x^2] - E[x]^2, 0), eps 1e-5; in bf16 mode the
    per-element affine x*a + b runs in bf16 from fp32-computed a, b.
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
    """GroupNorm with fp32 statistics (eps 1e-5); output in the input dtype."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        G = self.num_groups
        cg = C // G
        n = cg * H * W
        x32 = x.float()
        g1 = x32.sum(dim=(2, 3)).view(B, G, cg).sum(-1)
        g2 = (x32 * x32).sum(dim=(2, 3)).view(B, G, cg).sum(-1)
        mean = g1 / n
        # E[x^2]-E[x]^2 can go slightly negative by cancellation
        var = torch.clamp(g2 / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + 1e-5)
        a = inv.repeat_interleave(cg, dim=1) * self.weight.float()
        b = self.bias.float() - mean.repeat_interleave(cg, dim=1) * a
        a, b = a[:, :, None, None], b[:, :, None, None]
        if x.dtype == torch.bfloat16:
            return x * a.to(torch.bfloat16) + b.to(torch.bfloat16)
        return (x32 * a + b).to(x.dtype)


class Residual(nn.Module):
    """VAE residual block: (GN, SiLU, conv) x 2 plus skip, 1x1 projection
    on a channel change."""

    def __init__(self, cin: int, cout: int, num_groups: int):
        super().__init__()
        self.branch = nn.Sequential(
            GroupNorm(num_groups, cin), nn.SiLU(), conv(cin, cout),
            GroupNorm(num_groups, cout), nn.SiLU(), conv(cout, cout),
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
        route = ops.site_route(H * W, C, self.num_heads, x.dtype)
        ops.log_site(B, H * W, C, self.num_heads, route)
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        if route == "kernel":
            attn = ops.packed_attention(q, k, v, self.num_heads)
        elif route == "flash":
            heads = (ops.split_heads(t, self.num_heads).contiguous() for t in (q, k, v))
            attn = ops.merge_heads(ops.flash_attention(*heads, 1.0 / math.sqrt(C // self.num_heads)))
        else:
            attn = ops.reference_attention(q, k, v, self.num_heads)
        out = self.out_proj(attn)
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
    """GN, SiLU, 3x3 conv: half of a UNet res layer."""

    def __init__(self, cin: int, cout: int, num_groups: int):
        super().__init__()
        self.layers = nn.Sequential(GroupNorm(num_groups, cin), nn.SiLU(), conv(cin, cout))

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
