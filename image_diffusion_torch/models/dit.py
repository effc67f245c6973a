"""The DiT denoiser (Peebles & Xie, "Scalable Diffusion Models with
Transformers", arXiv:2212.09748), as facebookresearch/DiT's `models.py`
states it: DiT-XL/2 at 256x256 is depth 28, hidden 1152, patch 2, 16 heads,
mlp_ratio 4 over a 32x32x4 latent, class-conditional over 1,000 classes
with a null row for guidance, learned sigma (8 output channels).

NHWC latents in, NHWC (B, H, W, out_channels) out, in the compute dtype;
the first `in_channels` channels are eps, the rest the variance
interpolation the pipeline does not read.  Module and parameter names are
DiT's (`x_embedder.proj`, `blocks.{i}.attn.qkv`, `blocks.{i}.mlp.fc1`,
`blocks.{i}.adaLN_modulation.1`, `final_layer.linear`, `pos_embed`, ...),
so its state dicts load with a plain `load_state_dict`.

  * patch embed: a p x p stride-p conv, then the fixed 2-D sin-cos
    position embedding (`pos_embed`, a buffer of the state dict);
  * timestep embedding: 256 frequencies exp(-ln(1e4) i / 128), cat[cos,
    sin] (the UNet's is [sin, cos]), MLP 256 -> hidden -> hidden (SiLU);
  * label embedding: num_classes + 1 rows, the last the null class; a
    condition mask of 0 takes it, so the pipeline's 2x-batched CFG call
    (class ids with mask 1, then mask 0) is DiT's cond / null pair;
  * each block, adaLN-Zero: SiLU -> Linear(hidden, 6 hidden) gives shift,
    scale and gate for attention and MLP; x += gate * attn(LN(x) * (1 +
    scale) + shift), x += gate * mlp(...), LayerNorm without affine at eps
    1e-6; timm's attention (one qkv Linear with bias, heads as contiguous
    "(h d)" bands, proj), MLP fc1 -> GELU(tanh) -> fc2;
  * final layer: adaLN shift and scale, LN, Linear to p * p * out
    channels, unpatchify.

Compute: bf16 (or fp32) with Linear/conv weights cast at use
(`layers.Linear`); LayerNorm's statistics in fp32 (ATen's), the modulate
and the gated residual add as one `addcmul` each, rounded once.  The
attention takes the route `ops.site_route` gives the site: at d = 72
without grad the packed forward kernel (28 launches a call).  Weights are
drawn by `layers.materialize` with the port's default statistics, the
adaLN and final layers included (DiT's zero initialization would make the
model an identity at set-up).

Spans: `dit.forward` (rows) around the call; inside it `dit.modulate`
around each LayerNorm + shift/scale, each gated residual add and the final
layer's modulate, `dit.attention` around qkv -> kernel -> proj and
`dit.mlp` around fc1 -> GELU -> fc2.  DiT training (learned-sigma loss,
the d = 72 backward) is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import DiTArch
from ..core.profiling import span
from .layers import Conv2d, Linear, attend

LN_EPS = 1e-6
FREQUENCIES = 256  # the timestep embedding's width


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """DiT's `get_2d_sincos_pos_embed(dim, grid)`: (grid * grid, dim) fp32,
    token i * grid + j: the first half from column j, the second from row
    i, each [sin, cos] of pos / 10000^(k / (dim / 4)), in float64."""

    def one_d(d: int, pos: np.ndarray) -> np.ndarray:
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    cols, rows = np.meshgrid(np.arange(grid, dtype=np.float32), np.arange(grid, dtype=np.float32))
    emb = np.concatenate([one_d(dim // 2, cols), one_d(dim // 2, rows)], axis=1)
    return torch.from_numpy(emb.astype(np.float32))


def timestep_frequencies() -> torch.Tensor:
    half = FREQUENCIES // 2
    return torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale1: torch.Tensor) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift over (B, N, D) tokens, `scale1` being 1 +
    scale and both (B, D): LayerNorm without affine (fp32 statistics), then
    one addcmul."""
    h = F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)
    return torch.addcmul(shift[:, None], h, scale1[:, None])


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("freqs", timestep_frequencies(), persistent=False)
        self.mlp = nn.Sequential(Linear(FREQUENCIES, hidden), nn.SiLU(), Linear(hidden, hidden))

    def reset_state(self, generator=None):
        self.freqs.copy_(timestep_frequencies())

    def forward(self, t):
        args = t.float()[:, None] * self.freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.mlp(emb.to(self.dtype))


class LabelEmbedder(nn.Module):
    """num_classes + 1 rows; row num_classes is the null class."""

    def __init__(self, num_classes: int, hidden: int):
        super().__init__()
        self.embedding_table = nn.Embedding(num_classes + 1, hidden)


class Attention(nn.Module):
    """timm's `Attention` with qkv bias: q, k and v are the three row bands
    of `qkv`'s weight, each taken by its own product so the kernel gets
    three contiguous (B, N, C) tensors."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        with span("dit.attention"):
            C = x.shape[-1]
            w, b = self.qkv.weight.to(x.dtype), self.qkv.bias.to(x.dtype)
            q, k, v = (F.linear(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C]) for i in range(3))
            return self.proj(attend(q, k, v, self.num_heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        with span("dit.mlp"):
            return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = Attention(hidden, num_heads)
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden, 6 * hidden))

    def forward(self, x, c):
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = self.adaLN_modulation(c).chunk(6, 1)
        with span("dit.modulate"):
            h = modulate(x, shift_a, 1 + scale_a)
        h = self.attn(h)
        with span("dit.modulate"):
            x = torch.addcmul(x, gate_a[:, None], h)
            h = modulate(x, shift_m, 1 + scale_m)
        h = self.mlp(h)
        with span("dit.modulate"):
            return torch.addcmul(x, gate_m[:, None], h)


class FinalLayer(nn.Module):
    def __init__(self, hidden: int, patch: int, out_channels: int):
        super().__init__()
        self.linear = Linear(hidden, patch * patch * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden, 2 * hidden))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, 1)
        with span("dit.modulate"):
            h = modulate(x, shift, 1 + scale)
        return self.linear(h)


class DiT(nn.Module):
    def __init__(self, arch: DiTArch, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        D, p = arch.hidden_size, arch.patch_size
        self.grid = arch.input_size // p
        self.x_embedder = nn.Module()
        self.x_embedder.proj = Conv2d(arch.in_channels, D, p, stride=p)
        self.register_buffer("pos_embed", torch.zeros(1, self.grid**2, D))
        self.t_embedder = TimestepEmbedder(D, dtype)
        self.y_embedder = LabelEmbedder(arch.num_classes, D)
        self.blocks = nn.ModuleList(DiTBlock(D, arch.num_heads, arch.mlp_ratio)
                                    for _ in range(arch.depth))
        self.final_layer = FinalLayer(D, p, arch.out_channels)

    def reset_state(self, generator=None):
        self.pos_embed.copy_(sincos_2d(self.arch.hidden_size, self.grid)[None])

    def forward(self, x, timestep, context=None, context_mask=None):
        """x: (B, H, W, in_channels) latents; timestep: (B,) int; context:
        (B,) int class ids or None (the null class); context_mask: (B, 1)
        {0, 1} or None, 0 taking the null class.  Returns (B, H, W,
        out_channels) in the compute dtype."""
        B = x.shape[0]
        with span("dit.forward", rows=B):
            a, p, g = self.arch, self.arch.patch_size, self.grid
            h = self.x_embedder.proj(x.to(self.dtype).permute(0, 3, 1, 2))
            h = h.permute(0, 2, 3, 1).reshape(B, g * g, a.hidden_size)
            h = h + self.pos_embed.to(self.dtype)
            null = torch.full((B,), a.num_classes, dtype=torch.int64, device=x.device)
            labels = null if context is None else context
            if context is not None and context_mask is not None:
                labels = torch.where(context_mask.reshape(B) > 0, context, null)
            c = (self.t_embedder(timestep)
                 + self.y_embedder.embedding_table.weight.to(self.dtype)[labels])
            for block in self.blocks:
                h = block(h, c)
            h = self.final_layer(h, c)  # (B, g * g, p * p * out)
            out = h.reshape(B, g, g, p, p, a.out_channels).permute(0, 1, 3, 2, 4, 5)
            return out.reshape(B, g * p, g * p, a.out_channels)
