"""Stage-2 class- and time-conditional UNet denoiser.

NHWC in and out; self-attention in every DiffusionBlock layer at every
resolution (32^2/16^2/8^2/4^2 token grids for the shipped config).

Classifier-free guidance conditioning: the class embedding row, times an
optional `context_mask` (0 drops the condition), is added to the time
embedding.  `context=None` equals an all-zero mask, which is what makes
the 2x-batched CFG call exact.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import UNetArch
from .layers import DiffusionBlock, Downsample, GroupNorm, TimeEmbedding, Upsample, conv


class UNet(nn.Module):
    def __init__(self, arch: UNetArch, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        ch, mid = arch.channels, arch.mid_channels
        block = dict(num_layers=arch.num_res_layers, num_heads=arch.num_heads,
                     num_groups=arch.num_groups, time_dim=arch.time_dim)

        self.class_embedding = nn.Embedding(arch.num_classes, arch.time_dim)
        self.time_embedding = TimeEmbedding(arch.time_dim, dtype)
        self.in_conv = conv(arch.z_dim, ch[0])

        cur, skips = ch[0], []
        self.down_blocks, self.downsamples = nn.ModuleList(), nn.ModuleList()
        for c in ch[1:]:
            self.down_blocks.append(DiffusionBlock(cur, c, **block))
            self.downsamples.append(Downsample(c))
            cur = c
            skips.append(c)
        self.mid_blocks = nn.ModuleList()
        for c in mid[1:]:
            self.mid_blocks.append(DiffusionBlock(cur, c, **block))
            cur = c
        self.ups, self.upsamples = nn.ModuleList(), nn.ModuleList()
        for c in ch[::-1][1:]:
            self.upsamples.append(Upsample(cur))
            self.ups.append(DiffusionBlock(cur + skips.pop(), c, **block))
            cur = c
        self.out_conv = nn.Sequential(GroupNorm(arch.num_groups, cur), nn.SiLU(),
                                      conv(cur, arch.z_dim))

    def forward(self, x, timestep, context=None, context_mask=None):
        """x: (B, H, W, z_dim) latents; timestep: (B,) int; context: (B,)
        int class ids or None; context_mask: (B, 1) {0, 1} or None.
        Returns (B, H, W, z_dim) in the compute dtype."""
        t = self.time_embedding(timestep)
        if context is not None:
            c = self.class_embedding.weight.to(self.dtype)[context]
            if context_mask is not None:
                c = c * context_mask.to(self.dtype)
            t = t + c

        h = self.in_conv(x.to(self.dtype).permute(0, 3, 1, 2))
        skips = []
        for block, down in zip(self.down_blocks, self.downsamples):
            h = block(h, t)
            skips.append(h)
            h = down(h)
        for block in self.mid_blocks:
            h = block(h, t)
        for up, block in zip(self.upsamples, self.ups):
            h = block(up(h), t, out_down=skips.pop())
        return self.out_conv(h).permute(0, 2, 3, 1)
