"""Stage-2 class- and time-conditional UNet denoiser.

NHWC in and out; self-attention in every DiffusionBlock layer at every
resolution (32^2/16^2/8^2/4^2 token grids for the shipped config).

Classifier-free guidance conditioning: the class embedding row, times an
optional `context_mask` (0 drops the condition), is added to the time
embedding.  `context=None` equals an all-zero mask, which is what makes
the 2x-batched CFG call exact.

Activation rematerialization per DiffusionBlock (`remat`), for training
with grad enabled: each block runs under `torch.utils.checkpoint` with a
selective policy, so its backward recomputes what the policy does not save.
  * None / "none": every intermediate is kept (the plain module);
  * "dots": the outputs of convolutions, matrix products and the packed
    attention operator are saved; the GroupNorm(+SiLU) operators (on the
    card) or chains (the plain formula) and the fp32 -> bf16 weight casts
    are recomputed (the JAX package's `_conv_dots_saveable` plus the named
    "attn" tensors);
  * "full": only the packed attention operator's outputs are saved.
Both policies save the attention operator's output and row sums, so the
recomputed block never launches the forward kernel again: 14 forward and
14 backward launches a train step under every policy.  The state dict is
the same under every policy.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..core.config import UNetArch
from ..core.profiling import span
from .. import ops  # noqa: F401  (registers the packed attention operators)
from .layers import DiffusionBlock, Downsample, GroupNorm, TimeEmbedding, Upsample, conv

_aten = torch.ops.aten
_ATTENTION = {torch.ops.image_diffusion_torch.packed_attention_fwd.default}
SAVED_OPS = {
    "dots": {_aten.convolution.default, _aten.mm.default, _aten.addmm.default,
             _aten.bmm.default} | _ATTENTION,
    "full": _ATTENTION,
}


def _policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


class UNet(nn.Module):
    def __init__(self, arch: UNetArch, dtype: torch.dtype = torch.bfloat16,
                 remat: str | None = None):
        super().__init__()
        if remat not in (None, "none", *SAVED_OPS):
            raise ValueError(f"remat must be none, dots or full, got {remat!r}")
        self.arch = arch
        self.dtype = dtype
        self.remat = None if remat == "none" else remat
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
        self.out_conv = nn.Sequential(GroupNorm(arch.num_groups, cur, silu=True), nn.Identity(),
                                      conv(cur, arch.z_dim))

    def _block(self, block: DiffusionBlock, *args):
        if self.remat is None or not torch.is_grad_enabled():
            return block(*args)
        contexts = partial(create_selective_checkpoint_contexts,
                           partial(_policy, SAVED_OPS[self.remat]))
        return checkpoint(block, *args, use_reentrant=False, context_fn=contexts)

    def forward(self, x, timestep, context=None, context_mask=None):
        """x: (B, H, W, z_dim) latents; timestep: (B,) int; context: (B,)
        int class ids or None; context_mask: (B, 1) {0, 1} or None.
        Returns (B, H, W, z_dim) in the compute dtype."""
        with span("unet.forward", rows=x.shape[0]):
            t = self.time_embedding(timestep)
            if context is not None:
                c = self.class_embedding.weight.to(self.dtype)[context]
                if context_mask is not None:
                    c = c * context_mask.to(self.dtype)
                t = t + c

            h = self.in_conv(x.to(self.dtype).permute(0, 3, 1, 2))
            skips = []
            for block, down in zip(self.down_blocks, self.downsamples):
                h = self._block(block, h, t)
                skips.append(h)
                h = down(h)
            for block in self.mid_blocks:
                h = self._block(block, h, t)
            for up, block in zip(self.upsamples, self.ups):
                h = self._block(block, up(h), t, skips.pop())
            return self.out_conv(h).permute(0, 2, 3, 1)
