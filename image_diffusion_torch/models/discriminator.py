"""PatchGAN discriminator of stage-1 training.

The conv chain [in] + channels + [1]: kernel 4, padding 1, stride 2 (stride
1 on the last conv), a bias only on the first and last convs, BatchNorm on
the middle layers only, LeakyReLU(0.2) after every layer but the last.
Weights are drawn N(0, 0.02), BatchNorm scales N(1, 0.02).  A 128x128
input gives a 15x15 logit map.  Convs run in the compute dtype on fp32
parameters; BatchNorm runs in fp32.

BatchNorm follows flax's `nn.BatchNorm` (the JAX package's), not
`nn.BatchNorm2d`: in train mode the batch mean and the BIASED batch
variance max(E[x^2] - E[x]^2, 0) normalize, and the running statistics move
as r = 0.9 r + 0.1 stat with that biased variance (torch's own layer keeps
the unbiased one).  Each train-mode call updates them in place, so calls
thread them in the order they are made.  Under data parallelism (`group`
set by the trainer) the batch mean and mean of squares are averaged over
the data group, with their gradient: the statistics are the global
batch's, as under the JAX package's global view, and the running
statistics are equal on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import resolve_device
from ..parallel.mesh import all_reduce_mean
from .layers import Conv2d

MOMENTUM = 0.9  # retention of the running statistics
EPS = 1e-5


class BatchNorm(nn.Module):
    """fp32 batch normalization over (N, H, W) with flax's statistics;
    `group`: the process group the statistics are averaged over, or None."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            mean_sq = (x * x).mean(dim=(0, 2, 3))
            if self.group is not None:
                mean, mean_sq = all_reduce_mean(torch.stack([mean, mean_sq]), self.group)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * mean)
                self.running_var.mul_(MOMENTUM).add_((1.0 - MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + EPS) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class Discriminator(nn.Module):
    """NHWC images (any float dtype) -> NHWC logits in the compute dtype."""

    def __init__(self, channels: tuple[int, ...] = (64, 128, 256), in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        dims = [in_channels, *channels, 1]
        n = len(dims) - 1
        self.convs = nn.ModuleList(
            Conv2d(dims[i], dims[i + 1], 4, stride=1 if i == n - 1 else 2, padding=1,
                   bias=i in (0, n - 1))
            for i in range(n))
        # keyed by the index of the conv they follow, as flax names them
        self.norms = nn.ModuleDict({str(i): BatchNorm(dims[i + 1]) for i in range(1, n - 1)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            h = conv(h)
            if str(i) in self.norms:
                h = self.norms[str(i)](h).to(self.dtype)
            if i < last:
                h = F.leaky_relu(h, 0.2)
        return h.permute(0, 2, 3, 1)


@torch.no_grad()
def build_discriminator(channels: tuple[int, ...] = (64, 128, 256),
                        dtype: torch.dtype = torch.bfloat16, device="cuda",
                        generator: torch.Generator | None = None) -> Discriminator:
    """The discriminator on `device` in train mode, fp32 parameters, weights
    drawn from `generator` (on the CPU) with the PatchGAN's init."""
    model = Discriminator(channels, dtype=dtype)
    for conv in model.convs:
        conv.weight.normal_(0.0, 0.02, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()
    for norm in model.norms.values():
        norm.weight.normal_(1.0, 0.02, generator=generator)
    return model.to(device=resolve_device(device), memory_format=torch.channels_last).train()
