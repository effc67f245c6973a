"""Stage-1 training losses, all computed in fp32 whatever the model's
compute dtype: reconstruction = MSE + L1, and the GAN losses hinge, mse
(with the [0, 1] clamp on the discriminator side) and bce with logits (the
shipped configs use "bce").  The JAX package's `training/losses.py`."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def recon_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """MSE + L1 over every element."""
    diff = fake.float() - real.float()
    return torch.mean(diff**2) + torch.mean(diff.abs())


def recon_loss_per_sample(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Per-sample (N,) MSE + L1; its mean is `recon_loss` for equal-size
    samples.  Dev evaluation weights a padded tail batch with it."""
    diff = fake.float() - real.float()
    axes = tuple(range(1, diff.dim()))
    return torch.mean(diff**2, dim=axes) + torch.mean(diff.abs(), dim=axes)


def hinge_d_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - real.float())) + torch.mean(F.relu(1.0 + fake.float())))


def hinge_g_loss(fake: torch.Tensor) -> torch.Tensor:
    return -torch.mean(fake.float())


def mse_d_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    loss_fake = torch.mean(torch.clamp(fake.float(), 0.0, 1.0) ** 2)
    loss_real = torch.mean((torch.clamp(real.float(), 0.0, 1.0) - 1.0) ** 2)
    return 0.5 * (loss_real + loss_fake)


def mse_g_loss(fake: torch.Tensor) -> torch.Tensor:
    return torch.mean((fake.float() - 1.0) ** 2)


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    x = logits.float()
    # the stable form max(x, 0) - x * z + log1p(exp(-|x|))
    return torch.mean(torch.clamp(x, min=0.0) - x * target + torch.log1p(torch.exp(-x.abs())))


def bce_d_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return 0.5 * (_bce_with_logits(real, 1.0) + _bce_with_logits(fake, 0.0))


def bce_g_loss(fake: torch.Tensor) -> torch.Tensor:
    return _bce_with_logits(fake, 1.0)


D_LOSSES = {"hinge": hinge_d_loss, "mse": mse_d_loss, "bce": bce_d_loss}
G_LOSSES = {"hinge": hinge_g_loss, "mse": mse_g_loss, "bce": bce_g_loss}
