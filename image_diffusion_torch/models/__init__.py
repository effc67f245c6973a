"""Model zoo of the sampling path: VAE (KL/VQ) and the UNet denoiser."""

from __future__ import annotations

import torch

from ..core import resolve_device
from ..core.config import UNetArch, VAEArch
from .layers import materialize
from .unet import UNet
from .vae import VAE, Codebook, Decoder, Encoder

__all__ = ["VAE", "UNet", "Encoder", "Decoder", "Codebook", "build_vae", "build_unet"]


def _build(cls, arch, dtype, device, generator, param_dtype=None):
    dev = resolve_device(device)
    if dev.type == "cuda" and dtype == torch.float32:
        # fp32 is the verification mode: true fp32 products, no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = cls(arch, dtype)
    return materialize(model, param_dtype or dtype, dev, generator).eval()


def build_vae(arch: VAEArch, dtype: torch.dtype = torch.bfloat16, device="cuda",
              generator: torch.Generator | None = None) -> VAE:
    """The VAE on `device`, weights drawn from `generator` or zero (to be
    loaded with `load_state_dict`)."""
    return _build(VAE, arch, dtype, device, generator)


def build_unet(arch: UNetArch, dtype: torch.dtype = torch.bfloat16, device="cuda",
               generator: torch.Generator | None = None,
               param_dtype: torch.dtype | None = None) -> UNet:
    """The UNet on `device` computing in `dtype`, weights drawn from
    `generator` or zero (to be loaded with `load_state_dict`).  Conv and
    linear weights are held in `param_dtype` (default: `dtype`); training
    passes float32 (see `models/layers.py`)."""
    return _build(UNet, arch, dtype, device, generator, param_dtype)
