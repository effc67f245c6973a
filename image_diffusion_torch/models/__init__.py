"""Model zoo: VAE (KL/VQ, and the latent-diffusion KL-f8 decoder), the
denoisers (the UNet, DiT), stage-1 training's discriminator and LPIPS, and
FID's InceptionV3 (`models/inception.py`, `models/fid.py`, imported where
they are used)."""

from __future__ import annotations

import torch

from ..core import resolve_device
from ..core.config import DiTArch, UNetArch, VAEArch
from .discriminator import Discriminator, build_discriminator
from .dit import DiT
from .layers import materialize
from .lpips import LPIPS, try_load_lpips
from .unet import UNet
from .vae import VAE, Codebook, Decoder, Encoder, LDMDecoderVAE

__all__ = ["VAE", "LDMDecoderVAE", "UNet", "DiT", "Encoder", "Decoder", "Codebook",
           "Discriminator", "LPIPS", "build_discriminator", "build_vae", "build_unet", "build_denoiser", "try_load_lpips"]


def _build(cls, arch, dtype, device, generator, param_dtype=None, **options):
    dev = resolve_device(device)
    if dev.type == "cuda" and dtype == torch.float32:
        # fp32 is the verification mode: true fp32 products, no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = cls(arch, dtype, **options)
    return materialize(model, param_dtype or dtype, dev, generator).eval()


def build_vae(arch: VAEArch, dtype: torch.dtype = torch.bfloat16, device="cuda",
              generator: torch.Generator | None = None,
              param_dtype: torch.dtype | None = None) -> VAE | LDMDecoderVAE:
    """The VAE on `device` computing in `dtype`, weights drawn from
    `generator` or zero (to be loaded with `load_state_dict`).  Conv and
    linear weights are held in `param_dtype` (default: `dtype`); training
    passes float32 (see `models/layers.py`).  The "ldm" layout builds the
    decode-only `LDMDecoderVAE`."""
    cls = LDMDecoderVAE if arch.layout == "ldm" else VAE
    return _build(cls, arch, dtype, device, generator, param_dtype)


def build_unet(arch: UNetArch, dtype: torch.dtype = torch.bfloat16, device="cuda",
               generator: torch.Generator | None = None,
               param_dtype: torch.dtype | None = None, remat: str | None = None) -> UNet:
    """The UNet on `device` computing in `dtype`, weights drawn from
    `generator` or zero (to be loaded with `load_state_dict`).  Conv and
    linear weights are held in `param_dtype` (default: `dtype`); training
    passes float32 (see `models/layers.py`).  `remat`: the activation
    rematerialization policy of its blocks (see `models/unet.py`)."""
    return _build(UNet, arch, dtype, device, generator, param_dtype, remat=remat)


def build_denoiser(arch: UNetArch | DiTArch, dtype: torch.dtype = torch.bfloat16, device="cuda",
                   generator: torch.Generator | None = None,
                   param_dtype: torch.dtype | None = None) -> UNet | DiT:
    """The UNet or the DiT, by the type of `arch`, as `build_unet` builds
    the UNet (DiT's weights likewise from `generator` or zero)."""
    if isinstance(arch, DiTArch):
        return _build(DiT, arch, dtype, device, generator, param_dtype)
    return build_unet(arch, dtype, device, generator, param_dtype)
