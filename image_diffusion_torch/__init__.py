"""PyTorch/CUDA port of the two-stage latent-diffusion system.

Trains the stage-1 VAE-GAN and the stage-2 UNet, extracts latents, makes
inference bundles, samples classifier-free-guidance grids and scores them
by FID, through the command lines in `scripts/`, with files and bundles interchangeable with
`image_diffusion_tpu`'s, at the full width of the shipped models.  Public
functions keep the NHWC layout of the JAX package; modules hold NCHW
tensors in `torch.channels_last` memory format internally.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; self-attention runs as hand-written Hopper kernels
(`ops/csrc/`) on CUDA tensors.
"""

from .core.config import ScheduleConfig, UNetArch, VAEArch

__all__ = ["ScheduleConfig", "UNetArch", "VAEArch"]
