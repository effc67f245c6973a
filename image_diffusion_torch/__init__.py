"""PyTorch/CUDA port of the two-stage latent-diffusion sampler.

Samples classifier-free-guidance grids from an inference bundle written by
(or for) `image_diffusion_tpu`, at the full width of the shipped models.
Public functions keep the NHWC layout of the JAX package; modules hold
NCHW tensors in `torch.channels_last` memory format internally.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; the self-attention forward runs as a hand-written Hopper
kernel (`ops/csrc/packed_attention.cu`) on CUDA tensors.
"""

from .core.config import ScheduleConfig, UNetArch, VAEArch

__all__ = ["ScheduleConfig", "UNetArch", "VAEArch"]
