"""Configuration, precision policy, devices, checkpoint I/O, figures, step timing
and CLI plumbing."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on.  A CUDA device with no card
    present raises: the port never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def is_main_process() -> bool:
    """True outside a process group and on its rank 0: the one process that
    writes checkpoints, metrics and figures."""
    return not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0


@contextlib.contextmanager
def no_tf32():
    """cuBLAS matmuls and cuDNN convolutions in full fp32 (no TF32) for the
    block, then as they were.  TF32 keeps about three digits; the metric
    and labelling networks (InceptionV3, CLIP) run without it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
