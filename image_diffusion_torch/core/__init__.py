"""Configuration, precision policy, devices and checkpoint I/O."""

from __future__ import annotations

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
