"""LPIPS perceptual distance with a frozen VGG16 backbone.

The VGG16 convs tapped after relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, the lpips scaling of [-1, 1] inputs, unit-normalized feature
differences weighted per channel by the "lin" heads, spatial mean, summed
over the taps: the JAX package's `models/lpips.py`.  Inputs are NHWC images
in [-1, 1].  The backbone computes in `dtype` (the trainers pass their
compute dtype, as the reference autocasts its LPIPS forward); the tap
comparison always runs in fp32.

Weights cannot be downloaded, so they load from a torch-format file
(`from_torch_file`): the lpips package's layout (`net.slice*`,
`lin*.model.1.weight`) or torchvision's VGG16 `features.*` plus `lin.*`.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 stages: (out_channels, convs); a 2x2 max pool between stages
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS:
    """Frozen LPIPS: 13 (OIHW weight, bias) convs and 5 per-channel lin
    weights, all held in fp32; the convs also in the backbone's compute
    dtype, cast once."""

    def __init__(self, convs: list[tuple[torch.Tensor, torch.Tensor]], lins: list[torch.Tensor],
                 dtype: torch.dtype = torch.float32):
        if len(convs) != 13:
            raise ValueError(f"expected 13 VGG16 convs, got {len(convs)}")
        self.dtype = dtype
        self.weights = [(w.float().contiguous(memory_format=torch.channels_last), b.float())
                        for w, b in convs]
        self.convs = [(w.to(dtype), b.to(dtype)) for w, b in self.weights]
        self.lins = [w.float() for w in lins]

    def astype(self, dtype: torch.dtype) -> "LPIPS":
        """The same weights with the backbone computing in `dtype`."""
        return self if dtype == self.dtype else LPIPS(self.weights, self.lins, dtype)

    def to(self, device) -> "LPIPS":
        """A copy on `device`."""
        return LPIPS([(w.to(device), b.to(device)) for w, b in self.weights],
                     [w.to(device) for w in self.lins], self.dtype)

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        shift = x.new_tensor(_SHIFT, dtype=torch.float32)
        scale = x.new_tensor(_SCALE, dtype=torch.float32)
        h = ((x.float() - shift) / scale).to(self.dtype).permute(0, 3, 1, 2)
        feats, i = [], 0
        for stage, (_, n_convs) in enumerate(VGG16_STAGES):
            for _ in range(n_convs):
                w, b = self.convs[i]
                h = F.relu(F.conv2d(h, w, b, padding=1))
                i += 1
            feats.append(h.float())
            if stage < len(VGG16_STAGES) - 1:
                h = F.max_pool2d(h, 2)
        return feats

    def __call__(self, real: torch.Tensor, fake: torch.Tensor, reduce: bool = True) -> torch.Tensor:
        """The batch mean (0-d) or, with `reduce=False`, per-sample (N,)
        distances."""
        total = 0.0
        for fa, fb, lin in zip(self._features(real), self._features(fake), self.lins):
            na = fa / (torch.linalg.vector_norm(fa, dim=1, keepdim=True) + 1e-10)
            nb = fb / (torch.linalg.vector_norm(fb, dim=1, keepdim=True) + 1e-10)
            dist = torch.sum((na - nb) ** 2 * lin[None, :, None, None], dim=1)
            total = total + dist.mean(dim=(1, 2))
        return total.mean() if reduce else total

    @classmethod
    def from_state_dict(cls, state: dict) -> "LPIPS":
        """The lpips package's or torchvision's layout (see module doc)."""
        state = {k: torch.as_tensor(np.asarray(v, dtype=np.float32)) for k, v in state.items()}
        if any(k.startswith("net.slice") for k in state):
            keys = sorted((k for k in state if k.startswith("net.slice") and k.endswith(".weight")),
                          key=lambda k: (int(k.split(".")[1][5:]), int(k.split(".")[2])))
            lins = [state[f"lin{i}.model.1.weight"].reshape(-1) for i in range(5)]
        elif any(k.startswith("features.") for k in state):
            keys = sorted((k for k in state if k.startswith("features.") and k.endswith(".weight")
                           and state[k].dim() == 4), key=lambda k: int(k.split(".")[1]))
            lins = [state[f"lin.{i}.weight"].reshape(-1) for i in range(5)]
        else:
            raise ValueError("unrecognized LPIPS state dict layout")
        return cls([(state[k], state[k[:-len(".weight")] + ".bias"]) for k in keys], lins)

    @classmethod
    def from_torch_file(cls, path: str) -> "LPIPS":
        raw = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(raw, "state_dict"):
            raw = raw.state_dict()
        return cls.from_state_dict({k: v.detach().cpu().numpy() for k, v in raw.items()})


def try_load_lpips(path: str | None) -> LPIPS | None:
    """The LPIPS of a weights file, or None (with a warning) when there is
    no path or the file does not load."""
    if path is None:
        return None
    try:
        return LPIPS.from_torch_file(path)
    except Exception as e:  # the trainer then refuses to run unless told
        logging.warning("Could not load LPIPS weights from %s: %s", path, e)
        return None
