"""Architecture and schedule configuration.

Reads the reference YAML files (`configs/*.yaml`) into frozen dataclasses
whose `to_dict()` equals the JAX package's, so bundles written by either
package carry the same architecture metadata.

Precision policy: "fp16" and "bf16" both compute in bfloat16 (no loss
scaling needed), "fp32" stays fp32.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any

import torch

_SCI_NOTATION = re.compile(r"^\d+\.?\d*e[-+]?\d+$")


def parse_config(path: str) -> dict[str, Any]:
    """Parse a YAML config file, coercing scientific-notation strings
    (yaml.safe_load leaves e.g. "5e-6" as a string)."""
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f)
    for key, value in data.items():
        if isinstance(value, str) and _SCI_NOTATION.match(value):
            data[key] = float(value)
    return data


def resolve_precision(name: str) -> torch.dtype:
    """Map a config precision string to a compute dtype."""
    table = {"fp16": torch.bfloat16, "bf16": torch.bfloat16, "fp32": torch.float32}
    if name not in table:
        raise ValueError(f"Unknown precision {name!r}; expected one of {sorted(table)}")
    return table[name]


@dataclass(frozen=True)
class VAEArch:
    """Architecture of the stage-1 autoencoder."""

    in_channels: int = 3
    channels: tuple[int, ...] = (128, 256, 384)
    z_dim: int = 3
    bottleneck: str = "kl"  # "kl" | "vq"
    codebook_size: int | None = None
    codebook_beta: float | None = None
    codebook_gamma: float | None = None
    enc_num_res_blocks: int = 2
    dec_num_res_blocks: int = 2
    attn_resolutions: tuple[int, ...] = ()
    num_heads: int = 1
    init_resolution: int = 128
    num_groups: int = 32

    def __post_init__(self):
        if self.bottleneck not in ("kl", "vq"):
            raise ValueError(f"bottleneck must be 'kl' or 'vq', got {self.bottleneck!r}")
        if self.bottleneck == "vq" and not self.codebook_size:
            raise ValueError("VQ bottleneck requires codebook_size")

    @property
    def latent_resolution(self) -> int:
        # one Downsample per channel pair: factor 2^(len(channels)-1)
        return self.init_resolution // (2 ** (len(self.channels) - 1))

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["channels"] = list(self.channels)
        d["attn_resolutions"] = list(self.attn_resolutions)
        return d


@dataclass(frozen=True)
class UNetArch:
    """Architecture of the stage-2 denoiser."""

    z_dim: int = 3
    channels: tuple[int, ...] = (128, 256, 384, 512)
    mid_channels: tuple[int, ...] = (512, 512)
    time_dim: int = 512
    num_res_layers: int = 2
    num_heads: int = 8
    num_groups: int = 32
    num_classes: int = 3

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["channels"] = list(self.channels)
        d["mid_channels"] = list(self.mid_channels)
        return d


@dataclass(frozen=True)
class ScheduleConfig:
    """DDPM noise schedule hyperparameters."""

    num_steps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    noise_type: str = "linear"  # "linear" (scaled-linear) | "cosine"

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _build(cls, raw: dict[str, Any]):
    """Construct a dataclass from a flat config dict.

    Unknown keys are ignored (they belong to a sibling dataclass); lists
    become tuples so configs stay hashable.
    """
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in raw.items():
        if k in names:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    # attn_resolutions: [] parses as None in some YAML edge cases
    if "attn_resolutions" in names and kwargs.get("attn_resolutions") is None:
        kwargs["attn_resolutions"] = ()
    return cls(**kwargs)
