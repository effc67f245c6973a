"""Architecture, schedule and training configuration.

Reads the reference YAML files (`configs/*.yaml`) into frozen dataclasses
whose `to_dict()` equals the JAX package's, so bundles and checkpoints
written by either package carry the same architecture metadata.  The files
are read by a small reader of their flat subset (no `yaml` needed).

Precision policy: "fp16" and "bf16" both compute in bfloat16 (no loss
scaling needed), "fp32" stays fp32; training holds parameters and optimizer
state in fp32 either way.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any

import torch

_SCI_NOTATION = re.compile(r"^\d+\.?\d*e[-+]?\d+$")
# the plain scalars the shipped configs use, resolved as yaml.safe_load does
_WORDS = {"": None, "null": None, "true": True, "false": False}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?$")


def _strip_comment(text: str) -> str:
    """`text` up to a `#` that starts a comment (at the start or after a
    blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text in _WORDS:
        return _WORDS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _value(text: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]") or "[" in text[1:]:
            raise ValueError(f"only flat flow lists are supported, got {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(item) for item in inner.split(",")] if inner else []
    return _scalar(text)


def parse_config(path: str) -> dict[str, Any]:
    """Read a flat YAML config: one `key: value` per line, values plain or
    quoted strings, ints, floats, true/false, null, or flow lists `[a, b]`;
    `#` comments.  These resolve as `yaml.safe_load` resolves them;
    scientific-notation strings, which it leaves as strings (e.g. "5e-6"),
    are coerced to floats.  Nesting and block lists raise."""
    data: dict[str, Any] = {}
    with open(path, "r") as f:
        for lineno, raw in enumerate(f, 1):
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip():
                continue
            key, sep, rest = line.partition(":")
            if line[0] in " \t-" or not sep or (rest and rest[0] not in " \t"):
                raise ValueError(f"{path}:{lineno}: not a flat `key: value` line: {raw!r}")
            data[key.strip()] = _value(rest)
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


@dataclass(frozen=True)
class TrainCommon:
    learning_rate: float = 1e-5
    warmup_steps: int = 0
    batch_size: int = 48
    epochs: int = 15
    clip_grad: float | None = 1.0
    precision: str = "bf16"
    checkpoints_dir: str = "./checkpoints"
    logs_dir: str = "./logs"
    seed: int | None = 2018
    log_interval: int = 50
    # batch_size splits into grad_accum micro-batches whose gradients are
    # averaged and applied once
    grad_accum: int = 1

    @property
    def compute_dtype(self) -> torch.dtype:
        return resolve_precision(self.precision)

    def validate_accum(self):
        if self.grad_accum < 1 or self.batch_size % self.grad_accum:
            raise ValueError(
                f"grad_accum {self.grad_accum} must divide batch_size {self.batch_size}"
            )


@dataclass(frozen=True)
class VAETrainConfig(TrainCommon):
    """Stage-1 trainer hyperparameters (configs/vae-*-32x32.yaml)."""

    recon_weight: float = 1.0
    percept_weight: float = 1.0
    prior_weight: float = 5e-6
    disc_weight: float = 0.1
    disc_start: int = 15000
    gan_loss: str = "bce"  # "bce" | "mse" | "hinge"
    disc_channels: tuple[int, ...] = (64, 128, 256)
    train_set: str = "./data/vqgan/train.npy"
    dev_set: str = "./data/vqgan/dev.npy"
    plot_set: str = "./data/vqgan/plot.npy"
    log_imgs_freq: int = 500

    def __post_init__(self):
        if self.gan_loss not in ("bce", "mse", "hinge"):
            raise ValueError(f"gan_loss must be bce/mse/hinge, got {self.gan_loss!r}")


@dataclass(frozen=True)
class DiffusionTrainConfig(TrainCommon):
    """Stage-2 trainer hyperparameters (configs/diff-kl-*-32x32.yaml)."""

    ae_type: str = "kl"
    cond_drop_prob: float = 0.15
    # activation remat policy of the train step: "none" | "dots" | "full"
    # (models/unet.py; the gradients are unchanged)
    remat: str = "none"
    # EMA of the denoiser weights for sampling; None/0 disables
    ema_decay: float | None = None
    train_set: str = "./data/diffusion/kl/train.npy"
    train_labels: str = "./data/diffusion/kl/train_labels.npy"


@dataclass(frozen=True)
class VAEConfig:
    arch: VAEArch
    train: VAETrainConfig

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "VAEConfig":
        raw = parse_config(path)
        raw.update(overrides)
        return cls(arch=_build(VAEArch, raw), train=_build(VAETrainConfig, raw))


@dataclass(frozen=True)
class DiffusionConfig:
    arch: UNetArch
    schedule: ScheduleConfig
    train: DiffusionTrainConfig

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "DiffusionConfig":
        raw = parse_config(path)
        raw.update(overrides)
        return cls(
            arch=_build(UNetArch, raw),
            schedule=_build(ScheduleConfig, raw),
            train=_build(DiffusionTrainConfig, raw),
        )


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
