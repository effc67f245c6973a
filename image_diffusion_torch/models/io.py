"""Per-model checkpoint I/O (self-describing, config-free).

Reads and writes the JAX package's native files: per-model files store
{key: {params, ...}} with the architecture in the meta; trainer epoch
checkpoints store the raw params tree under `key` with sibling
collections (e.g. 'codebook') at the top level.  Also reads the original
PyTorch implementation's `.pt` files ({"architecture": ..., key: state
dict}), told apart by content: the port's module names are the
original's, so those state dicts load as they are.

`read_vae` / `read_unet` give a file's weights as an fp32 state dict
without building a model (what a bundle is made of); `load_vae` /
`load_unet` build the model in a compute dtype.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..compat.from_jax import unet_flax_params, unet_state_dict, vae_flax_variables, vae_state_dict
from ..core import checkpoint as ckpt
from ..core.config import UNetArch, VAEArch, _build
from . import build_unet, build_vae


def _is_native(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == ckpt.MAGIC


def _unwrap(trees: dict, key: str, collections: tuple[str, ...] = ()) -> dict:
    tree = trees[key]
    variables = dict(tree) if "params" in tree else {"params": tree}
    for col in collections:
        if col in trees and col not in variables:
            variables[col] = trees[col]
    return variables


def _read_original(path: str, key: str) -> tuple[dict, dict[str, torch.Tensor]]:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return raw["architecture"], {k: v.float() for k, v in raw[key].items()}


def read_vae(path: str) -> tuple[VAEArch, dict[str, torch.Tensor]]:
    """-> (arch, fp32 state dict) from a native per-model file, a trainer
    checkpoint or an original `.pt` file."""
    if _is_native(path):
        trees, meta = ckpt.load_checkpoint(path)
        arch, state = meta["architecture"], vae_state_dict(_unwrap(trees, "vae", ("codebook",)))
    else:
        arch, state = _read_original(path, "vae")
    return _build(VAEArch, arch), state


def read_unet(path: str) -> tuple[UNetArch, dict[str, torch.Tensor]]:
    """-> (arch, fp32 state dict), from the same kinds of file."""
    if _is_native(path):
        trees, meta = ckpt.load_checkpoint(path)
        arch, state = meta["architecture"], unet_state_dict(_unwrap(trees, "unet")["params"])
    else:
        arch, state = _read_original(path, "unet")
    return _build(UNetArch, arch), state


def load_vae(path: str, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """-> (model, arch), the model computing in `dtype`."""
    arch, state = read_vae(path)
    model = build_vae(arch, dtype=dtype, device=device)
    model.load_state_dict(state)
    return model, arch


def load_unet(path: str, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """-> (model, arch), the model computing in `dtype`."""
    arch, state = read_unet(path)
    model = build_unet(arch, dtype=dtype, device=device)
    model.load_state_dict(state)
    return model, arch


def save_vae(path: str, arch: VAEArch, state: Mapping[str, torch.Tensor]) -> None:
    """A native per-model file: {"vae": {"params"[, "codebook"]}}."""
    ckpt.save_checkpoint(path, architecture=arch.to_dict(), vae=vae_flax_variables(state))


def save_unet(path: str, arch: UNetArch, state: Mapping[str, torch.Tensor]) -> None:
    """A native per-model file: {"unet": {"params"}}."""
    ckpt.save_checkpoint(path, architecture=arch.to_dict(),
                         unet={"params": unet_flax_params(state)})
