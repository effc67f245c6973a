"""Per-model checkpoint loading (self-describing, config-free).

Reads the JAX package's native files: per-model files store
{key: {params, ...}}; trainer epoch checkpoints store the raw params tree
under `key` with sibling collections (e.g. 'codebook') at the top level.
"""

from __future__ import annotations

import torch

from ..compat.from_jax import unet_state_dict, vae_state_dict
from ..core import checkpoint as ckpt
from ..core.config import UNetArch, VAEArch, _build
from . import build_unet, build_vae


def _unwrap(trees: dict, key: str, collections: tuple[str, ...] = ()) -> dict:
    tree = trees[key]
    variables = dict(tree) if "params" in tree else {"params": tree}
    for col in collections:
        if col in trees and col not in variables:
            variables[col] = trees[col]
    return variables


def load_vae(path: str, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """-> (model, arch) from a native per-model file or trainer checkpoint."""
    trees, meta = ckpt.load_checkpoint(path)
    arch = _build(VAEArch, meta["architecture"])
    model = build_vae(arch, dtype=dtype, device=device)
    model.load_state_dict(vae_state_dict(_unwrap(trees, "vae", ("codebook",))))
    return model, arch


def load_unet(path: str, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """-> (model, arch) from a native per-model file or trainer checkpoint."""
    trees, meta = ckpt.load_checkpoint(path)
    arch = _build(UNetArch, meta["architecture"])
    model = build_unet(arch, dtype=dtype, device=device)
    model.load_state_dict(unet_state_dict(_unwrap(trees, "unet")["params"]))
    return model, arch
