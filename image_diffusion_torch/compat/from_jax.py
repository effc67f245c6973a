"""Weights and trainer state carried across: the JAX package's flax trees
<-> the port's state dicts.

Conv kernels go HWIO <-> OIHW, dense kernels (in, out) <-> (out, in),
GroupNorm scale <-> weight; the class embedding table is not transposed.
Module paths map to the original PyTorch implementation's names (the same
mapping as the JAX package's export tool).  One table of (flax module
path, torch module name, kind) entries per model serves both directions.

A trainer's optimizer state is the `to_state_dict` form of the JAX
trainers' `optax.chain(clip_by_global_norm, adam(schedule))` state: Adam's
`mu`/`nu` trees map to torch's `exp_avg`/`exp_avg_sq` through the model's
parameter table, and both `count`s are the number of updates.  The
discriminator's BatchNorm running statistics are flax's `batch_stats`.
"""

from __future__ import annotations

import re
from typing import Iterator, Mapping

import numpy as np
import torch

from ..models.layers import sinusoid_factor

Entry = tuple[tuple[str, ...], str, str]  # (flax module path, torch name, kind)


def _to_torch(kind: str, leaves: Mapping) -> dict[str, np.ndarray]:
    if kind == "conv":
        return {"weight": np.asarray(leaves["kernel"]).transpose(3, 2, 0, 1),
                "bias": leaves["bias"]}
    if kind == "dense":
        return {"weight": np.asarray(leaves["kernel"]).T, "bias": leaves["bias"]}
    return {"weight": leaves["scale"], "bias": leaves["bias"]}  # norm


def _to_flax(kind: str, weight: np.ndarray, bias: np.ndarray) -> dict[str, np.ndarray]:
    if kind == "conv":
        return {"kernel": weight.transpose(2, 3, 1, 0), "bias": bias}
    if kind == "dense":
        return {"kernel": weight.T, "bias": bias}
    return {"scale": weight, "bias": bias}


def _attn(fp: tuple, tp: str) -> Iterator[Entry]:
    yield fp + ("norm", "norm"), f"{tp}.groupnorm", "norm"
    for name in ("to_q", "to_k", "to_v", "out_proj"):
        yield fp + (name, "dense"), f"{tp}.{name}", "dense"


def _block(fp: tuple, tp: str, n_layers: int) -> Iterator[Entry]:
    for j in range(n_layers):
        for half in ("first", "second"):
            yield fp + (f"{half}_half_{j}", "norm", "norm"), f"{tp}.{half}_halfs.{j}.layers.0", "norm"
            yield fp + (f"{half}_half_{j}", "conv", "conv"), f"{tp}.{half}_halfs.{j}.layers.2", "conv"
        yield fp + (f"time_proj_{j}", "dense"), f"{tp}.time_projs.{j}.1", "dense"
        yield fp + (f"residual_{j}", "conv"), f"{tp}.residuals.{j}", "conv"
        yield from _attn(fp + (f"attn_{j}",), f"{tp}.self_attns.{j}")


def _unet_entries(n_down: int, n_mid: int, n_layers: int) -> list[Entry]:
    entries: list[Entry] = [
        (("time_embedding", "fc1", "dense"), "time_embedding.embeddings.0", "dense"),
        (("time_embedding", "fc2", "dense"), "time_embedding.embeddings.2", "dense"),
        (("in_conv", "conv"), "in_conv", "conv"),
        (("out_norm", "norm"), "out_conv.0", "norm"),
        (("out_conv", "conv"), "out_conv.2", "conv"),
    ]
    for i in range(n_down):
        entries += _block((f"down_block_{i}",), f"down_blocks.{i}", n_layers)
        entries.append(((f"downsample_{i}", "down", "conv"), f"downsamples.{i}.down", "conv"))
    for i in range(n_mid):
        entries += _block((f"mid_block_{i}",), f"mid_blocks.{i}", n_layers)
    for i in range(n_down):
        entries += _block((f"up_block_{i}",), f"ups.{i}", n_layers)
        entries.append(((f"upsample_{i}", "up_conv", "conv"), f"upsamples.{i}.conv", "conv"))
    return entries


def _count(keys, pattern: str) -> int:
    rx = re.compile(pattern)
    return len({m.group(1) for k in keys if (m := rx.match(k))})


def _get(tree: Mapping, path: tuple) -> Mapping:
    for p in path:
        tree = tree[p]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _tensors(arrays: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in arrays.items()}


def _numpy(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Host copies, never views: a trainer's asynchronous save serializes
    them while the next step updates the tensors in place."""
    return {k: v.detach().to("cpu", torch.float32, copy=True).numpy() for k, v in state.items()}


def unet_state_dict(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """UNet flax params (nested dicts of arrays) -> the port's state dict."""
    n_down = _count(flax_params, r"down_block_(\d+)$")
    n_mid = _count(flax_params, r"mid_block_(\d+)$")
    n_layers = _count(flax_params["down_block_0"], r"first_half_(\d+)$")
    out = {}
    for fp, tp, kind in _unet_entries(n_down, n_mid, n_layers):
        for leaf, val in _to_torch(kind, _get(flax_params, fp)).items():
            out[f"{tp}.{leaf}"] = val
    out["class_embedding.weight"] = flax_params["class_embedding"]
    time_dim = np.asarray(flax_params["class_embedding"]).shape[1]
    out["time_embedding.factor"] = sinusoid_factor(time_dim).numpy()
    return _tensors(out)


def unet_flax_params(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's UNet state dict -> flax params of numpy fp32 arrays."""
    state = _numpy(state)
    n_down = _count(state, r"down_blocks\.(\d+)\.")
    n_mid = _count(state, r"mid_blocks\.(\d+)\.")
    n_layers = _count(state, r"down_blocks\.0\.first_halfs\.(\d+)\.")
    params: dict = {"class_embedding": state["class_embedding.weight"]}
    for fp, tp, kind in _unet_entries(n_down, n_mid, n_layers):
        _put(params, fp, _to_flax(kind, state[f"{tp}.weight"], state[f"{tp}.bias"]))
    return params


def adam_tree(step: int, mu: Mapping, nu: Mapping, clipped: bool) -> dict:
    """A trainer's optax state tree at `step` updates from Adam's moments
    `mu`, `nu` as flax trees shaped like the parameters.  `clipped`: the
    chain starts with clip_by_global_norm, whose state is empty."""
    adam = {"count": np.asarray(step, dtype=np.int32), "mu": mu, "nu": nu}
    inner = {"0": adam, "1": {"count": np.asarray(step, dtype=np.int32)}}
    return {"0": {}, "1": inner} if clipped else inner


def adam_moments(tree: Mapping) -> tuple[int, Mapping, Mapping]:
    """-> (count, mu, nu) of a trainer's optax state tree, clipped or not;
    the moments as flax trees shaped like the parameters."""
    adam = (tree if "mu" in tree["0"] else tree["1"])["0"]
    return int(np.asarray(adam["count"])), adam["mu"], adam["nu"]


# The PatchGAN: flax `conv_{i}` (HWIO kernel, bias on the first and last)
# and `bn_{i}` (scale, bias; batch_stats mean, var) <-> torch `convs.{i}`
# and `norms.{i}` (weight, bias; running_mean, running_var).


def disc_state_dict(params: Mapping, batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """Discriminator flax params (and batch_stats) -> the port's state dict
    (parameters, and the running statistics when `batch_stats` is given)."""
    out = {}
    for name, leaves in params.items():
        kind, i = name.rsplit("_", 1)
        if kind == "conv":
            out[f"convs.{i}.weight"] = np.asarray(leaves["kernel"]).transpose(3, 2, 0, 1)
            if "bias" in leaves:
                out[f"convs.{i}.bias"] = leaves["bias"]
        else:
            out[f"norms.{i}.weight"], out[f"norms.{i}.bias"] = leaves["scale"], leaves["bias"]
    for name, leaves in (batch_stats or {}).items():
        i = name.rsplit("_", 1)[1]
        out[f"norms.{i}.running_mean"], out[f"norms.{i}.running_var"] = leaves["mean"], leaves["var"]
    return _tensors(out)


def disc_flax_params(state: Mapping[str, torch.Tensor]) -> dict:
    """The discriminator's parameters (keyed like `named_parameters`; any
    running statistics are skipped) -> flax params of numpy fp32 arrays."""
    params: dict = {}
    for key, val in _numpy(state).items():
        group, i, leaf = key.split(".")
        if group == "convs":
            _put(params, (f"conv_{i}", "kernel" if leaf == "weight" else "bias"),
                 val.transpose(2, 3, 1, 0) if leaf == "weight" else val)
        elif leaf in ("weight", "bias"):
            _put(params, (f"bn_{i}", "scale" if leaf == "weight" else "bias"), val)
    return params


def disc_flax_stats(state: Mapping[str, torch.Tensor]) -> dict:
    """The discriminator's running statistics -> flax batch_stats."""
    state = _numpy(state)
    return {f"bn_{k.split('.')[1]}": {"mean": state[k], "var": state[k[:-len("mean")] + "var"]}
            for k in state if k.endswith(".running_mean")}


# VAE trunks: flax `layers_{i}` <-> torch `{encoder.down|decoder.up}.{i}`,
# each index's kind sniffed from its parameter names.
_RESIDUAL = [(("norm1", "norm"), "branch.0", "norm"), (("conv1", "conv"), "branch.2", "conv"),
             (("norm2", "norm"), "branch.3", "norm"), (("conv2", "conv"), "branch.5", "conv")]
_SHORTCUT = (("shortcut", "conv"), "residual_wrapper", "conv")


def _layer_entries(kind: str, shortcut: bool) -> list[tuple[tuple, str, str]]:
    """(flax sub-path, torch suffix, leaf kind) of one trunk layer."""
    if kind == "residual":
        return _RESIDUAL + ([_SHORTCUT] if shortcut else [])
    if kind == "attention":
        return [(fp, tp[1:], k) for fp, tp, k in _attn((), "")]
    return {"downsample": [(("down", "conv"), "down", "conv")],
            "upsample": [(("up_conv", "conv"), "conv", "conv")],
            "conv": [(("conv",), "", "conv")],
            "norm": [(("norm",), "", "norm")]}[kind]


def _flax_layer_kind(layer: Mapping) -> tuple[str, bool]:
    for key, kind in (("norm1", "residual"), ("to_q", "attention"), ("down", "downsample"),
                      ("up_conv", "upsample"), ("conv", "conv"), ("norm", "norm")):
        if key in layer:
            return kind, "shortcut" in layer
    raise ValueError(f"unrecognised VAE trunk layer with keys {sorted(layer)}")


def _torch_layer_kind(state: Mapping[str, np.ndarray], p: str) -> tuple[str, bool]:
    for suffix, kind in (("branch.0", "residual"), ("to_q", "attention"), ("down", "downsample"),
                         ("conv", "upsample")):
        if f"{p}.{suffix}.weight" in state:
            return kind, f"{p}.residual_wrapper.weight" in state
    return ("conv" if state[f"{p}.weight"].ndim == 4 else "norm"), False


def _vae_entries_from_flax(params: Mapping) -> list[Entry]:
    entries = []
    for trunk, tname in (("encoder", "encoder.down"), ("decoder", "decoder.up")):
        for name, layer in params[trunk].items():
            i = int(name[len("layers_"):])
            for fp, suffix, kind in _layer_entries(*_flax_layer_kind(layer)):
                entries.append(((trunk, name) + fp, f"{tname}.{i}" + (f".{suffix}" if suffix else ""), kind))
    return entries


def _vae_entries_from_torch(state: Mapping[str, np.ndarray]) -> list[Entry]:
    entries = []
    for trunk, tname in (("encoder", "encoder.down"), ("decoder", "decoder.up")):
        for i in sorted({int(m.group(1)) for k in state
                         if (m := re.match(re.escape(tname) + r"\.(\d+)\.", k))}):
            p = f"{tname}.{i}"
            for fp, suffix, kind in _layer_entries(*_torch_layer_kind(state, p)):
                entries.append(((trunk, f"layers_{i}") + fp, p + (f".{suffix}" if suffix else ""), kind))
    return entries


_CODEBOOK = (("embeddings", "codebook.embeddings.weight"),
             ("ema_cluster_size", "codebook.ema_cluster_size"),
             ("ema_w", "codebook.ema_w"))


def vae_state_dict(flax_variables: Mapping) -> dict[str, torch.Tensor]:
    """VAE flax variables {'params'[, 'codebook']} -> the port's state dict."""
    params = flax_variables["params"]
    out = {}
    for fp, tp, kind in _vae_entries_from_flax(params):
        for leaf, val in _to_torch(kind, _get(params, fp)).items():
            out[f"{tp}.{leaf}"] = val
    if "codebook" in flax_variables:
        cb = flax_variables["codebook"]
        cb = cb.get("codebook", cb)
        for fname, tname in _CODEBOOK:
            out[tname] = cb[fname]
    return _tensors(out)


def vae_flax_variables(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's VAE state dict -> flax variables of numpy fp32 arrays."""
    state = _numpy(state)
    params: dict = {}
    for fp, tp, kind in _vae_entries_from_torch(state):
        _put(params, fp, _to_flax(kind, state[f"{tp}.weight"], state[f"{tp}.bias"]))
    variables = {"params": params}
    if "codebook.embeddings.weight" in state:
        variables["codebook"] = {"codebook": {f: state[t] for f, t in _CODEBOOK}}
    return variables
