"""FSDP: parameter, gradient and optimizer-state sharding over the mesh's
"model" axis, replicated over "data".

The JAX package annotates each parameter with a sharding that splits its
largest "model"-divisible axis (`fsdp_spec`) and lets GSPMD insert the
gathers.  The port applies FSDP2 (`torch.distributed.fsdp.fully_shard`) on
the mesh, with `fsdp_spec` of each parameter's own (torch-layout) shape as
its placement.  FSDP2 has no replicated placement: a parameter that
`fsdp_spec` replicates is left out of FSDP (`ignored_params`), kept whole
on every rank, and its gradient is averaged by the trainer's all-reduce.
FSDP2 gathers the whole weights for each rank's forward, so every rank
computes its own rows, and it averages the other gradients over all
data x model ranks.  Sharded tensors are DTensors: `local` is this rank's
shard, `full` gathers the whole tensor (a collective: every rank calls it),
and `copy_full_` writes a whole tensor into its shard."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from .mesh import Mesh


def fsdp_spec(shape: tuple[int, ...], model_size: int) -> int | None:
    """The axis to shard over a model axis of `model_size`: the largest one
    that it divides (the first of equals), or None to replicate."""
    if model_size <= 1 or not shape:
        return None
    candidates = [i for i, d in enumerate(shape) if d % model_size == 0 and d >= model_size]
    if not candidates:
        return None
    return max(candidates, key=lambda i: shape[i])


def shard_params_fsdp(mesh: Mesh, module: nn.Module) -> set[nn.Parameter]:
    """Shard `module`'s parameters over the mesh's "model" axis (FSDP2 on
    the ("data", "model") mesh: replicated over "data") -> the parameters
    that stay whole (`fsdp_spec` None), whose gradients the caller
    averages."""
    from torch.distributed.fsdp import fully_shard

    whole = {p for p in module.parameters() if fsdp_spec(tuple(p.shape), mesh.model) is None}
    with torch.no_grad():  # FSDP2 shards contiguous tensors only (not channels_last weights)
        for p in module.parameters():
            p.data = p.data.contiguous()
    device_mesh = mesh.device_mesh if mesh.data > 1 else mesh.device_mesh["model"]
    fully_shard(module, mesh=device_mesh,
                shard_placement_fn=lambda p: Shard(fsdp_spec(tuple(p.shape), mesh.model)),
                ignored_params=whole or None)
    return whole


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (its storage), or `t` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (gathered over its shard group: every
    rank calls it), or `t`.  `fsdp_spec` shards one axis that the group
    divides, so the shards are equal and in rank order; they are gathered by
    the process group's own all-gather, which every backend has (DTensor's
    `full_tensor` takes the functional collectives, which gloo on CUDA
    tensors does not carry)."""
    if not isinstance(t, DTensor):
        return t
    (mesh_dim, placement), = [(i, p) for i, p in enumerate(t.placements) if p.is_shard()]
    group = t.device_mesh.get_group(mesh_dim)
    shard = t.to_local().detach().movedim(placement.dim, 0).contiguous()
    out = shard.new_empty((dist.get_world_size(group) * shard.shape[0], *shard.shape[1:]))
    dist.all_gather_into_tensor(out, shard, group=group)
    return out.movedim(0, placement.dim)


@torch.no_grad()
def copy_full_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write the whole tensor `src` into `dst`, or into this rank's shard
    when `dst` is a DTensor (no communication: every rank holds `src`)."""
    if isinstance(dst, DTensor):
        src = distribute_tensor(src.to(dst.device, dst.dtype), dst.device_mesh, dst.placements,
                                src_data_rank=None)
    local(dst).copy_(local(src))


def sharded_global_norm(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup) -> torch.Tensor:
    """sqrt of the sum of squares of every element of the whole tensors,
    some sharded over `group` (the "model" axis), as a 0-d tensor: the
    shards' squares summed over the group, the whole tensors' added once."""
    sharded = [local(t).float() for t in tensors if isinstance(t, DTensor)]
    whole = [t.float() for t in tensors if not isinstance(t, DTensor)]
    sq = torch.stack([torch.sum(t * t) for t in sharded]).sum()
    dist.all_reduce(sq, group=group)
    if whole:
        sq = sq + torch.stack([torch.sum(t * t) for t in whole]).sum()
    return torch.sqrt(sq)
