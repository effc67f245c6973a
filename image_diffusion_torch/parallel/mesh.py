"""Meshes, process groups and the row layout of data parallelism.

The port runs on more than one device in the JAX package's two ways:

  * the trainers run one process per card under a launcher (`torchrun`),
    which exports RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/PORT.
    `initialize_distributed()` joins the process group (NCCL by default,
    gloo only when asked or on the CPU) and `make_mesh()` lays the ranks out
    as a `DeviceMesh` with dims ("data", "model").  Each rank loads and
    computes only its rows of the global batch (`rank_rows`), draws its
    randomness at the global batch's shape and keeps its rows
    (`global_row_draw`), and averages gradients and metrics over the data
    group with explicit all-reduces (`all_reduce_mean_`) before the
    optimizer clips them by their global norm;
  * the sampling CLIs run one process over a list of local devices
    (`make_mesh(devices=)`, `shard_devices`): the pipeline holds a replica
    of the weights on each and samples each device's rows of the padded
    batch there.

Only rank 0 writes checkpoints, metrics and figures
(`core.is_main_process`).  The attention kernels run on every rank and
every shard: nothing is gated off on more than one device.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import resolve_device

BUCKET_BYTES = 25 * 2**20  # largest flat buffer one all-reduce of `all_reduce_mean_` sends


def initialize_distributed(device: str | torch.device = "cuda",
                           backend: str | None = None) -> torch.device:
    """Join the launcher's process group -> the device this process computes on.

    A plain launch (no WORLD_SIZE in the environment) stays single-process
    and returns `device`.  Under a launcher, a CUDA `device` without an
    index becomes `cuda:LOCAL_RANK`, and the group's backend is `backend`:
    "nccl" by default on the card, "gloo" on the CPU or when asked.  In
    such a configured environment a failure to join is fatal: carrying on
    would train WORLD_SIZE independent runs that write one checkpoint path.
    NCCL refuses two ranks on one card; they raise here, naming the ranks,
    rather than at the first collective (gloo, which allows it, must be
    asked for)."""
    dev = torch.device(device)
    if not os.environ.get("WORLD_SIZE"):
        return resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs CUDA devices, not {dev}; use gloo on the CPU")
    if dev.type == "cuda":
        resolve_device(dev)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {os.environ.get('RANK')}: {dev} is not among the "
                f"{torch.cuda.device_count()} visible card(s); launch at most one rank per card")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        try:
            dist.init_process_group(backend)
        except Exception as e:
            raise RuntimeError(
                f"torch.distributed.init_process_group({backend!r}) failed in a configured "
                f"multi-process launch (WORLD_SIZE={os.environ['WORLD_SIZE']}): {e}") from e
    if dist.get_backend() == "nccl":
        _refuse_shared_cards(dev)
    return dev


def _refuse_shared_cards(dev: torch.device) -> None:
    """Raise if two ranks of the group compute on one card (NCCL's
    "duplicate GPU"), comparing (host, card UUID) over a gloo side group."""
    me = f"{socket.gethostname()}/{torch.cuda.get_device_properties(dev).uuid}"
    cards: list = [None] * dist.get_world_size()
    dist.all_gather_object(cards, me, group=dist.new_group(backend="gloo"))
    first: dict[str, int] = {}
    for rank, card in enumerate(cards):
        if card in first:
            raise RuntimeError(
                f"ranks {first[card]} and {rank} would share one card ({card}) under NCCL, "
                "which refuses it; give each rank its own card or use the gloo backend")
        first[card] = rank


def mesh_shape(n: int, data: int | None = None, model: int = 1) -> tuple[int, int]:
    """(data, model) over `n` devices, by the JAX package's `make_mesh`
    rules: data defaults to n // model; a derived mesh that leaves devices
    out raises, an explicit smaller one is allowed, a larger one raises."""
    explicit_data = data is not None
    if data is None:
        data = n // model
    if data * model < n and not explicit_data:
        # data was derived as n // model: a silent partial mesh would mask a
        # misconfiguration (e.g. model=3 on 8 cards)
        raise ValueError(f"model={model} does not divide {n} devices; pass data= "
                         "explicitly to use a partial mesh")
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} devices")
    return data, model


@dataclass(frozen=True)
class Mesh:
    """A ("data", "model") mesh.  In one process, `devices` lists its
    devices data-major; under a process group, `device_mesh` lays out the
    ranks and `devices` is empty."""

    data: int
    model: int
    devices: tuple[torch.device, ...] = ()
    device_mesh: "dist.device_mesh.DeviceMesh | None" = None

    @property
    def size(self) -> int:
        return self.data * self.model

    def group(self, dim: str) -> dist.ProcessGroup:
        """The process group of this rank along `dim` ("data" or "model")."""
        return self.device_mesh.get_group(dim)

    def coordinate(self, dim: str) -> int:
        """This rank's index along `dim`."""
        return self.device_mesh.get_local_rank(dim)

    def data_shard(self, over_model: bool = False) -> "DataShard":
        """This rank's shard of the data: along "data", averaged over the
        data group (ranks along "model" hold the same rows, as in the JAX
        package); or, `over_model` (FSDP), one shard per rank of the
        whole group."""
        if over_model:
            return DataShard(dist.group.WORLD, dist.get_rank(), dist.get_world_size())
        return DataShard(self.group("data"), self.coordinate("data"), self.data)


@dataclass(frozen=True)
class DataShard:
    """Shard `rank` of `world` of every global batch: the rows it holds
    (`rows`), and the group its gradients, losses and batch statistics are
    averaged over."""

    group: dist.ProcessGroup
    rank: int
    world: int

    def rows(self, global_batch: int, grad_accum: int = 1) -> np.ndarray:
        return rank_rows(global_batch, self.world, self.rank, grad_accum)


def trainer_shard(mesh: Mesh | None, batch_size: int, grad_accum: int,
                  over_model: bool = False) -> DataShard | None:
    """A trainer's shard of the data under `mesh` (`Mesh.data_shard`), or
    None without one; raises for an in-process mesh, and when the batch
    does not divide into the shards' micro-batches (`rank_rows`)."""
    if mesh is None:
        return None
    if mesh.device_mesh is None:
        raise ValueError("the trainer takes a process-group mesh (one process per card), "
                         "not an in-process device list")
    shard = mesh.data_shard(over_model)
    shard.rows(batch_size, grad_accum)
    return shard


def make_mesh(data: int | None = None, model: int = 1,
              devices: Sequence[str | torch.device] | None = None,
              device_type: str | None = None) -> Mesh:
    """A ("data", "model") mesh, by `mesh_shape`'s rules.

    With `devices`, or outside a process group: an in-process mesh over
    those devices (default: every visible card, else the CPU), the first
    data * model of them.  Under a process group: a `DeviceMesh` over its
    ranks, which must all be in it; `device_type` places it ("cuda" by
    default under NCCL, else "cpu")."""
    if devices is not None or not dist.is_initialized():
        if devices is None:
            n = torch.cuda.device_count()
            devices = [torch.device("cuda", i) for i in range(n)] if n else ["cpu"]
        devices = [torch.device(d) for d in devices]
        data, model = mesh_shape(len(devices), data, model)
        return Mesh(data, model, tuple(devices[:data * model]))
    world = dist.get_world_size()
    data, model = mesh_shape(world, data, model)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} leaves {world - data * model} of the {world} "
                         "ranks out; launch data x model ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(data, model, device_mesh=init_device_mesh(device_type, (data, model),
                                                          mesh_dim_names=("data", "model")))


def trainer_mesh(data_parallel: int | None, device: torch.device) -> Mesh | None:
    """The training CLIs' mesh: over the process group's ranks when there
    is one (`--data-parallel`, when given, must match them), else None; a
    `--data-parallel` above 1 without a launcher raises SystemExit."""
    if dist.is_initialized():
        return make_mesh(data=data_parallel, device_type=device.type)
    if data_parallel not in (None, 1):
        raise SystemExit(f"--data-parallel {data_parallel}: the trainers run one process per "
                         f"card; launch them with torchrun --nproc-per-node {data_parallel}")
    return None


def shard_devices(device: str | torch.device, data_parallel: int | None = None,
                  every_card: bool = True) -> list[torch.device] | None:
    """The in-process shards of a sampling CLI -> a device list, or None
    for one device.  On the card: the first `data_parallel` visible cards,
    or with `every_card` all of them when there is more than one (the JAX
    CLIs' `device_count() > 1 or --data-parallel`).  On the CPU:
    `data_parallel` shards of the CPU.  Without a card, a CUDA `device`
    raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        devices = [dev] * (data_parallel or 1)
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not data_parallel and not (every_card and len(devices) > 1):
        return None
    return list(make_mesh(data=data_parallel, devices=devices).devices)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def rank_rows(global_batch: int, world: int, rank: int, grad_accum: int = 1) -> np.ndarray:
    """The rows of a global batch that shard `rank` of `world` holds, in
    its order: its share of each of the `grad_accum` global micro-batches
    (micro-batch i is the global rows [i m, (i + 1) m), m = global_batch /
    grad_accum, as the one-device step splits them), so that splitting
    its local batch into `grad_accum` chunks gives each micro-batch's
    rows.  Batch-level statistics (BatchNorm's, the codebook's) then see
    the same rows per micro-batch on any number of shards."""
    if global_batch % (world * grad_accum):
        raise ValueError(
            f"batch_size={global_batch} must divide by data axis ({world}) x grad_accum "
            f"({grad_accum}) -- micro-batches split the per-shard local batch")
    m = global_batch // grad_accum
    s = m // world
    return (np.arange(grad_accum)[:, None] * m + rank * s + np.arange(s)[None, :]).reshape(-1)


def take_rows(x, rows: torch.Tensor | np.ndarray | None):
    """Rows `rows` of a tensor, or of each tensor of a NamedTuple of
    tensors (None fields stay None); everything when `rows` is None."""
    if rows is None or x is None:
        return x
    if isinstance(x, tuple):
        return type(x)(*(take_rows(v, rows) for v in x))
    return x[torch.as_tensor(rows, device=x.device)]


def global_row_draw(draw: Callable[[], object], rows: torch.Tensor | np.ndarray | None):
    """`draw()` at the global batch's shape, then this shard's `rows`.

    The generator makes the one-device draw, so every shard sees the
    values the one-device run does: CUDA's and the CPU's `randn` at a larger
    shape do not repeat a smaller shape's values as a prefix, so drawing at
    a padded shape would not.  Padding is applied after the draw, by rows
    that wrap around (`rows` may repeat indices)."""
    return take_rows(draw(), rows)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Average `tensors` over `group` in place: each run of tensors of one
    device and dtype is packed into flat buffers of at most BUCKET_BYTES,
    all-reduced by SUM and divided by the group's size (SUM, unlike AVG,
    is available on every backend)."""
    world = dist.get_world_size(group)
    runs: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        runs.setdefault((t.device, t.dtype), []).append(t)
    for run in runs.values():
        bucket: list[torch.Tensor] = []
        size = 0
        for t in run + [None]:
            if t is None or (bucket and size + t.numel() * t.element_size() > BUCKET_BYTES):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, group=group)
                flat.div_(world)
                for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += t.numel() * t.element_size()


def all_reduce_mean(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The mean of `t` over `group`, differentiable: the gradient that
    reaches each rank's `t` is the sum over the group of the gradients at
    the mean, over the group's size, so averaging the ranks' parameter
    gradients afterwards gives the gradient of the global batch's loss."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group) / dist.get_world_size(group)


def any_rank(flag: bool, device: torch.device) -> bool:
    """True on every rank when `flag` is true on any (a MAX all-reduce; a
    host sync under NCCL)."""
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_int(value: int, device: torch.device) -> int:
    """Rank 0's `value` on every rank."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return int(t.item())
