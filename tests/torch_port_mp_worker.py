"""Multi-rank worker of tests/test_torch_port_parallel.py: one process of a
gloo group on the CPU, importing only torch, numpy and the port.

    python tests/torch_port_mp_worker.py CASE RANK WORLD DIR

The ranks rendezvous through the file DIR/rendezvous, read their inputs
from DIR/inputs.npz, and each writes DIR/CASE-rank{RANK}.npz, which the
parent test compares with the JAX package and the port's one-process run.
CASE "dp" (2 ranks): diffusion and VAE train steps, BatchNorm, codebook,
data and writes; "fsdp" (4 ranks): the FSDP step and checkpoints against
replicated DP, and a resume that seeds the EMA from a checkpoint
without one."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from image_diffusion_torch.core import checkpoint as ckpt  # noqa: E402
from image_diffusion_torch.core import config as tcfg  # noqa: E402
from image_diffusion_torch.core.logging import BasicLogger  # noqa: E402
from image_diffusion_torch.core.metrics import MetricHolder  # noqa: E402
from image_diffusion_torch.models import build_discriminator, build_unet, build_vae  # noqa: E402
from image_diffusion_torch.models.discriminator import BatchNorm  # noqa: E402
from image_diffusion_torch.models.lpips import LPIPS  # noqa: E402
from image_diffusion_torch.models.vae import Codebook  # noqa: E402
from image_diffusion_torch.ops import schedule as TS  # noqa: E402
from image_diffusion_torch.parallel.fsdp import copy_full_, full  # noqa: E402
from image_diffusion_torch.parallel.mesh import (  # noqa: E402
    DataShard,
    any_rank,
    broadcast_int,
    make_mesh,
    take_rows,
)
from image_diffusion_torch.training import data as tdata  # noqa: E402
from image_diffusion_torch.training.diffusion_trainer import (  # noqa: E402
    DiffusionTrainer,
    Draws,
    Optimizer,
    TrainState,
    make_train_step,
)
from image_diffusion_torch.training.vae_trainer import (  # noqa: E402
    VAEDraws,
    VAETrainState,
    make_vae_train_step,
)
from torch_oracles import random_lpips_state  # noqa: E402

# the tiny configs of tests/test_torch_port_training.py and
# tests/test_torch_port_vae_training.py
UNET = dict(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16, num_res_layers=1,
            num_heads=2, num_groups=4, num_classes=3)
UNET_TRAIN = dict(learning_rate=1e-3, warmup_steps=2, clip_grad=1.0)
VAE = dict(in_channels=3, channels=(8, 16), z_dim=3, enc_num_res_blocks=1, dec_num_res_blocks=1,
           attn_resolutions=(), num_heads=1, init_resolution=16, num_groups=4)
VAE_TRAIN = dict(learning_rate=1e-3, batch_size=4, epochs=1, clip_grad=1.0, precision="fp32",
                 seed=0, log_interval=1, disc_start=1, disc_channels=(8, 16))
VQ = dict(bottleneck="vq", codebook_size=16, codebook_beta=0.25, codebook_gamma=0.99)


def prefixed(inputs, prefix: str) -> dict[str, torch.Tensor]:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith(prefix)}


def unet_step(inputs, shard: DataShard, accum: int, prefix: str = "") -> dict:
    """One fp32 diffusion step from the parent's parameters, batch and
    draws, on this shard's rows."""
    unet = build_unet(tcfg.UNetArch(**UNET), torch.float32, "cpu", param_dtype=torch.float32)
    unet.load_state_dict(prefixed(inputs, "unet0/"))
    state = TrainState(unet, Optimizer(unet.parameters(), **UNET_TRAIN))
    rows = shard.rows(len(inputs["x"]), accum)
    draws = take_rows(Draws(*(torch.from_numpy(inputs[f"draw_{k}"])
                              for k in ("z", "t", "noise", "drop"))), rows)
    step = make_train_step(TS.make_schedule(50), 0.15, True, grad_accum=accum, shard=shard)
    metrics = step(state, torch.from_numpy(inputs["x"][rows]), torch.from_numpy(inputs["c"][rows]),
                   draws)
    out = {f"{prefix}{k}": v.numpy() for k, v in metrics.items()}
    names = [n for n, _ in unet.named_parameters()]
    mu, _ = state.optimizer.moments()
    out.update({f"{prefix}param/{n}": full(p).detach().numpy()
                for n, p in zip(names, state.optimizer.params)})
    out.update({f"{prefix}mu/{n}": full(m).numpy() for n, m in zip(names, mu)})
    return out


def vae_step(inputs, shard: DataShard, bottleneck: str, accum: int) -> dict:
    """One fp32 VAE-GAN step, discriminator active, from the parent's
    variables, images and draws, on this shard's rows."""
    arch = {**VAE, **(VQ if bottleneck == "vq" else {})}
    cfg = tcfg.VAEConfig(tcfg.VAEArch(**arch), tcfg.VAETrainConfig(**VAE_TRAIN, grad_accum=accum))
    vae = build_vae(cfg.arch, torch.float32, "cpu", param_dtype=torch.float32)
    vae.load_state_dict(prefixed(inputs, f"{bottleneck}/vae/"))
    disc = build_discriminator(cfg.train.disc_channels, torch.float32, "cpu")
    disc.load_state_dict(prefixed(inputs, f"{bottleneck}/disc/"))
    for m in [*disc.norms.values(), *([vae.codebook] if bottleneck == "vq" else [])]:
        m.group = shard.group
    lr, clip = cfg.train.learning_rate, cfg.train.clip_grad
    state = VAETrainState(vae, disc, Optimizer(vae.parameters(), lr, cfg.train.warmup_steps, clip),
                          Optimizer(disc.parameters(), lr, 0, clip))
    rows = shard.rows(len(inputs["images"]), accum)
    draws = take_rows(VAEDraws(torch.from_numpy(inputs[f"{bottleneck}/flip"]),
                               torch.from_numpy(inputs[f"{bottleneck}/noise"])), rows)
    lpips = (LPIPS.from_state_dict(random_lpips_state(0)) if bottleneck == "kl" else None)
    metrics = make_vae_train_step(cfg, lpips, shard=shard)(
        state, torch.from_numpy(inputs["images"][rows]), draws, True)
    key = f"{bottleneck}{accum}/"
    out = {f"{key}metric/{k}": v.detach().numpy() for k, v in metrics.items()}
    out.update({f"{key}vae/{k}": v.detach().numpy() for k, v in vae.state_dict().items()})
    out.update({f"{key}disc/{k}": v.detach().numpy() for k, v in disc.state_dict().items()})
    for name, opt, model in (("vae_mu", state.vae_opt, vae), ("disc_mu", state.disc_opt, disc)):
        names = [n for n, _ in model.named_parameters()]
        out.update({f"{key}{name}/{n}": m.numpy() for n, m in zip(names, opt.moments()[0])})
    return out


def dp_case(inputs, rank: int, world: int, out_dir: str) -> dict:
    mesh = make_mesh(data=world)
    shard = mesh.data_shard()
    out = {}
    for accum in (1, 2):
        out.update(unet_step(inputs, shard, accum, prefix=f"unet{accum}/"))
    for bottleneck in ("kl", "vq"):
        for accum in (1, 2):
            out.update(vae_step(inputs, shard, bottleneck, accum))

    # BatchNorm alone: train-mode statistics and the input's gradient
    x = torch.from_numpy(inputs["bn_x"]).requires_grad_(True)
    bn = BatchNorm(4)
    bn.group = shard.group
    rows = shard.rows(len(x))
    y = bn(x[rows])
    (y * torch.from_numpy(inputs["bn_w"])[rows]).sum().backward()
    out.update({"bn/y": y.detach().numpy(), "bn/grad": x.grad.numpy(),
                "bn/running_mean": bn.running_mean.numpy(), "bn/running_var": bn.running_var.numpy()})

    # the codebook's EMA update and perplexity from this shard's tokens
    cb = Codebook(16, 4, 0.99)
    cb.reset_state(torch.Generator().manual_seed(1))
    cb.group = shard.group
    z = torch.from_numpy(inputs["cb_z"])
    _, _, perplexity = cb(z[shard.rows(len(z))], train=True)
    out.update({f"cb/{k}": v.numpy() for k, v in cb.state_dict().items()})
    out["cb/perplexity"] = perplexity.numpy()

    # data: this shard's rows of every batch, at accum 1 and 2, and the dev tail
    ds = tdata.ArrayDataset(inputs["data"])
    for accum in (1, 2):
        rows = [b[0].numpy() for b in tdata.epoch_batches(ds, 4, 123, "cpu", rank, world, accum)]
        out[f"data/accum{accum}"] = np.stack(rows)
    for i, (n_valid, (b,)) in enumerate(tdata.eval_batches(tdata.ArrayDataset(inputs["dev"]), 4,
                                                           "cpu", rank, world)):
        out[f"dev/{i}"] = b.numpy()[:n_valid]

    # agreement: a flag set on one rank, and rank 0's seed
    cpu = torch.device("cpu")
    out["agree"] = np.array([any_rank(rank == 1, cpu), any_rank(False, cpu),
                             broadcast_int(100 + rank, cpu)])

    # writes: every rank saves and logs; rank 0 alone may write
    ckpt.save_checkpoint(os.path.join(out_dir, "w.ckpt"), {"kind": "test"}, 0,
                         tree={"w": np.arange(3.0, dtype=np.float32) + rank})
    saver = ckpt.AsyncSaver()
    saver.save(os.path.join(out_dir, "async.ckpt"), None, 0,
               tree={"w": np.full(2, rank, np.float32)})
    saver.wait()
    logger = BasicLogger(out_dir, "mp", no_mlflow=True, log_interval=1)
    logger.log_metric("probe", float(rank + 1), step=0)
    logger.log_params(rank=rank)
    return out


def fsdp_case(inputs, rank: int, world: int, out_dir: str) -> dict:
    # the same step, replicated over data 4 and sharded over data 2 x model 2
    out = unet_step(inputs, make_mesh(data=world).data_shard(), 1, prefix="dp/")
    mesh = make_mesh(data=2, model=2)
    cfg = tcfg.DiffusionConfig(
        tcfg.UNetArch(**UNET), tcfg.ScheduleConfig(num_steps=50),
        tcfg.DiffusionTrainConfig(**UNET_TRAIN, batch_size=8, epochs=1, precision="fp32", seed=0,
                                  log_interval=1, ema_decay=0.9, checkpoints_dir=out_dir,
                                  logs_dir=out_dir))
    data = tdata.ArrayDataset(inputs["latents"], inputs["labels"])

    def trainer(**kw):
        return DiffusionTrainer(cfg, data, BasicLogger(out_dir, "f", True, 1), MetricHolder(1),
                                device="cpu", mesh=mesh, param_sharding="fsdp", **kw)

    # the FSDP step through the trainer's own step function
    tr = trainer(run_name="step")
    unet = tr.state.unet
    names = tr.names
    for name, p in zip(names, tr.state.optimizer.params):
        copy_full_(p, torch.from_numpy(inputs[f"unet0/{name}"]))
    shard = tr.shard
    rows = shard.rows(len(inputs["x"]))
    draws = take_rows(Draws(*(torch.from_numpy(inputs[f"draw_{k}"])
                              for k in ("z", "t", "noise", "drop"))), rows)
    step = make_train_step(TS.make_schedule(50), 0.15, True, shard=shard)
    state = TrainState(unet, tr.state.optimizer)  # the trainer's without its EMA
    metrics = step(state, torch.from_numpy(inputs["x"][rows]), torch.from_numpy(inputs["c"][rows]),
                   draws)
    out.update({f"fsdp/{k}": v.numpy() for k, v in metrics.items()})
    mu, _ = state.optimizer.moments()
    out.update({f"fsdp/param/{n}": full(p).detach().numpy()
                for n, p in zip(names, state.optimizer.params)})
    out.update({f"fsdp/mu/{n}": full(m).numpy() for n, m in zip(names, mu)})
    out["fsdp/sharded"] = np.array([sum(isinstance(p, DTensor) for p in state.optimizer.params),
                                    len(names)])

    # an epoch of the trainer (EMA on) writes a checkpoint; a second trainer
    # resumes from it and writes it again unchanged
    tr = trainer(run_name="run")
    tr.train()
    path = os.path.join(out_dir, "run", "unet-epoch-00.ckpt")
    dist.barrier()
    again = trainer(run_name="again", checkpoint=path)
    again.save(0)
    out["resumed_epoch"] = np.array(again.curr_epoch)

    # an epoch without an EMA writes a checkpoint with none; a trainer with
    # one resumes from it and seeds its (sharded) EMA from the parameters
    no_ema = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=None))
    DiffusionTrainer(no_ema, data, BasicLogger(out_dir, "n", True, 1), MetricHolder(1),
                     run_name="no_ema", device="cpu", mesh=mesh, param_sharding="fsdp").train()
    dist.barrier()
    seeded = trainer(run_name="seeded",
                     checkpoint=os.path.join(out_dir, "no_ema", "unet-epoch-00.ckpt"))
    out["ema_seed_max_abs_diff"] = np.array(max(
        float((full(e) - full(p)).abs().max())
        for e, p in zip(seeded.state.ema, seeded.state.optimizer.params)))
    out["ema_seed_sharded"] = np.array(sum(isinstance(e, DTensor) for e in seeded.state.ema))
    return out


def main():
    case, rank, world, work = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'rendezvous')}",
                            rank=rank, world_size=world)
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    out = {"dp": dp_case, "fsdp": fsdp_case}[case](inputs, rank, world, work)
    np.savez(os.path.join(work, f"{case}-rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"DONE {rank}", flush=True)


if __name__ == "__main__":
    main()
