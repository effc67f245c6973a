"""Stage-2 denoiser training: eps-prediction MSE on pre-extracted latents.

The step reparametrizes the stored KL latents (mean || log_var), draws
timesteps and diffusion noise, q-samples, drops the class condition with
probability `cond_drop_prob`, runs the UNet in the compute dtype (bf16 for
the shipped config) on fp32 parameters, takes the fp32 MSE, clips the
gradients by global norm and applies Adam; it keeps the loss and the
pre-clip gradient norm on the device until the metric holder flushes.

The optimizer is the JAX trainer's `optax.chain(clip_by_global_norm(clip),
adam(warmup_schedule))`: Adam(0.9, 0.999, eps 1e-8 outside the square
root), its learning rate the schedule evaluated at the update count before
the update, and clipping by optax's formula (g / |g| * clip when |g| >=
clip, with no epsilon).  Trainer checkpoints are written and read in the
JAX trainer's layout, so a run saved by either package resumes in the
other.

The config's `remat` policy ("none", "dots" or "full") is the UNet's (see
`models/unet.py`).  With previews on, every `preview_freq` epochs a small
CFG grid is sampled from the current weights (the EMA's when kept) through
a frozen VAE and logged as a figure (`Preview`).  With `debug_nans`, the
backward runs under autograd's anomaly detection and a loss or gradient
norm that is not finite raises `FloatingPointError` naming the step.

Under a mesh (`parallel.mesh`, one process per card) every rank takes its
rows of each global batch, draws the step's randomness at the global
batch's shape and keeps its rows, and averages the loss and the gradients
over the data group with an explicit all-reduce before the global-norm
clip, the JAX package's pmean: the step equals the one-device step up to
fp reassociation, at any `grad_accum`.  With `param_sharding="fsdp"` the
UNet, its gradients, Adam's moments and the EMA are sharded over the
"model" axis (`parallel.fsdp`), every rank takes its own rows, and the
clip uses the whole gradient's norm.  Checkpoints gather the whole state on
every rank and are written by rank 0 alone, as are metrics and previews.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..compat.from_jax import adam_moments, adam_tree, unet_flax_params, unet_state_dict
from ..core import checkpoint as ckpt
from ..core import is_main_process, resolve_device
from ..core.config import DiffusionConfig
from ..core.logging import BasicLogger
from ..core.metrics import MetricHolder
from ..core.plotting import plot_cfg_grid, pyplot
from ..core.preemption import PreemptionGuard
from ..core.profiling import StepTimer, span
from ..core.progress import progress
from ..core.rng import epoch_seed, numpy_seed, root_seed, step_generator
from ..models import build_unet
from ..models.io import read_vae
from ..models.unet import UNet
from ..models.vae import VAE
from ..ops import schedule as S
from ..parallel.fsdp import copy_full_, full, local, shard_params_fsdp, sharded_global_norm
from ..parallel.mesh import (DataShard, Mesh, all_reduce_mean_, any_rank, broadcast_int,
                             global_row_draw, trainer_shard)
from .data import ArrayDataset, epoch_batches, steps_per_epoch


def check_finite(values: Mapping[str, torch.Tensor]) -> None:
    """Raise FloatingPointError naming every value that is not finite (a
    host sync per value; `--debug-nans` only)."""
    bad = [name for name, v in values.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise FloatingPointError("non-finite " + ", ".join(bad))


def run_step(train_step: Callable[..., dict], debug_nans: bool, where: str, *args,
             **kwargs) -> dict:
    """`train_step(*args, **kwargs)`.  With `debug_nans` it runs under
    autograd's anomaly detection (which names a backward function that
    returns NaN), its metrics are checked (`check_finite`), and a
    FloatingPointError from either check names `where`."""
    if not debug_nans:
        return train_step(*args, **kwargs)
    try:
        with torch.autograd.detect_anomaly():
            metrics = train_step(*args, **kwargs)
        check_finite(metrics)
    except FloatingPointError as e:
        raise FloatingPointError(f"{where}: {e}") from e
    return metrics


def preempted(guard: PreemptionGuard, shard: DataShard | None, flush: bool,
              device: torch.device) -> bool:
    """Whether a training loop stops on SIGTERM after this step.  Under a
    mesh the ranks agree at flush steps, where the loop syncs anyway, so
    that all of them save (a collective under FSDP) after the same step."""
    if shard is None:
        return guard.triggered
    return flush and any_rank(guard.triggered, device)


def warmup_schedule(learning_rate: float, warmup_steps: int) -> Callable[[int], float]:
    """lr/100 -> lr linearly over `warmup_steps` updates, then constant."""
    min_lr = learning_rate / 100.0

    def schedule(step: int) -> float:
        frac = min(step / max(warmup_steps, 1), 1.0)
        warm = min_lr + (learning_rate - min_lr) * frac
        return warm if step < warmup_steps else learning_rate

    return schedule


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads: list[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax's clip_by_global_norm in place: g unchanged when norm <
    max_norm, else (g / norm) * max_norm.  No host sync.  Sharded
    gradients are scaled shard by shard."""
    grads = [local(g) for g in grads]
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm).to(norm.dtype))


class Optimizer:
    """Gradient clipping, then Adam at the warmup schedule's learning rate,
    over a list of fp32 parameters (their `.grad`s are the input).  `count`
    is the number of updates applied.  `grad_norm` computes the global norm
    the clip uses (`global_norm`; FSDP passes the sharded one)."""

    def __init__(self, params, learning_rate: float, warmup_steps: int,
                 clip_grad: float | None,
                 grad_norm: Callable[[list[torch.Tensor]], torch.Tensor] = global_norm):
        self.params = list(params)
        self.schedule = warmup_schedule(learning_rate, warmup_steps)
        self.clip_grad = clip_grad
        self.grad_norm = grad_norm
        # sharded (DTensor) and whole parameters in separate groups: Adam's
        # foreach kernels take one kind of tensor at a time
        groups = [[p for p in self.params if isinstance(p, DTensor)],
                  [p for p in self.params if not isinstance(p, DTensor)]]
        self.adam = torch.optim.Adam([{"params": g} for g in groups if g], lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def grads(self) -> list[torch.Tensor]:
        """Every parameter's gradient, a zero one where the parameter got
        none (unused, as in JAX)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def step(self) -> torch.Tensor:
        """Clip and apply the gradients; -> their global norm before the clip."""
        with span("optimizer"):
            grads = self.grads()
            norm = self.grad_norm(grads)
            if self.clip_grad is not None:
                clip_by_global_norm_(grads, norm, self.clip_grad)
            for group in self.adam.param_groups:
                group["lr"] = self.schedule(self.count)
            self.adam.step()
            self.count += 1
            return norm

    def moments(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Adam's (first, second) moments per parameter, zero before the
        first update."""
        mu, nu = [], []
        for p in self.params:
            st = self.adam.state.get(p)
            mu.append(st["exp_avg"] if st else torch.zeros_like(p))
            nu.append(st["exp_avg_sq"] if st else torch.zeros_like(p))
        return mu, nu

    @torch.no_grad()
    def load(self, count: int, mu: list[torch.Tensor], nu: list[torch.Tensor]) -> None:
        """Set the update count and the moments (whole tensors on any
        device; a sharded parameter takes its shard)."""
        self.count = count
        for p, m, v in zip(self.params, mu, nu, strict=True):
            exp_avg, exp_avg_sq = torch.empty_like(p), torch.empty_like(p)
            copy_full_(exp_avg, m)
            copy_full_(exp_avg_sq, v)
            self.adam.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                                  "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}


@dataclass
class TrainState:
    """The model, its optimizer and the EMA of its parameters (or None).
    The train step updates all three in place."""

    unet: UNet
    optimizer: Optimizer
    ema: list[torch.Tensor] | None = None

    @property
    def step(self) -> int:
        return self.optimizer.count


class Draws(NamedTuple):
    """The random inputs of one step at full-batch shape: KL reparam noise
    (B, H, W, z) or None, timesteps (B,) in [0, T), diffusion noise
    (B, H, W, z), and uniform [0, 1) condition-dropout draws (B,)."""

    z_noise: torch.Tensor | None
    t: torch.Tensor
    noise: torch.Tensor
    drop: torch.Tensor


def draw(generator: torch.Generator, x_shape, num_steps: int, reparametrize: bool) -> Draws:
    """The step's draws from `generator`, on its device."""
    B, H, W, C = x_shape
    z = (B, H, W, C // 2 if reparametrize else C)
    kw = dict(generator=generator, device=generator.device)
    z_noise = torch.randn(z, **kw) if reparametrize else None
    t = torch.randint(0, num_steps, (B,), **kw)
    return Draws(z_noise, t, torch.randn(z, **kw), torch.rand((B,), **kw))


def make_train_step(sched: S.Schedule, cond_drop_prob: float, reparametrize: bool,
                    ema_decay: float | None = None, grad_accum: int = 1,
                    debug_nans: bool = False, shard: DataShard | None = None):
    """-> train_step(state, x, c, draws) -> {"unet/loss", "unet/grad"}, 0-d
    device tensors.  `x` holds stored latents (B, H, W, 2z for KL), `c`
    class ids; `draws` is a `Draws` or a generator to draw them from.

    grad_accum > 1 splits the full-batch draws into micro-batches whose
    gradients are summed and divided once; the MSE's gradient is linear, so
    the update equals the single-shot step's up to fp reassociation.
    `debug_nans` checks each micro-batch's loss before its backward
    (`check_finite`).

    With a `shard`, `x` and `c` are its rows of the global batch
    (`DataShard.rows`), a generator's draws are made at the global batch's
    shape and cut to those rows (`draws` given are this shard's), and the
    loss and the gradients FSDP does not reduce are averaged over the
    shard's group before the clip."""

    def train_step(state: TrainState, x: torch.Tensor, c: torch.Tensor, draws) -> dict:
        with span("train.step", rows=x.shape[0]):
            return step(state, x, c, draws)

    def step(state: TrainState, x: torch.Tensor, c: torch.Tensor, draws) -> dict:
        if isinstance(draws, torch.Generator):
            gen, world = draws, 1 if shard is None else shard.world
            shape = (x.shape[0] * world, *x.shape[1:])
            draws = global_row_draw(lambda: draw(gen, shape, sched.num_steps, reparametrize),
                                    None if shard is None else shard.rows(shape[0], grad_accum))
        x = x.float()
        if reparametrize:
            x = VAE.reparametrize(x, draws.z_noise)
        c = c.long()
        B = x.shape[0]
        x_noise = S.q_sample(sched, x, draws.noise, draws.t)
        mask = (draws.drop > cond_drop_prob)[:, None].float()

        opt = state.optimizer
        opt.zero_grad()
        a, m = grad_accum, B // grad_accum
        with torch.enable_grad():
            for i in range(a):
                rows = slice(i * m, (i + 1) * m)
                with span("train.forward"):
                    eps_hat = state.unet(x_noise[rows], draws.t[rows], c[rows], mask[rows])
                    loss = torch.mean((eps_hat.float() - draws.noise[rows]) ** 2)
                if debug_nans:
                    check_finite({"unet/loss": loss})
                with span("train.backward"):
                    loss.backward()
                total = loss.detach() if i == 0 else total + loss.detach()
        if a > 1:
            total = total / a
            torch._foreach_div_([local(p.grad) for p in opt.params if p.grad is not None],
                                float(a))
        if shard is not None:
            # equal shards: the mean of their means is the global mean
            # (FSDP has averaged the sharded gradients already)
            all_reduce_mean_([total] + [g for g in opt.grads() if not isinstance(g, DTensor)],
                             shard.group)
        grad_norm = opt.step()
        if ema_decay:
            with torch.no_grad():
                ema = [local(e) for e in state.ema]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [local(p) for p in opt.params], alpha=1.0 - ema_decay)
        return {"unet/loss": total, "unet/grad": grad_norm}

    return train_step


class Preview:
    """In-training sample previews: a pipeline built once from a frozen VAE
    file and the UNet's architecture, whose UNet takes the trainer's
    current weights in place before each grid.  A grid is every class at
    one guidance scale, DPM-Solver++ over `steps` steps, its noise from the
    pipeline's own generator seeded with the epoch, so the training draws
    never move.  The pipeline only samples: its host copies of the weights
    (what `to_checkpoint` would write) stay those it was built with."""

    def __init__(self, vae_path: str, config: DiffusionConfig,
                 unet_state: Mapping[str, torch.Tensor], steps: int = 20, scale: float = 3.0,
                 device: str | torch.device = "cuda"):
        from ..pipelines.diffusion import DiffusionPipeline

        vae_arch, vae_state = read_vae(vae_path)
        self.classes = [str(i) for i in range(config.arch.num_classes)]
        self.steps, self.scale = steps, scale
        self.pipe = DiffusionPipeline(vae_arch, vae_state, config.arch, unet_state, config.schedule,
                                      self.classes, dtype=config.train.compute_dtype, device=device)

    @torch.no_grad()
    def images(self, weights: Mapping[str, torch.Tensor], seed: int) -> torch.Tensor:
        """The grid (classes, H, W, 3) in [-1, 1] from the UNet parameters
        `weights` (by name), as `DiffusionPipeline.sample([scale], seed=seed,
        sampler="dpm", num_inference_steps=steps)` gives it."""
        for name, p in self.pipe.unet.named_parameters():
            p.copy_(weights[name])
        return self.pipe.sample([self.scale], seed=seed, sampler="dpm",
                                num_inference_steps=self.steps)


class DiffusionTrainer:
    """Host-side orchestration: epochs, metrics, previews, checkpoints.

    `mesh`: a process-group mesh (`parallel.mesh.make_mesh` after
    `initialize_distributed`, one process per card, `device` this rank's);
    `param_sharding` "replicated" or "fsdp" (the JAX trainer's).  FSDP
    shards over a "model" axis above 1; at 1 it is replicated."""

    def __init__(self, config: DiffusionConfig, train_set: ArrayDataset, logger: BasicLogger,
                 holder: MetricHolder, checkpoint: str | None = None, run_name: str = "unet",
                 device: str | torch.device = "cuda", preview_vae: str | None = None,
                 preview_freq: int = 0, preview_scale: float = 3.0, preview_steps: int = 20,
                 debug_nans: bool = False, mesh: Mesh | None = None,
                 param_sharding: str = "replicated"):
        tc = config.train
        tc.validate_accum()
        if param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"unknown param_sharding {param_sharding!r}; expected 'replicated' "
                             "or 'fsdp'")
        self.cfg = config
        self.train_set = train_set
        self.logger = logger
        self.holder = holder
        self.run_name = run_name
        self.device = resolve_device(device)
        self.fsdp = mesh is not None and param_sharding == "fsdp" and mesh.model > 1
        self.shard = trainer_shard(mesh, tc.batch_size, tc.grad_accum, over_model=self.fsdp)

        # fp32 parameters, compute in the config's dtype; init from seed 0
        self.unet = build_unet(config.arch, dtype=tc.compute_dtype, device=self.device,
                               generator=torch.Generator().manual_seed(0),
                               param_dtype=torch.float32, remat=tc.remat).train()
        self.names = [n for n, _ in self.unet.named_parameters()]
        self.sched = S.make_schedule(config.schedule.num_steps, config.schedule.beta_start,
                                     config.schedule.beta_end, config.schedule.noise_type,
                                     device=self.device)
        n_params = sum(p.numel() for p in self.unet.parameters())
        trees, meta = ckpt.load_checkpoint(checkpoint) if checkpoint is not None else (None, None)
        if trees is not None:
            self.unet.load_state_dict(unet_state_dict(trees["unet"]))

        self.preview, self.preview_freq = None, preview_freq if preview_vae else 0
        if self.preview_freq > 0 and is_main_process():
            pyplot()  # fails here, not at the first preview, without matplotlib
            self.preview = Preview(preview_vae, config, self.unet.state_dict(), preview_steps,
                                   preview_scale, self.device)

        grad_norm = global_norm
        if self.fsdp:
            shard_params_fsdp(mesh, self.unet)
            model_group = mesh.group("model")
            grad_norm = lambda grads: sharded_global_norm(grads, model_group)  # noqa: E731
        optimizer = Optimizer(self.unet.parameters(), tc.learning_rate, tc.warmup_steps,
                              tc.clip_grad, grad_norm)
        ema = [p.detach().clone() for p in optimizer.params] if tc.ema_decay else None
        self.state = TrainState(self.unet, optimizer, ema)
        self.saver = ckpt.AsyncSaver()

        logger.log_console(f"Unet has {n_params:,} params.")
        logger.log_console(f"Train set has {len(train_set)} items.")

        self.curr_epoch = 0
        if trees is not None:
            self._restore(trees, meta)
            logger.log_console(f"Loading model checkpoint from {checkpoint}")
        else:
            logger.log_console("No checkpoint provided. Training from scratch.")

        self.debug_nans = debug_nans
        self.train_step = make_train_step(
            self.sched, tc.cond_drop_prob, reparametrize=(tc.ae_type == "kl"),
            ema_decay=tc.ema_decay, grad_accum=tc.grad_accum, debug_nans=debug_nans,
            shard=self.shard)

    def _named(self, tensors: list[torch.Tensor]) -> dict[str, torch.Tensor]:
        return dict(zip(self.names, tensors, strict=True))

    @torch.no_grad()
    def _restore(self, trees: dict, meta: dict) -> None:
        """The EMA, Adam's moments and counts and the epoch from a
        checkpoint's trees (the parameters were loaded before sharding)."""
        opt = self.state.optimizer
        if self.state.ema is not None:
            # without a saved EMA, seed it from the restored parameters
            # (whole: `copy_full_` takes this rank's shard of them)
            src = unet_state_dict(trees["unet_ema"]) if "unet_ema" in trees else None
            for e, name, p in zip(self.state.ema, self.names, opt.params):
                copy_full_(e, src[name] if src is not None else full(p))
        _, mu, nu = adam_moments(trees["optim"])
        mu, nu = unet_state_dict(mu), unet_state_dict(nu)
        opt.load(int(trees["step"]["step"]), [mu[n] for n in self.names],
                 [nu[n] for n in self.names])
        self.curr_epoch = int(meta["epoch"]) + 1

    @torch.no_grad()
    def save(self, epoch: int, asynchronous: bool = False) -> str:
        """Write the trainer checkpoint (JAX layout) of the current state;
        `asynchronous` copies to the host here and writes on a thread.
        Every rank calls it: under FSDP each takes part in gathering the
        whole state; rank 0 alone writes."""
        path = os.path.join(self.cfg.train.checkpoints_dir, self.run_name,
                            f"unet-epoch-{epoch:02}.ckpt")
        opt = self.state.optimizer
        mu, nu = opt.moments()
        params, ema = opt.params, self.state.ema
        if self.fsdp:  # gather BEFORE the writer gate
            params, mu, nu = ([full(t) for t in ts] for ts in (params, mu, nu))
            ema = None if ema is None else [full(t) for t in ema]
        if not is_main_process():
            return path
        trees = dict(
            unet=unet_flax_params(self._named(params)),
            unet_ema=unet_flax_params(self._named(ema)) if ema is not None else None,
            optim=adam_tree(opt.count, unet_flax_params(self._named(mu)),
                            unet_flax_params(self._named(nu)), clipped=opt.clip_grad is not None),
            step={"step": np.asarray(opt.count, dtype=np.int64)},  # as flax writes it
        )
        if asynchronous:
            self.saver.save(path, self.cfg.arch.to_dict(), epoch, **trees)
        else:
            self.saver.wait()
            ckpt.save_checkpoint(path, self.cfg.arch.to_dict(), epoch, **trees)
        return path

    def train(self) -> None:
        cfg = self.cfg.train
        sc = self.cfg.schedule
        self.logger.log_params(
            lr=cfg.learning_rate, warmup_steps=cfg.warmup_steps,
            cond_drop_prob=cfg.cond_drop_prob,
            scheduler=f"{sc.noise_type} : [{sc.beta_start} - {sc.beta_end}] in {sc.num_steps} steps",
        )
        # the seed offset by the epoch count keeps resumed sub-runs' draws
        # fresh; every rank takes rank 0's
        root = root_seed(cfg.seed, offset=cfg.epochs)
        if self.shard is not None:
            root = broadcast_int(root, self.device)
        spe = steps_per_epoch(self.train_set, cfg.batch_size)
        guard = PreemptionGuard()
        rank, world = (0, 1) if self.shard is None else (self.shard.rank, self.shard.world)

        for epoch in range(self.curr_epoch, cfg.epochs):
            eseed = epoch_seed(root, epoch)
            gen = step_generator(eseed, self.device)
            # the epoch loss averages every step's loss, the tail after the
            # last flush included
            epoch_loss_sum, loss_steps, steps_in_buffer = 0.0, 0, 0
            timer = StepTimer()
            batches = epoch_batches(self.train_set, cfg.batch_size, numpy_seed(eseed),
                                    self.device, rank, world, cfg.grad_accum)
            for step, (x, c) in enumerate(progress(batches, total=spe, desc=f"epoch {epoch}")):
                adjusted_step = epoch * spe + step
                metrics = run_step(self.train_step, self.debug_nans,
                                   f"step {adjusted_step} (epoch {epoch})", self.state, x, c, gen)
                self.holder.store_dict(metrics)
                self.holder.store_variable("unet/lr", self.state.optimizer.schedule(adjusted_step))
                steps_in_buffer += 1

                flush = (adjusted_step + 1) % cfg.log_interval == 0
                if flush:
                    flushed = self.holder.flush()  # the sync: waits for the last step
                    flushed["unet/samples_per_sec"] = timer.items_per_sec(
                        steps_in_buffer * cfg.batch_size, metrics["unet/loss"])
                    self.logger.log_metrics(flushed, step=adjusted_step)
                    epoch_loss_sum += flushed.get("unet/loss", 0.0) * steps_in_buffer
                    loss_steps += steps_in_buffer
                    steps_in_buffer = 0

                if preempted(guard, self.shard, flush, self.device):
                    # meta epoch = the last completed epoch (-1 when none):
                    # resuming replays the interrupted epoch
                    path = self.save(epoch - 1)
                    self.logger.log_console(f"SIGTERM: saved preemption checkpoint {path}; exiting.")
                    return

            if steps_in_buffer:
                tail = self.holder.flush()
                epoch_loss_sum += tail.get("unet/loss", 0.0) * steps_in_buffer
                loss_steps += steps_in_buffer
            self.logger.log_metric("unet/epoch_loss", epoch_loss_sum / max(loss_steps, 1), step=epoch)
            if self.preview_freq > 0 and (epoch + 1) % self.preview_freq == 0:
                self._log_preview(epoch)
            path = self.save(epoch, asynchronous=True)
            self.logger.log_console(f"Saving checkpoint {path} (async)")
        self.saver.wait()

    def _log_preview(self, epoch: int) -> None:
        """The preview grid of the current weights (the EMA's when kept),
        logged as previews/epoch_{epoch:03}.png by rank 0 (every rank
        gathers sharded weights)."""
        weights = self.state.ema if self.state.ema is not None else self.state.optimizer.params
        with torch.no_grad():
            weights = [full(w) for w in weights]
        if self.preview is None:
            return
        imgs = self.preview.images(self._named(weights), seed=epoch)
        fig = plot_cfg_grid(imgs.cpu().numpy(), self.preview.classes, [self.preview.scale])
        self.logger.log_figure(f"previews/epoch_{epoch:03}.png", fig)
