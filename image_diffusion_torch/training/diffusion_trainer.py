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

Not ported yet: remat (any `remat` other than "none" raises), data-parallel
and FSDP training, and in-training sample previews.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..compat.from_jax import adam_state, adam_tree, unet_flax_params, unet_state_dict
from ..core import checkpoint as ckpt
from ..core import resolve_device
from ..core.config import DiffusionConfig
from ..core.logging import BasicLogger
from ..core.metrics import MetricHolder
from ..core.preemption import PreemptionGuard
from ..core.progress import progress
from ..core.rng import epoch_seed, numpy_seed, root_seed, step_generator
from ..models import build_unet
from ..models.unet import UNet
from ..models.vae import VAE
from ..ops import schedule as S
from .data import ArrayDataset, epoch_batches, steps_per_epoch


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
    max_norm, else (g / norm) * max_norm.  No host sync."""
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm).to(norm.dtype))


class Optimizer:
    """Gradient clipping, then Adam at the warmup schedule's learning rate,
    over a list of fp32 parameters (their `.grad`s are the input).  `count`
    is the number of updates applied."""

    def __init__(self, params, learning_rate: float, warmup_steps: int,
                 clip_grad: float | None):
        self.params = list(params)
        self.schedule = warmup_schedule(learning_rate, warmup_steps)
        self.clip_grad = clip_grad
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip and apply the gradients; -> their global norm before the clip."""
        for p in self.params:
            if p.grad is None:  # an unused parameter: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
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
        """Set the update count and the moments (any device and layout)."""
        self.count = count
        for p, m, v in zip(self.params, mu, nu, strict=True):
            self.adam.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.empty_like(p).copy_(m),
                "exp_avg_sq": torch.empty_like(p).copy_(v),
            }


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
                    ema_decay: float | None = None, grad_accum: int = 1):
    """-> train_step(state, x, c, draws) -> {"unet/loss", "unet/grad"}, 0-d
    device tensors.  `x` holds stored latents (B, H, W, 2z for KL), `c`
    class ids; `draws` is a `Draws` or a generator to draw them from.

    grad_accum > 1 splits the full-batch draws into micro-batches whose
    gradients are summed and divided once; the MSE's gradient is linear, so
    the update equals the single-shot step's up to fp reassociation."""

    def train_step(state: TrainState, x: torch.Tensor, c: torch.Tensor, draws) -> dict:
        if isinstance(draws, torch.Generator):
            draws = draw(draws, x.shape, sched.num_steps, reparametrize)
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
                eps_hat = state.unet(x_noise[rows], draws.t[rows], c[rows], mask[rows])
                loss = torch.mean((eps_hat.float() - draws.noise[rows]) ** 2)
                loss.backward()
                total = loss.detach() if i == 0 else total + loss.detach()
        if a > 1:
            total = total / a
            torch._foreach_div_([p.grad for p in opt.params if p.grad is not None], float(a))
        grad_norm = opt.step()
        if ema_decay:
            with torch.no_grad():
                torch._foreach_mul_(state.ema, ema_decay)
                torch._foreach_add_(state.ema, opt.params, alpha=1.0 - ema_decay)
        return {"unet/loss": total, "unet/grad": grad_norm}

    return train_step


class DiffusionTrainer:
    """Host-side orchestration: epochs, metrics, checkpoints."""

    def __init__(self, config: DiffusionConfig, train_set: ArrayDataset, logger: BasicLogger,
                 holder: MetricHolder, checkpoint: str | None = None, run_name: str = "unet",
                 device: str | torch.device = "cuda"):
        tc = config.train
        if tc.remat != "none":
            raise ValueError(f"remat {tc.remat!r} is not ported; use remat: none")
        tc.validate_accum()
        self.cfg = config
        self.train_set = train_set
        self.logger = logger
        self.holder = holder
        self.run_name = run_name
        self.device = resolve_device(device)

        # fp32 parameters, compute in the config's dtype; init from seed 0
        self.unet = build_unet(config.arch, dtype=tc.compute_dtype, device=self.device,
                               generator=torch.Generator().manual_seed(0),
                               param_dtype=torch.float32).train()
        self.names = [n for n, _ in self.unet.named_parameters()]
        self.sched = S.make_schedule(config.schedule.num_steps, config.schedule.beta_start,
                                     config.schedule.beta_end, config.schedule.noise_type,
                                     device=self.device)
        optimizer = Optimizer(self.unet.parameters(), tc.learning_rate, tc.warmup_steps,
                              tc.clip_grad)
        ema = [p.detach().clone() for p in optimizer.params] if tc.ema_decay else None
        self.state = TrainState(self.unet, optimizer, ema)
        self.saver = ckpt.AsyncSaver()

        n_params = sum(p.numel() for p in optimizer.params)
        logger.log_console(f"Unet has {n_params:,} params.")
        logger.log_console(f"Train set has {len(train_set)} items.")

        self.curr_epoch = 0
        if checkpoint is not None:
            self._restore(checkpoint)
            logger.log_console(f"Loading model checkpoint from {checkpoint}")
        else:
            logger.log_console("No checkpoint provided. Training from scratch.")

        self.train_step = make_train_step(
            self.sched, tc.cond_drop_prob, reparametrize=(tc.ae_type == "kl"),
            ema_decay=tc.ema_decay, grad_accum=tc.grad_accum)

    def _named(self, tensors: list[torch.Tensor]) -> dict[str, torch.Tensor]:
        return dict(zip(self.names, tensors, strict=True))

    @torch.no_grad()
    def _restore(self, path: str) -> None:
        trees, meta = ckpt.load_checkpoint(path)
        self.unet.load_state_dict(unet_state_dict(trees["unet"]))
        opt = self.state.optimizer
        if self.state.ema is not None:
            # without a saved EMA, seed it from the restored parameters
            src = unet_state_dict(trees["unet_ema"]) if "unet_ema" in trees else None
            for e, name, p in zip(self.state.ema, self.names, opt.params):
                e.copy_(src[name] if src is not None else p)
        _, mu, nu = adam_state(trees["optim"])
        opt.load(int(trees["step"]["step"]), [mu[n] for n in self.names],
                 [nu[n] for n in self.names])
        self.curr_epoch = int(meta["epoch"]) + 1

    def save(self, epoch: int, asynchronous: bool = False) -> str:
        """Write the trainer checkpoint (JAX layout) of the current state;
        `asynchronous` copies to the host here and writes on a thread."""
        path = os.path.join(self.cfg.train.checkpoints_dir, self.run_name,
                            f"unet-epoch-{epoch:02}.ckpt")
        opt = self.state.optimizer
        mu, nu = opt.moments()
        trees = dict(
            unet=unet_flax_params(self._named(opt.params)),
            unet_ema=(unet_flax_params(self._named(self.state.ema))
                      if self.state.ema is not None else None),
            optim=adam_tree(opt.count, self._named(mu), self._named(nu),
                            clipped=opt.clip_grad is not None),
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
        # the seed offset by the epoch count keeps resumed sub-runs' draws fresh
        root = root_seed(cfg.seed, offset=cfg.epochs)
        spe = steps_per_epoch(self.train_set, cfg.batch_size)
        guard = PreemptionGuard()

        for epoch in range(self.curr_epoch, cfg.epochs):
            eseed = epoch_seed(root, epoch)
            gen = step_generator(eseed, self.device)
            # the epoch loss averages every step's loss, the tail after the
            # last flush included
            epoch_loss_sum, loss_steps, steps_in_buffer = 0.0, 0, 0
            t_last = time.time()
            batches = epoch_batches(self.train_set, cfg.batch_size, numpy_seed(eseed),
                                    device=self.device)
            for step, (x, c) in enumerate(progress(batches, total=spe, desc=f"epoch {epoch}")):
                adjusted_step = epoch * spe + step
                metrics = self.train_step(self.state, x, c, gen)
                self.holder.store_dict(metrics)
                self.holder.store_variable("unet/lr", self.state.optimizer.schedule(adjusted_step))
                steps_in_buffer += 1

                if (adjusted_step + 1) % cfg.log_interval == 0:
                    flushed = self.holder.flush()  # waits for the last step
                    now = time.time()
                    flushed["unet/samples_per_sec"] = steps_in_buffer * cfg.batch_size / (now - t_last)
                    t_last = now
                    self.logger.log_metrics(flushed, step=adjusted_step)
                    epoch_loss_sum += flushed.get("unet/loss", 0.0) * steps_in_buffer
                    loss_steps += steps_in_buffer
                    steps_in_buffer = 0

                if guard.triggered:
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
            path = self.save(epoch, asynchronous=True)
            self.logger.log_console(f"Saving checkpoint {path} (async)")
        self.saver.wait()
