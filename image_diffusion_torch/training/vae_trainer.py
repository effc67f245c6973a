"""Stage-1 adversarial VAE training (KL bottleneck, VQGAN-style).

One train step:
  * uint8 NHWC images -> [-1, 1] fp32, flipped horizontally where the
    step's flip mask is set; the KL reparametrization noise is the step's
    other draw (`VAEDraws`);
  * ONE VAE forward (bf16 compute on fp32 parameters for the shipped
    config), x_hat clamped to [-1, 1] in fp32;
  * phase 1, when the discriminator is active: the discriminator on the
    detached x_hat and then on x, in that order (BatchNorm running
    statistics updated by each pass), disc_weight * d_loss, its gradient's
    global norm, clipping and an Adam step with no warmup;
  * phase 2: percept * w + recon * w + prior * w, plus disc_weight * g_loss
    through the just-updated discriminator when active (a third
    discriminator pass, which updates the statistics too); clipping and
    the VAE's Adam step with the warmup schedule.
The one forward serves both phases: the reference's single-forward,
two-backward structure, which the JAX package's jitted step recovers by
recomputation.  Metrics (0-d device tensors, synced once per flush) carry
the JAX package's names.

Trainer checkpoints are written and read in the JAX trainer's layout
(trees vae, disc, disc_stats, vae_optim, disc_optim, extra.step; epoch and
architecture in the meta), so a run saved by either package resumes in the
other.

Not ported yet: VQ training (the EMA codebook update; `bottleneck: vq`
raises), grad accumulation above 1 (raises), the reconstruction figures of
`plot_set`/`log_imgs_freq`, per-epoch FID and data-parallel meshes.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..compat.from_jax import (
    adam_moments,
    adam_tree,
    disc_flax_params,
    disc_flax_stats,
    disc_state_dict,
    vae_flax_variables,
    vae_state_dict,
)
from ..core import checkpoint as ckpt
from ..core import resolve_device
from ..core.config import VAEConfig
from ..core.logging import BasicLogger
from ..core.metrics import MetricHolder
from ..core.preemption import PreemptionGuard
from ..core.progress import progress
from ..core.rng import epoch_seed, eval_generator, numpy_seed, root_seed, step_generator
from ..models import build_discriminator, build_vae
from ..models.discriminator import Discriminator
from ..models.lpips import LPIPS
from ..models.vae import VAE
from .data import ArrayDataset, epoch_batches, eval_batches, steps_per_epoch
from .diffusion_trainer import Optimizer
from .losses import D_LOSSES, G_LOSSES, recon_loss, recon_loss_per_sample


def normalize_batch(x: torch.Tensor, flip_mask: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 NHWC -> [-1, 1] fp32: u8 / 255, then (x - .5) / .5, then a
    horizontal flip of the rows where `flip_mask` (B,) is set."""
    x = x.float() / 255.0
    x = (x - 0.5) / 0.5
    if flip_mask is not None:
        x = torch.where(flip_mask[:, None, None, None], x.flip(2), x)
    return x


class VAEDraws(NamedTuple):
    """The random inputs of one step: the flip mask (B,) bool and the KL
    reparametrization noise (B, h, w, z_dim) fp32."""

    flip: torch.Tensor
    noise: torch.Tensor


def draw(generator: torch.Generator, batch: int, latent_shape: tuple[int, int, int]) -> VAEDraws:
    """The step's draws from `generator`, on its device: flips with
    probability 1/2, then standard normal noise."""
    kw = dict(generator=generator, device=generator.device)
    return VAEDraws(torch.rand((batch,), **kw) < 0.5, torch.randn((batch, *latent_shape), **kw))


def _latent_shape(cfg: VAEConfig, x: torch.Tensor) -> tuple[int, int, int]:
    factor = 2 ** (len(cfg.arch.channels) - 1)
    return x.shape[1] // factor, x.shape[2] // factor, cfg.arch.z_dim


@dataclass
class VAETrainState:
    """The two models and their optimizers; the train step updates all
    four in place.  The step count is the VAE optimizer's."""

    vae: VAE
    disc: Discriminator
    vae_opt: Optimizer
    disc_opt: Optimizer

    @property
    def step(self) -> int:
        return self.vae_opt.count


def _set_grads(params: list[torch.Tensor], loss: torch.Tensor) -> None:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = g  # None for an unused parameter: the optimizer zero-fills it


def make_vae_train_step(cfg: VAEConfig, percept_fn: Callable | None = None):
    """-> train_step(state, x_u8, draws, disc_active) -> metrics, 0-d device
    tensors.  `draws` is a `VAEDraws` or a generator to draw them from.
    `percept_fn(real, fake)` is the LPIPS term (None: it contributes 0)."""
    tc = cfg.train
    d_loss_fn, g_loss_fn = D_LOSSES[tc.gan_loss], G_LOSSES[tc.gan_loss]

    def train_step(state: VAETrainState, x_u8: torch.Tensor, draws, disc_active: bool) -> dict:
        if isinstance(draws, torch.Generator):
            draws = draw(draws, x_u8.shape[0], _latent_shape(cfg, x_u8))
        x = normalize_batch(x_u8, draws.flip)
        with torch.enable_grad():
            x_hat, prior, _ = state.vae(x, sample=True, noise=draws.noise)
            x_hat = torch.clamp(x_hat.float(), -1.0, 1.0)
        metrics = {"vae/prior_loss": prior.detach()}

        if disc_active:  # phase 1: the discriminator, on detached fakes then reals
            with torch.enable_grad():
                out_fake = state.disc(x_hat.detach()).float()
                out_real = state.disc(x).float()
                d_loss = d_loss_fn(out_fake, out_real)
                _set_grads(state.disc_opt.params, tc.disc_weight * d_loss)
            metrics["gan/d_loss"] = d_loss.detach()
            metrics["gan/fake_acc"] = (torch.sigmoid(out_fake.detach()) < 0.5).float().mean()
            metrics["gan/real_acc"] = (torch.sigmoid(out_real.detach()) >= 0.5).float().mean()
            metrics["gan/disc_grad"] = state.disc_opt.step()

        with torch.enable_grad():  # phase 2: the VAE, through the updated discriminator
            rl = recon_loss(x, x_hat)
            pl = percept_fn(x, x_hat) if percept_fn is not None else x_hat.new_zeros(())
            loss = pl * tc.percept_weight + rl * tc.recon_weight + prior * tc.prior_weight
            if disc_active:
                g_loss = g_loss_fn(state.disc(x_hat).float())
                loss = loss + g_loss * tc.disc_weight
            _set_grads(state.vae_opt.params, loss)
        metrics["vae/recon_loss"] = rl.detach()
        metrics["vae/percept_loss"] = pl.detach()
        metrics["vae/vae_grad"] = state.vae_opt.step()
        if disc_active:
            metrics["gan/g_loss"] = g_loss.detach()
        return metrics

    return train_step


def make_eval_step(percept_fn: Callable | None = None):
    """-> eval_step(vae, x_u8, noise) -> (per-sample recon losses,
    per-sample perceptual losses), no gradients; `noise` is the batch's
    reparametrization draw."""

    @torch.no_grad()
    def eval_step(vae: VAE, x_u8: torch.Tensor, noise: torch.Tensor):
        x = normalize_batch(x_u8)
        x_hat, _, _ = vae(x, sample=True, noise=noise)
        x_hat = torch.clamp(x_hat.float(), -1.0, 1.0)
        rl = recon_loss_per_sample(x, x_hat)
        pl = (percept_fn(x, x_hat, reduce=False) if percept_fn is not None
              else x.new_zeros((x.shape[0],)))
        return rl, pl

    return eval_step


class VAETrainer:
    """Host-side orchestration: epochs, metrics, dev evaluation, checkpoints."""

    def __init__(self, config: VAEConfig, train_set: ArrayDataset, dev_set: ArrayDataset | None,
                 logger: BasicLogger, holder: MetricHolder, checkpoint: str | None = None,
                 run_name: str = "vae", percept_fn: LPIPS | None = None,
                 device: str | torch.device = "cuda"):
        tc = config.train
        if config.arch.bottleneck != "kl":
            raise ValueError("VQ training (the EMA codebook update) is not ported; "
                             "the trainer takes bottleneck: kl")
        tc.validate_accum()
        if tc.grad_accum != 1:
            raise ValueError(f"grad_accum {tc.grad_accum} is not ported; use grad_accum: 1")
        self.cfg = config
        self.train_set = train_set
        self.dev_set = dev_set
        self.logger = logger
        self.holder = holder
        self.run_name = run_name
        self.device = resolve_device(device)

        # fp32 parameters, compute in the config's dtype; init from seeds 0, 2
        dtype = tc.compute_dtype
        vae = build_vae(config.arch, dtype, self.device, torch.Generator().manual_seed(0),
                        param_dtype=torch.float32).train()
        disc = build_discriminator(tc.disc_channels, dtype, self.device,
                                   torch.Generator().manual_seed(2))
        if percept_fn is not None:
            # the frozen backbone runs at the compute dtype; the tap
            # comparison stays fp32 inside LPIPS
            percept_fn = percept_fn.astype(dtype).to(self.device)
        self.state = VAETrainState(
            vae, disc, Optimizer(vae.parameters(), tc.learning_rate, tc.warmup_steps, tc.clip_grad),
            # only the VAE's optimizer warms up, as in the reference
            Optimizer(disc.parameters(), tc.learning_rate, 0, tc.clip_grad))
        self.vae_names = [n for n, _ in vae.named_parameters()]
        self.disc_names = [n for n, _ in disc.named_parameters()]
        self.saver = ckpt.AsyncSaver()
        logger.log_console(f"VAE has {sum(p.numel() for p in vae.parameters()):,} params.")
        logger.log_console(f"Discriminator has {sum(p.numel() for p in disc.parameters()):,} params.")

        self.curr_epoch = 0
        if checkpoint is not None:
            self._restore(checkpoint)
            logger.log_console(f"Loading model checkpoint from {checkpoint}")
        else:
            logger.log_console("No checkpoint provided. Training from scratch.")
        self.train_step = make_vae_train_step(config, percept_fn)
        self.eval_step = make_eval_step(percept_fn)

    @torch.no_grad()
    def _restore(self, path: str) -> None:
        trees, meta = ckpt.load_checkpoint(path)
        st = self.state
        st.vae.load_state_dict(vae_state_dict({"params": trees["vae"]}))
        st.disc.load_state_dict(disc_state_dict(trees["disc"], trees["disc_stats"]))
        for opt, tree, to_torch, names in (
                (st.vae_opt, trees["vae_optim"], lambda t: vae_state_dict({"params": t}),
                 self.vae_names),
                (st.disc_opt, trees["disc_optim"], disc_state_dict, self.disc_names)):
            count, mu, nu = adam_moments(tree)
            mu, nu = to_torch(mu), to_torch(nu)
            opt.load(count, [mu[n] for n in names], [nu[n] for n in names])
        self.curr_epoch = int(meta["epoch"]) + 1

    def save(self, epoch: int, asynchronous: bool = False) -> str:
        """Write the trainer checkpoint (JAX layout) of the current state;
        `asynchronous` copies to the host here and writes on a thread."""
        path = os.path.join(self.cfg.train.checkpoints_dir, self.run_name,
                            f"vae-epoch-{epoch:02}.ckpt")
        st = self.state

        def vae_tree(tensors):
            return vae_flax_variables(dict(zip(self.vae_names, tensors)))["params"]

        def disc_tree(tensors):
            return disc_flax_params(dict(zip(self.disc_names, tensors)))

        clipped = self.cfg.train.clip_grad is not None
        vae_mu, vae_nu = st.vae_opt.moments()
        disc_mu, disc_nu = st.disc_opt.moments()
        trees = dict(
            vae=vae_tree(st.vae_opt.params),
            disc=disc_tree(st.disc_opt.params),
            disc_stats=disc_flax_stats(st.disc.state_dict()),
            vae_optim=adam_tree(st.vae_opt.count, vae_tree(vae_mu), vae_tree(vae_nu), clipped),
            disc_optim=adam_tree(st.disc_opt.count, disc_tree(disc_mu), disc_tree(disc_nu),
                                 clipped),
            extra={"step": np.asarray(st.step, dtype=np.int32)},
        )
        if asynchronous:
            self.saver.save(path, self.cfg.arch.to_dict(), epoch, **trees)
        else:
            self.saver.wait()
            ckpt.save_checkpoint(path, self.cfg.arch.to_dict(), epoch, **trees)
        return path

    def train(self) -> None:
        cfg = self.cfg.train
        self.logger.log_params(lr=cfg.learning_rate, disc_weight=cfg.disc_weight,
                               disc_start=cfg.disc_start, loss=cfg.gan_loss)
        # the seed offset by the epoch count keeps resumed sub-runs' draws fresh
        root = root_seed(cfg.seed, offset=cfg.epochs)
        spe = steps_per_epoch(self.train_set, cfg.batch_size)
        guard = PreemptionGuard()

        for epoch in range(self.curr_epoch, cfg.epochs):
            eseed = epoch_seed(root, epoch)
            gen = step_generator(eseed, self.device)
            steps_in_window, t_last = 0, time.time()
            batches = epoch_batches(self.train_set, cfg.batch_size, numpy_seed(eseed),
                                    device=self.device)
            for step, (x,) in enumerate(progress(batches, total=spe, desc=f"epoch {epoch}")):
                adjusted_step = epoch * spe + step
                metrics = self.train_step(self.state, x, gen,
                                          disc_active=adjusted_step >= cfg.disc_start)
                self.holder.store_dict(metrics)
                steps_in_window += 1

                if (adjusted_step + 1) % cfg.log_interval == 0:
                    flushed = self.holder.flush()  # waits for the last step
                    now = time.time()
                    flushed["util/imgs_per_sec"] = steps_in_window * cfg.batch_size / (now - t_last)
                    steps_in_window, t_last = 0, now
                    self.logger.log_metrics(flushed, step=adjusted_step)

                if guard.triggered:
                    # meta epoch = the last completed epoch (-1 when none):
                    # resuming replays the interrupted epoch
                    path = self.save(epoch - 1)
                    self.logger.log_console(f"SIGTERM: saved preemption checkpoint {path}; exiting.")
                    return

            if self.dev_set is not None:
                self._evaluate(epoch, eseed)
            path = self.save(epoch, asynchronous=True)
            self.logger.log_console(f"Saving checkpoint {path} (async)")
        self.saver.wait()

    def _evaluate(self, epoch: int, seed: int) -> None:
        """Dev losses over the whole dev set: the tail batch is padded and
        weighted by its valid count, so every sample counts once; each
        batch gets fresh reparametrization noise.  One sync at the end."""
        cfg = self.cfg.train
        gen = eval_generator(seed, self.device)
        sums, n_seen = torch.zeros(2, device=self.device), 0
        for n_valid, (x,) in eval_batches(self.dev_set, cfg.batch_size, self.device):
            noise = torch.randn((x.shape[0], *_latent_shape(self.cfg, x)), generator=gen,
                                device=self.device)
            rl, pl = self.eval_step(self.state.vae, x, noise)
            sums += torch.stack([rl[:n_valid].sum(), pl[:n_valid].sum()])
            n_seen += n_valid
        if n_seen:
            recon, percept = (sums / n_seen).tolist()
            self.logger.log_metric("dev/recon_loss", recon, step=epoch)
            self.logger.log_metric("dev/percept_loss", percept, step=epoch)
