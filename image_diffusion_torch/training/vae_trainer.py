"""Stage-1 adversarial VAE training (KL or VQ bottleneck, VQGAN-style).

One train step:
  * uint8 NHWC images -> [-1, 1] fp32, flipped horizontally where the
    step's flip mask is set; the KL reparametrization noise is the step's
    other draw (`VAEDraws`; VQ leaves it unused).  Both are drawn at the
    full batch, then split into `grad_accum` micro-batches;
  * at `grad_accum: 1`, ONE VAE forward (bf16 compute on fp32 parameters
    for the shipped configs), x_hat clamped to [-1, 1] in fp32, serves
    both phases: the reference's single-forward, two-backward structure,
    which the JAX package's jitted step recovers by recomputation;
  * phase 1, when the discriminator is active: the discriminator on the
    detached x_hat and then on x, in that order (BatchNorm running
    statistics updated by each pass), disc_weight * d_loss, its gradient's
    global norm, clipping and an Adam step with no warmup;
  * phase 2: percept * w + recon * w + prior * w, plus disc_weight * g_loss
    through the just-updated discriminator when active (a third
    discriminator pass, which updates the statistics too); clipping and
    the VAE's Adam step with the warmup schedule;
  * VQ: the codes are looked up in the codebook as it was before the step,
    and the codebook takes exactly one EMA update a step from the batch's
    code statistics (counts and dw over all its tokens).
At `grad_accum` above 1 each phase loops over the micro-batches in order
and applies one clipped Adam step from the mean of their gradients.  Phase
1 runs a VAE forward without gradient per micro-batch (the JAX step's
recomputation); phase 2 a forward with gradient, whose codebook statistics
are summed and applied once after the step.  The discriminator's
BatchNorm statistics chain through the micro-batches in the order of the
passes.  Metrics are means over the micro-batches, gradient norms those of
the averaged gradients; prior loss and perplexity come from phase 2's
forwards, which see the parameters, codebook and inputs phase 1's would,
so an inactive discriminator costs no phase-1 forward.  Metrics (0-d
device tensors, synced once per flush) carry the JAX package's names.

Trainer checkpoints are written and read in the JAX trainer's layout
(trees vae, disc, disc_stats, vae_optim, disc_optim, extra.step, and the
VQ codebook; epoch and architecture in the meta), so a run saved by either
package resumes in the other.  Dev evaluation logs the losses, and the VQ
perplexity, over every dev sample once, and, given a FID (`models/fid.py`),
`dev/FID` of the reconstructions against the dev images (the real
statistics taken at the first evaluation and kept); every `log_imgs_freq`
steps the first 4 images of `plot_set` (when the file exists) are drawn
beside their reconstructions.  With `debug_nans`, the backward runs under
autograd's anomaly detection and a loss or gradient norm that is not
finite raises `FloatingPointError` naming the step.

Not ported yet: data-parallel meshes.
"""

from __future__ import annotations

import os
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
from ..core.plotting import plot_reconstructions, pyplot
from ..core.preemption import PreemptionGuard
from ..core.profiling import StepTimer
from ..core.progress import progress
from ..core.rng import epoch_seed, eval_generator, numpy_seed, root_seed, step_generator
from ..models import build_discriminator, build_vae
from ..models.discriminator import Discriminator
from ..models.fid import FID
from ..models.lpips import LPIPS
from ..models.vae import VAE
from .data import ArrayDataset, epoch_batches, eval_batches, steps_per_epoch
from .diffusion_trainer import Optimizer, check_finite, run_step
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


def _add_grads(acc: list, loss: torch.Tensor, params: list[torch.Tensor]) -> None:
    """Add d loss / d params into `acc` (None where nothing was added yet;
    a parameter the loss does not reach adds nothing)."""
    for i, g in enumerate(torch.autograd.grad(loss, params, allow_unused=True)):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i].add_(g)


def _set_grads(params: list[torch.Tensor], acc: list, n: int) -> None:
    for p, g in zip(params, acc):
        p.grad = None if g is None else g / n  # None: the optimizer zero-fills it


def make_vae_train_step(cfg: VAEConfig, percept_fn: Callable | None = None,
                        debug_nans: bool = False):
    """-> train_step(state, x_u8, draws, disc_active) -> metrics, 0-d device
    tensors.  `draws` is a `VAEDraws` or a generator to draw them from.
    `percept_fn(real, fake)` is the LPIPS term (None: it contributes 0).
    `debug_nans` checks each objective before its backward
    (`check_finite`)."""
    tc = cfg.train
    d_loss_fn, g_loss_fn = D_LOSSES[tc.gan_loss], G_LOSSES[tc.gan_loss]
    is_vq, accum = cfg.arch.bottleneck == "vq", tc.grad_accum

    def vae_forward(vae: VAE, x, noise, **kw):
        x_hat, prior, perplexity = vae(x, noise=noise, **kw)
        return torch.clamp(x_hat.float(), -1.0, 1.0), prior, perplexity

    def train_step(state: VAETrainState, x_u8: torch.Tensor, draws, disc_active: bool) -> dict:
        if isinstance(draws, torch.Generator):
            draws = draw(draws, x_u8.shape[0], _latent_shape(cfg, x_u8))
        x = normalize_batch(x_u8, draws.flip)
        micro = list(zip(x.chunk(accum), draws.noise.chunk(accum)))
        sums: dict[str, torch.Tensor] = {}

        def add(values: dict) -> None:
            for k, v in values.items():
                sums[k] = sums[k] + v.detach() if k in sums else v.detach()

        # VQ at accum 1 updates the codebook in this forward, after its lookup
        ema_stats = state.vae.codebook.empty_stats() if is_vq and accum > 1 else None
        if accum == 1:
            with torch.enable_grad():
                forward = vae_forward(state.vae, x, draws.noise, train=True)

        if disc_active:  # phase 1: the discriminator, on detached fakes then reals
            d_params, acc = state.disc_opt.params, [None] * len(state.disc_opt.params)
            for xm, nm in micro:
                if accum == 1:
                    x_hat = forward[0].detach()
                else:
                    with torch.no_grad():
                        x_hat = vae_forward(state.vae, xm, nm)[0]
                with torch.enable_grad():
                    out_fake = state.disc(x_hat).float()
                    out_real = state.disc(xm).float()
                    d_loss = d_loss_fn(out_fake, out_real)
                    if debug_nans:
                        check_finite({"gan/d_loss": d_loss})
                    _add_grads(acc, tc.disc_weight * d_loss, d_params)
                add({"gan/d_loss": d_loss,
                     "gan/fake_acc": (torch.sigmoid(out_fake.detach()) < 0.5).float().mean(),
                     "gan/real_acc": (torch.sigmoid(out_real.detach()) >= 0.5).float().mean()})
            _set_grads(d_params, acc, accum)
            disc_grad = state.disc_opt.step()

        # phase 2: the VAE, through the updated discriminator
        v_params, acc = state.vae_opt.params, [None] * len(state.vae_opt.params)
        for xm, nm in micro:
            with torch.enable_grad():
                if accum == 1:
                    x_hat, prior, perplexity = forward
                else:
                    x_hat, prior, perplexity = vae_forward(state.vae, xm, nm, train=True,
                                                           ema_stats=ema_stats)
                rl = recon_loss(xm, x_hat)
                pl = percept_fn(xm, x_hat) if percept_fn is not None else x_hat.new_zeros(())
                loss = pl * tc.percept_weight + rl * tc.recon_weight + prior * tc.prior_weight
                if disc_active:
                    g_loss = g_loss_fn(state.disc(x_hat).float())
                    loss = loss + g_loss * tc.disc_weight
                    add({"gan/g_loss": g_loss})
                if debug_nans:
                    check_finite({"vae/loss": loss})
                _add_grads(acc, loss, v_params)
            add({"vae/prior_loss": prior, "vae/recon_loss": rl, "vae/percept_loss": pl})
            if is_vq:
                add({"vae/perplexity": perplexity})
        _set_grads(v_params, acc, accum)
        metrics = {k: v / accum for k, v in sums.items()}
        metrics["vae/vae_grad"] = state.vae_opt.step()
        if disc_active:
            metrics["gan/disc_grad"] = disc_grad
        if ema_stats is not None:
            state.vae.codebook.ema_update(*ema_stats)
        return metrics

    return train_step


def make_eval_step(percept_fn: Callable | None = None):
    """-> eval_step(vae, x_u8, noise, n_valid=None) -> (x_hat clamped to
    [-1, 1] fp32, per-sample recon losses, per-sample perceptual losses,
    perplexity), no gradients and no codebook update.  `noise` is the
    batch's reparametrization draw (KL; VQ ignores it); the VQ perplexity
    counts only the first `n_valid` rows (all when None), KL's is 0."""

    @torch.no_grad()
    def eval_step(vae: VAE, x_u8: torch.Tensor, noise: torch.Tensor | None,
                  n_valid: int | None = None):
        x = normalize_batch(x_u8)
        mask = None
        if vae.arch.bottleneck == "vq" and n_valid is not None:
            mask = torch.arange(x.shape[0], device=x.device) < n_valid
        x_hat, _, perplexity = vae(x, noise=noise, valid_mask=mask)
        x_hat = torch.clamp(x_hat.float(), -1.0, 1.0)
        rl = recon_loss_per_sample(x, x_hat)
        pl = (percept_fn(x, x_hat, reduce=False) if percept_fn is not None
              else x.new_zeros((x.shape[0],)))
        return x_hat, rl, pl, perplexity

    return eval_step


class VAETrainer:
    """Host-side orchestration: epochs, metrics, dev evaluation, checkpoints."""

    def __init__(self, config: VAEConfig, train_set: ArrayDataset, dev_set: ArrayDataset | None,
                 logger: BasicLogger, holder: MetricHolder, checkpoint: str | None = None,
                 run_name: str = "vae", percept_fn: LPIPS | None = None,
                 device: str | torch.device = "cuda", fid_fn: FID | None = None,
                 debug_nans: bool = False):
        tc = config.train
        tc.validate_accum()
        self.cfg = config
        self.train_set = train_set
        self.dev_set = dev_set
        self.logger = logger
        self.holder = holder
        self.run_name = run_name
        self.device = resolve_device(device)
        self.fid_fn = fid_fn
        self.debug_nans = debug_nans

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
        self.train_step = make_vae_train_step(config, percept_fn, debug_nans)
        self.eval_step = make_eval_step(percept_fn)
        # the fixed plot set of the periodic reconstruction figures
        self.plot_images = None
        if tc.plot_set and os.path.exists(tc.plot_set):
            pyplot()  # fails here, not at the first figure, without matplotlib
            self.plot_images = torch.from_numpy(np.load(tc.plot_set)[:4]).to(self.device)

    @torch.no_grad()
    def _restore(self, path: str) -> None:
        trees, meta = ckpt.load_checkpoint(path)
        st = self.state
        variables = {"params": trees["vae"]}
        if "codebook" in trees:
            variables["codebook"] = trees["codebook"]
        st.vae.load_state_dict(vae_state_dict(variables))
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
        if self.cfg.arch.bottleneck == "vq":
            trees["codebook"] = vae_flax_variables(
                {k: v for k, v in st.vae.state_dict().items() if k.startswith("codebook.")}
            )["codebook"]
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
            steps_in_window, timer = 0, StepTimer()
            batches = epoch_batches(self.train_set, cfg.batch_size, numpy_seed(eseed),
                                    device=self.device)
            for step, (x,) in enumerate(progress(batches, total=spe, desc=f"epoch {epoch}")):
                adjusted_step = epoch * spe + step
                if self.plot_images is not None and (adjusted_step + 1) % cfg.log_imgs_freq == 0:
                    self._log_reconstructions(adjusted_step, eseed)
                metrics = run_step(self.train_step, self.debug_nans,
                                   f"step {adjusted_step} (epoch {epoch})", self.state, x, gen,
                                   disc_active=adjusted_step >= cfg.disc_start)
                self.holder.store_dict(metrics)
                steps_in_window += 1

                if (adjusted_step + 1) % cfg.log_interval == 0:
                    flushed = self.holder.flush()  # the sync: waits for the last step
                    flushed["util/imgs_per_sec"] = timer.items_per_sec(
                        steps_in_window * cfg.batch_size, metrics["vae/vae_grad"])
                    steps_in_window = 0
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

    def _log_reconstructions(self, step: int, seed: int) -> None:
        """The plot set beside its reconstructions through the eval path,
        logged as plots/{step}_recon.png."""
        x = self.plot_images
        noise = torch.randn((x.shape[0], *_latent_shape(self.cfg, x)),
                            generator=eval_generator(seed, self.device), device=self.device)
        x_hat = self.eval_step(self.state.vae, x, noise)[0]
        fig = plot_reconstructions(normalize_batch(x).cpu().numpy(), x_hat.cpu().numpy())
        self.logger.log_figure(f"plots/{step}_recon.png", fig)

    def _evaluate(self, epoch: int, seed: int) -> None:
        """Dev losses over the whole dev set: the tail batch is padded and
        weighted by its valid count, so every sample counts once; each
        batch gets fresh reparametrization noise.  The VQ perplexity of a
        batch counts its valid rows' codes and is weighted by their number.
        One sync at the end, and, with a FID, one per batch for its
        features: the valid reconstructions in [0, 1] as the fake set, the
        valid dev images as the real set until the first FID latches it."""
        cfg = self.cfg.train
        gen = eval_generator(seed, self.device)
        sums, n_seen = torch.zeros(3, device=self.device), 0
        if self.fid_fn is not None:
            self.fid_fn.reset_fake()
        for n_valid, (x,) in eval_batches(self.dev_set, cfg.batch_size, self.device):
            noise = torch.randn((x.shape[0], *_latent_shape(self.cfg, x)), generator=gen,
                                device=self.device)
            x_hat, rl, pl, perplexity = self.eval_step(self.state.vae, x, noise, n_valid)
            sums += torch.stack([rl[:n_valid].sum(), pl[:n_valid].sum(), perplexity * n_valid])
            n_seen += n_valid
            if self.fid_fn is not None:
                self.fid_fn.update_fake(((x_hat + 1.0) / 2.0)[:n_valid])
                self.fid_fn.update_real_once(((normalize_batch(x) + 1.0) / 2.0)[:n_valid])
        if n_seen:
            recon, percept, perplexity = (sums / n_seen).tolist()
            self.logger.log_metric("dev/recon_loss", recon, step=epoch)
            self.logger.log_metric("dev/percept_loss", percept, step=epoch)
            if self.cfg.arch.bottleneck == "vq":
                self.logger.log_metric("dev/perplexity", perplexity, step=epoch)
        if self.fid_fn is not None:
            self.logger.log_metric("dev/FID", self.fid_fn.compute(), step=epoch)
