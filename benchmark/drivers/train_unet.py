"""Steps of the stage-2 denoiser's trainer on stored KL latents.

A unit is one call of the train step `make_train_step` builds, on the
`TrainState` (the UNet on fp32 parameters computing in the compute dtype,
the clip-and-Adam optimizer) that `DiffusionTrainer` builds, at the
traffic's `batch_size`.  Its inputs are a pool of `pool_batches` batches
on the card, made from the seed: stored latents as `prepare_dataset`
writes them (mean || log_var, fp16; means N(0, 1), posterior std
`latent_std`), class ids, and each batch's draws (`Draws`:
reparametrization noise, timesteps, diffusion noise, condition-dropout
draws).  Unit i takes pool entry i mod `pool_batches`.

Set-up runs `warmup_units` units, which warm the shapes, then sets the
model and the optimizer back to the initial weights and no update taken
(`yardstick.WindowSteps`), so the window's first `checked_steps` units are
the training state's first steps, each on its own batch: the check keeps
their losses, the first one's gradients as the optimizer took them, and
the parameters after them.  After the window the fp32 reference takes
those steps from the same weights and inputs; the numbers compared are
the median leaf's gap of the first gradient's norm
(first_grad_gap.median) and of the norm of the parameters' change over
the checked steps (change_gap.median), each over the larger of the
leaf's and the median leaf's reference norm.
"""

from __future__ import annotations

import torch

import yardstick as Y
from reference import nets, steps as ref

RATE = ("train_samples_per_s", "samples/s")


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from image_diffusion_torch.core.config import DiffusionTrainConfig, UNetArch, _build
        from image_diffusion_torch.models import build_unet
        from image_diffusion_torch.ops import schedule as S
        from image_diffusion_torch.training.diffusion_trainer import (Draws, Optimizer, TrainState,
                                                                      make_train_step)

        Y.mark("program imported")

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        tc = _build(DiffusionTrainConfig, {**config, "batch_size": traffic["batch_size"]})
        self.ua = nets.unet_arch(config)
        self.leaves = nets.unet_leaves(self.ua)
        P0 = self.weights()
        unet = build_unet(_build(UNetArch, config), dtype=getattr(torch, config["compute_dtype"]),
                          device=device, param_dtype=torch.float32, remat=tc.remat).train()
        unet.load_state_dict(P0)
        Y.mark("weights drawn, model built")
        self.state = TrainState(unet, Optimizer(unet.parameters(), tc.learning_rate,
                                                tc.warmup_steps, tc.clip_grad), None)
        sched = S.make_schedule(config["num_steps"], config["beta_start"],
                                config["beta_end"], config["noise_type"], device=device)
        self.train_step = make_train_step(sched, tc.cond_drop_prob, tc.ae_type == "kl",
                                          tc.ema_decay, tc.grad_accum)
        self.B, r, z = tc.batch_size, nets.latent_res(config["vae"]), self.ua["z_dim"]
        g = torch.Generator(device=device)
        g.manual_seed(Y.derive_seed(seed, "data"))
        kw = dict(generator=g, device=device)
        self.pool = []
        for _ in range(traffic["pool_batches"]):
            mean = torch.randn((self.B, r, r, z), **kw)
            log_var = torch.full_like(mean, 2.0 * torch.log(torch.tensor(traffic["latent_std"])))
            lat = torch.cat([mean, log_var + 0.1 * torch.randn(mean.shape, **kw)], -1).half()
            labels = torch.randint(0, self.ua["num_classes"], (self.B,), **kw)
            draws = Draws(torch.randn((self.B, r, r, z), **kw),
                          torch.randint(0, config["num_steps"], (self.B,), **kw),
                          torch.randn((self.B, r, r, z), **kw), torch.rand((self.B,), **kw))
            self.pool.append(((lat, labels), draws))
        Y.mark("inputs made")
        self.warmup, self.checked = traffic["warmup_units"], traffic["checked_steps"]
        if self.warmup + self.checked > len(self.pool):
            raise ValueError("the warm-up and the checked steps take a batch each")
        self.units, self.min_units = 0, self.checked

        self.unit_items, self.unit_steps = self.B, 1
        self.unit_flops = self.B * config["flops"]["unet_train_per_row"]
        sites = Y.unet_attention_sites(self.ua, r)
        self.unit_attention = ([Y.attention_forward(self.B, N, C) for N, C in sites]
                               + [Y.attention_backward(self.B, N, C) for N, C in sites])

        self.kept = Y.WindowSteps(dict(unet.named_parameters()), list(unet.buffers()),
                                  self.checked)
        for _ in range(self.warmup):
            self.run_unit()
        self.kept.rewind([self.state.optimizer])
        Y.mark("warmed")

    def weights(self) -> dict:
        return nets.make_weights(self.leaves, Y.derive_seed(self.seed, "unet"), self.device)

    def run_unit(self) -> None:
        (x, c), draws = self.pool[self.units % len(self.pool)]
        metrics = self.train_step(self.state, x, c, draws)
        self.units += 1
        if self.units > self.warmup:
            self.kept.after_step({"loss": metrics["unet/loss"]})

    def check(self, control: bool = False, fault: str | None = None) -> dict:
        """The compared numbers of the program (see the module doc), and
        with `control` or `fault` the control's or a planted fault's
        (`yardstick.train_readings`)."""
        got = self.kept.norms()
        steps = self.pool[self.warmup:self.warmup + self.checked]
        batches = [b for b, _ in steps]
        draws = [tuple(d) for _, d in steps]
        self.state = self.train_step = self.kept = self.pool = None
        Y.reference_mode()
        P0 = self.weights()
        trainable = {l.name for l in self.leaves if l.trainable}

        def run(**opts):
            return ref.unet_train(P0, trainable, self.ua, nets.schedule(self.config), self.config,
                                  batches, draws, block_rows=self.traffic["reference_block_rows"],
                                  **opts)

        return Y.train_readings(got, run, P0, control, fault)
