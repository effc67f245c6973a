"""Steps of the stage-1 VAE-GAN trainer on uint8 images, the
discriminator active.

A unit is one call of the train step `make_vae_train_step` builds, on the
`VAETrainState` that `VAETrainer` builds, at the traffic's `batch_size`:
the VAE and the PatchGAN on fp32 parameters computing in the compute
dtype, LPIPS in the compute dtype, a clip-and-Adam optimizer each (only
the VAE's warms up).  Its inputs are a pool of `pool_batches` batches on
the card, made from the seed: 128x128 uint8 images (smooth random fields:
bilinear 16x16 noise plus fine noise) and each batch's draws (`VAEDraws`:
flips and reparametrization noise).  Unit i takes pool entry i mod
`pool_batches`.  The weights, LPIPS's included, are drawn on the card from
the seed.

Set-up runs `warmup_units` units, then sets the models, their buffers and
both optimizers back to the start, as `train_unet.py` does, so the
window's first `checked_steps` units are the training state's first
steps, each on its own batch: the check keeps each step's discriminator,
adversarial, reconstruction, perceptual and KL losses, the first step's
gradients as the two optimizers took them, and the parameters' change
over those steps, by leaf ("vae.<name>", "disc.<name>").  The numbers
compared are the median leaf's distance of the first gradient from the
reference's (first_grad_dist.median) and the median leaf's gap of the
change's norm (change_gap.median): here the gradients' norms alone part
the program from the control too little.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import yardstick as Y
from reference import nets, steps as ref

RATE = ("train_samples_per_s", "samples/s")
LOSSES = {"d_loss": "gan/d_loss", "g_loss": "gan/g_loss", "recon_loss": "vae/recon_loss",
          "percept_loss": "vae/percept_loss", "prior_loss": "vae/prior_loss"}


def named_leaves(vae: dict, disc: dict) -> dict:
    """One dict of the two models' tensors, as "vae.<name>" and "disc.<name>"."""
    return {**{f"vae.{k}": v for k, v in vae.items()}, **{f"disc.{k}": v for k, v in disc.items()}}


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from image_diffusion_torch.core.config import VAEArch, VAEConfig, VAETrainConfig, _build
        from image_diffusion_torch.models import build_discriminator, build_vae
        from image_diffusion_torch.models.lpips import LPIPS
        from image_diffusion_torch.training.diffusion_trainer import Optimizer
        from image_diffusion_torch.training.vae_trainer import (VAEDraws, VAETrainState,
                                                                make_vae_train_step)

        Y.mark("program imported")

        if not traffic["disc_active"]:
            raise ValueError("the reference states the step with the discriminator active")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        cfg = VAEConfig(arch=_build(VAEArch, config),
                        train=_build(VAETrainConfig, {**config, "batch_size": traffic["batch_size"]}))
        tc, dtype = cfg.train, getattr(torch, config["compute_dtype"])
        self.vleaves = nets.vae_leaves(config)
        self.dleaves = nets.disc_leaves(config["disc_channels"])
        Pv, Pd, W = self.weights()
        vae = build_vae(cfg.arch, dtype, device, param_dtype=torch.float32).train()
        vae.load_state_dict(Pv)
        disc = build_discriminator(tuple(config["disc_channels"]), dtype, device)
        disc.load_state_dict(Pd)
        n_lpips = len(nets.VGG16_STAGES)
        convs = [(W[f"conv.{i}.weight"], W[f"conv.{i}.bias"])
                 for i in range(sum(n for _, n in nets.VGG16_STAGES))]
        percept = LPIPS(convs, [W[f"lin.{k}"] for k in range(n_lpips)]).astype(dtype).to(device)
        self.state = VAETrainState(
            vae, disc, Optimizer(vae.parameters(), tc.learning_rate, tc.warmup_steps, tc.clip_grad),
            Optimizer(disc.parameters(), tc.learning_rate, 0, tc.clip_grad))
        self.train_step = make_vae_train_step(cfg, percept)
        Y.mark("weights drawn, models built")

        self.B, H, r = tc.batch_size, config["init_resolution"], nets.latent_res(config)
        g = torch.Generator(device=device)
        g.manual_seed(Y.derive_seed(seed, "data"))
        kw = dict(generator=g, device=device)
        self.pool = []
        for _ in range(traffic["pool_batches"]):
            coarse = F.interpolate(torch.rand((self.B, 3, 16, 16), **kw), size=(H, H),
                                   mode="bilinear", align_corners=False)
            img = torch.clamp(coarse + 0.1 * torch.randn((self.B, 3, H, H), **kw), 0.0, 1.0)
            u8 = (img * 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
            draws = VAEDraws(torch.rand((self.B,), **kw) < 0.5,
                             torch.randn((self.B, r, r, config["z_dim"]), **kw))
            self.pool.append((u8, draws))
        Y.mark("inputs made")
        self.warmup, self.checked = traffic["warmup_units"], traffic["checked_steps"]
        if self.warmup + self.checked > len(self.pool):
            raise ValueError("the warm-up and the checked steps take a batch each")
        self.units, self.min_units = 0, self.checked

        self.unit_items, self.unit_steps = self.B, 1
        self.unit_flops = self.B * config["flops"]["vae_gan_step_per_image"]
        sites = [s for part in Y.vae_attention_sites(config).values() for s in part]
        self.unit_attention = ([Y.attention_forward(self.B, N, C) for N, C in sites]
                               + [Y.attention_backward(self.B, N, C) for N, C in sites])

        del Pv, Pd, W
        self.kept = Y.WindowSteps(named_leaves(dict(vae.named_parameters()),
                                               dict(disc.named_parameters())),
                                  [*vae.buffers(), *disc.buffers()], self.checked)
        for _ in range(self.warmup):
            self.run_unit()
        self.kept.rewind([self.state.vae_opt, self.state.disc_opt])
        Y.mark("warmed")

    def weights(self) -> tuple[dict, dict, dict]:
        """The VAE's, the discriminator's and LPIPS's weights from the seed."""
        return tuple(nets.make_weights(leaves, Y.derive_seed(self.seed, tag), self.device)
                     for leaves, tag in ((self.vleaves, "vae"), (self.dleaves, "disc"),
                                         (nets.lpips_leaves(), "lpips")))

    def run_unit(self) -> None:
        u8, draws = self.pool[self.units % len(self.pool)]
        metrics = self.train_step(self.state, u8, draws, True)
        self.units += 1
        if self.units > self.warmup:
            self.kept.after_step({k: metrics[v] for k, v in LOSSES.items()})

    def check(self, control: bool = False, fault: str | None = None) -> dict:
        """The compared numbers of the program (see the module doc), and
        with `control` or `fault` the control's or a planted fault's
        (`yardstick.train_readings`)."""
        got = self.kept.norms()
        steps = self.pool[self.warmup:self.warmup + self.checked]
        images = [u8 for u8, _ in steps]
        draws = [tuple(d) for _, d in steps]
        self.state = self.train_step = self.kept = self.pool = None
        Y.reference_mode()
        Pv, Pd, W = self.weights()
        start = named_leaves(Pv, Pd)

        def run(**opts):
            return ref.vae_gan_train(Pv, {l.name for l in self.vleaves if l.trainable}, self.config,
                                     Pd, {l.name for l in self.dleaves if l.trainable}, W,
                                     self.config, images, draws, **opts)

        return Y.train_readings(got, run, start, control, fault)
