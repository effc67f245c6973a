"""Inference pipeline: VAE + UNet + schedule -> CFG sample grids.

Classifier-free guidance is one 2x-batched UNet call per step:
[x_t, x_t] with the conditional half carrying class ids (mask 1) and the
unconditional half class 0 with mask 0 -- exact, since mask 0 equals no
context.  The two eps halves combine in fp32.  The samplers are plain
Python loops over the steps; the final VAE decode re-quantizes for VQ
bundles.

Grid semantics: every class at every guidance scale, scale-major rows
(row s holds classes 0..K-1 at scale s).

Randomness comes from an explicit `torch.Generator` (or, for
`sample_batch`, an explicit step-noise block), since torch cannot
reproduce the JAX package's random streams.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..compat.from_jax import unet_flax_params, unet_state_dict, vae_flax_variables, vae_state_dict
from ..core import checkpoint as ckpt
from ..core import resolve_device
from ..core.config import ScheduleConfig, UNetArch, VAEArch, _build
from ..models import build_unet, build_vae
from ..ops import schedule as S


def to_uint8(imgs: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8 pixels: clip((x + 1) / 2) * 255, truncated
    (the JAX package's op order, so the bytes match)."""
    x = imgs.float()
    return (torch.clamp((x + 1.0) / 2.0, 0.0, 1.0) * 255.0).to(torch.uint8)


class DiffusionPipeline:
    """Composes VAE + UNet + schedule + class vocabulary for sampling.

    `vae_state` / `unet_state` are the port's state dicts (see
    `compat.from_jax` for the flax layout).  Weights are held in the
    compute dtype, so in bf16 mode `to_checkpoint` writes bf16-rounded
    weights (stored as fp32, as the format has it)."""

    def __init__(self, vae_arch: VAEArch, vae_state: Mapping[str, torch.Tensor],
                 unet_arch: UNetArch, unet_state: Mapping[str, torch.Tensor],
                 schedule_cfg: ScheduleConfig, classes: Sequence[str] | str,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.vae_arch, self.unet_arch, self.schedule_cfg = vae_arch, unet_arch, schedule_cfg
        self.dtype = dtype
        self.vae = build_vae(vae_arch, dtype=dtype, device=self.device)
        self.vae.load_state_dict(vae_state)
        self.unet = build_unet(unet_arch, dtype=dtype, device=self.device)
        self.unet.load_state_dict(unet_state)
        self.sched = S.make_schedule(schedule_cfg.num_steps, schedule_cfg.beta_start,
                                     schedule_cfg.beta_end, schedule_cfg.noise_type,
                                     device=self.device)
        self.classes = classes.split(",") if isinstance(classes, str) else list(classes)

    @property
    def latent_shape(self) -> tuple[int, int, int]:
        """(h, w, z) of the latents."""
        r = self.vae_arch.latent_resolution
        return (r, r, self.unet_arch.z_dim)

    @torch.inference_mode()
    def sample_batch(self, labels, cfg_scales, x_init, sampler: str = "dpm",
                     num_inference_steps: int | None = None, eta: float = 0.0,
                     generator: torch.Generator | None = None,
                     noise: torch.Tensor | None = None, output: str = "float32") -> torch.Tensor:
        """Sample one explicit batch: per-row class labels, guidance scales
        and initial latents (B, h, w, z) -> (B, H, W, 3) images in [-1, 1]
        (`output="float32"`) or as uint8 pixels (`output="uint8"`).

        sampler: "ddpm" (the schedule's full ancestral chain), "ddim" or
        "dpm" (DPM-Solver++(2M)) over `num_inference_steps` (default 50 for
        ddim, 20 for dpm).  The stochastic samplers (ddpm; ddim with
        eta > 0) take step noise from `noise`, a (T, B, h, w, z) block whose
        row i is used at step i, or else draw it from `generator`."""
        if output not in ("float32", "uint8"):
            raise ValueError(f"unknown output {output!r}; expected 'float32' or 'uint8'")
        dev = self.device
        x = torch.as_tensor(x_init, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).to(dev, torch.int64)
        B = x.shape[0]
        scales = torch.as_tensor(cfg_scales, dtype=torch.float32).to(dev).reshape(B, 1, 1, 1)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)

        ctx = torch.cat([labels, torch.zeros_like(labels)])
        mask = torch.cat([torch.ones(B, 1), torch.zeros(B, 1)]).to(dev)

        def eps_fn(xt, t):
            t2 = torch.full((2 * B,), t, dtype=torch.int64, device=dev)
            eps2 = self.unet(torch.cat([xt, xt]), t2, ctx, mask).float()
            eps_c, eps_u = eps2[:B], eps2[B:]
            return eps_u + scales * (eps_c - eps_u)

        def step_noise(i):
            if noise is not None:
                return noise[i]
            if generator is None:
                raise ValueError(f"sampler {sampler!r} needs `noise` or a `generator`")
            return torch.randn(x.shape, generator=generator, device=dev)

        def tvec(t):
            return torch.full((B,), t, dtype=torch.int64, device=dev)

        if sampler == "ddpm":
            for i, t in enumerate(range(self.sched.num_steps - 1, -1, -1)):
                x, _ = S.ddpm_step(self.sched, x, eps_fn(x, t), tvec(t), step_noise(i))
        elif sampler in ("ddim", "dpm"):
            n = num_inference_steps or (20 if sampler == "dpm" else 50)
            ts = S.make_timesteps(self.sched.num_steps, n).tolist()
            pairs = list(zip(ts, ts[1:] + [-1]))
            if sampler == "ddim":
                for i, (t, t_prev) in enumerate(pairs):
                    z = step_noise(i) if eta else torch.zeros_like(x)
                    x, _ = S.ddim_step(self.sched, x, eps_fn(x, t), tvec(t), tvec(t_prev), z, eta)
            else:
                x0_prev, h_prev = torch.zeros_like(x), -1.0
                for t, t_prev in pairs:
                    x, x0_prev, h_prev = S.dpmpp_2m_step(
                        self.sched, x, eps_fn(x, t), tvec(t), tvec(t_prev), x0_prev, h_prev)
        else:
            raise ValueError(f"unknown sampler {sampler!r}")

        imgs = self.vae.decode(x, quantize=self.vae_arch.bottleneck == "vq")
        return to_uint8(imgs) if output == "uint8" else imgs.float()

    def sample(self, cfg_scales: Sequence[float] | float, num_images: int = 10,
               seed: int | None = None, sampler: str = "ddpm",
               num_inference_steps: int | None = None, eta: float = 0.0,
               output: str = "float32") -> torch.Tensor:
        """Sample a classes x scales grid -> (B, H, W, 3) images.

        A list of scales gives every class at every scale (B = classes x
        scales, scale-major rows); a scalar gives `num_images` per class at
        that scale.  Initial latents and step noise come from one generator
        seeded with `seed` (0 when None) on the pipeline's device."""
        if not isinstance(cfg_scales, (list, tuple)):
            cfg_scales = [float(cfg_scales)] * num_images
        n_classes, n_scales = len(self.classes), len(cfg_scales)
        labels = torch.arange(n_classes).repeat(n_scales)
        scales = torch.tensor(cfg_scales, dtype=torch.float32).repeat_interleave(n_classes)
        gen = torch.Generator(device=self.device).manual_seed(0 if seed is None else seed)
        x_init = torch.randn((n_classes * n_scales, *self.latent_shape), generator=gen,
                             device=self.device)
        return self.sample_batch(labels, scales, x_init, sampler=sampler,
                                 num_inference_steps=num_inference_steps, eta=eta,
                                 generator=gen, output=output)

    # ------------------------------------------------------------------ io

    def to_checkpoint(self, path: str) -> None:
        """Write an inference bundle in the JAX package's layout."""
        ckpt.save_checkpoint(
            path,
            architecture={
                "vae": self.vae_arch.to_dict(),
                "unet": self.unet_arch.to_dict(),
                "scheduler": self.schedule_cfg.to_dict(),
                "classes": ",".join(self.classes),
            },
            vae=vae_flax_variables(self.vae.state_dict()),
            unet={"params": unet_flax_params(self.unet.state_dict())},
        )

    @classmethod
    def from_checkpoint(cls, path: str, dtype: torch.dtype = torch.bfloat16,
                        device="cuda") -> "DiffusionPipeline":
        """Load an inference bundle written by either package."""
        trees, meta = ckpt.load_checkpoint(path)
        arch = meta["architecture"]
        return cls(
            _build(VAEArch, arch["vae"]),
            vae_state_dict(trees["vae"]),
            _build(UNetArch, arch["unet"]),
            unet_state_dict(trees["unet"]["params"]),
            _build(ScheduleConfig, arch["scheduler"]),
            arch["classes"],
            dtype=dtype,
            device=device,
        )
