"""Inference pipeline: VAE + UNet + schedule -> CFG sample grids.

The denoiser is the UNet or DiT (`DiTArch`), by the architecture it is
given.  Classifier-free guidance is one 2x-batched denoiser call per step:
[x_t, x_t] with the conditional half carrying class ids (mask 1) and the
unconditional half class 0 with mask 0 -- exact for the UNet, since mask 0
equals no context, and DiT's null class (its last label row) for DiT.  A
learned-sigma DiT's output is eps, then the variance interpolation; the
samplers read eps alone, so the ancestral "ddpm" sampler, whose variance
such a model learns, is refused.  The two eps halves combine in fp32 over
every latent channel.  The samplers are plain Python loops over the steps
and clamp their x0 estimate unless the schedule says `clip_denoised:
false`; the latents are divided by the VAE's `latent_scale` (when not 1)
before the final decode, which re-quantizes for VQ bundles.

Grid semantics: every class at every guidance scale, scale-major rows
(row s holds classes 0..K-1 at scale s).

Randomness comes from an explicit `torch.Generator` (or, for
`sample_batch`, an explicit step-noise block or one generator per row),
since torch cannot reproduce the JAX package's random streams.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Sequence

import torch

from ..compat.from_jax import unet_flax_params, unet_state_dict, vae_flax_variables, vae_state_dict
from ..core import checkpoint as ckpt
from ..core import resolve_device
from ..core.config import DiTArch, ScheduleConfig, UNetArch, VAEArch, _build
from ..core.profiling import span
from ..core.progress import progress as progress_bar
from ..models import build_denoiser, build_vae
from ..ops import schedule as S
from ..parallel.mesh import global_row_draw, pad_to_multiple


def to_uint8(imgs: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8 pixels: clip((x + 1) / 2) * 255, truncated
    (the JAX package's op order, so the bytes match)."""
    x = imgs.float()
    return (torch.clamp((x + 1.0) / 2.0, 0.0, 1.0) * 255.0).to(torch.uint8)


def _host_fp32(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32) for k, v in state.items()}


def _port_tree(state: Mapping[str, torch.Tensor]) -> dict:
    """A state dict as a bundle tree under the port's own keys (fp32)."""
    return {k: v.numpy() for k, v in state.items()}


def _port_state(tree: Mapping) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _indexed(device: str | torch.device) -> torch.device:
    """`device` with the current card's index when a CUDA one has none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _generator_copy(g: torch.Generator, device: torch.device) -> torch.Generator:
    """A generator on `device` in `g`'s state (a CUDA generator's state
    moves between cards)."""
    out = torch.Generator(device=device)
    out.set_state(g.get_state())
    return out


class DiffusionPipeline:
    """Composes VAE + UNet + schedule + class vocabulary for sampling.

    `vae_state` / `unet_state` are the port's state dicts (see
    `compat.from_jax` for the flax layout); `unet_arch` is a `UNetArch` or
    a `DiTArch`, and `unet` the denoiser it builds.  The models compute in
    `dtype`; the pipeline also keeps the weights it was given as fp32
    copies on the host, and `to_checkpoint` writes those, so a bundle
    read at bf16 and written back is unchanged (the JAX package writes the
    variables it was given likewise)."""

    def __init__(self, vae_arch: VAEArch, vae_state: Mapping[str, torch.Tensor],
                 unet_arch: UNetArch | DiTArch, unet_state: Mapping[str, torch.Tensor],
                 schedule_cfg: ScheduleConfig, classes: Sequence[str] | str,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.vae_arch, self.unet_arch, self.schedule_cfg = vae_arch, unet_arch, schedule_cfg
        self.dtype = dtype
        self.vae_state, self.unet_state = _host_fp32(vae_state), _host_fp32(unet_state)
        self.vae = build_vae(vae_arch, dtype=dtype, device=self.device)
        self.vae.load_state_dict(vae_state)
        self.unet = build_denoiser(unet_arch, dtype=dtype, device=self.device)
        self.unet.load_state_dict(unet_state)
        self.sched = S.make_schedule(schedule_cfg.num_steps, schedule_cfg.beta_start,
                                     schedule_cfg.beta_end, schedule_cfg.noise_type,
                                     device=self.device)
        self.classes = classes.split(",") if isinstance(classes, str) else list(classes)
        self._replicas: dict[torch.device, tuple] = {}
        self._replica_lock = threading.Lock()

    @property
    def learned_sigma(self) -> bool:
        """The denoiser's output holds a learned variance after eps."""
        return isinstance(self.unet_arch, DiTArch) and self.unet_arch.learn_sigma

    @property
    def latent_shape(self) -> tuple[int, int, int]:
        """(h, w, z) of the latents."""
        r = self.vae_arch.latent_resolution
        return (r, r, self.unet_arch.z_dim)

    def _models(self, device: torch.device) -> tuple:
        """(unet, vae, schedule) on `device`: the pipeline's own on its
        device, else a replica of them made at first use and kept."""
        if _indexed(device) == _indexed(self.device):
            return self.unet, self.vae, self.sched
        with self._replica_lock:
            if device not in self._replicas:
                sc = self.schedule_cfg
                self._replicas[device] = (
                    copy.deepcopy(self.unet).to(device), copy.deepcopy(self.vae).to(device),
                    S.make_schedule(sc.num_steps, sc.beta_start, sc.beta_end, sc.noise_type,
                                    device=device))
            return self._replicas[device]

    @torch.inference_mode()
    def sample_batch(self, labels, cfg_scales, x_init, sampler: str = "dpm",
                     num_inference_steps: int | None = None, eta: float = 0.0,
                     generator: torch.Generator | None = None,
                     noise: torch.Tensor | None = None,
                     row_generators: Sequence[torch.Generator] | None = None,
                     output: str = "float32", progress: bool = False,
                     devices: Sequence[str | torch.device] | None = None) -> torch.Tensor:
        """Sample one explicit batch: per-row class labels, guidance scales
        and initial latents (B, h, w, z) -> (B, H, W, 3) images in [-1, 1]
        (`output="float32"`) or as uint8 pixels (`output="uint8"`).

        sampler: "ddpm" (the schedule's full ancestral chain), "ddim" or
        "dpm" (DPM-Solver++(2M)) over `num_inference_steps` (default 50 for
        ddim, 20 for dpm).  The stochastic samplers (ddpm; ddim with
        eta > 0) take step noise from `noise`, a (T, B, h, w, z) block whose
        row i is used at step i; or else from `row_generators`, B generators
        on the pipeline's device, row i's (h, w, z) noise drawn from
        generator i alone at each step, in sequence after whatever the
        caller drew from it before (serving draws the row's initial latent
        first), so a row's noise at step s depends on its generator's seed
        and s only, never on its batch or slot; or else, one batch-shaped
        draw a step, from `generator`.  `progress` shows a per-step bar
        (`core.progress`).

        `devices` (a list of local devices, repeats allowed; default the
        pipeline's device alone) shards the batch: padded with wrap-around
        rows to a multiple of their number, each shard samples its block of
        rows with its device's models (the pipeline's own on its device,
        elsewhere replicas copied at first use), one thread a distinct
        device running its shards in turn, and
        the unpadded batch comes back in order on the pipeline's device,
        equal to the unsharded result up to fp reassociation.  A row's
        initial latent, label, scale, noise rows and generator go with it
        (a pad row gets a copy of its generator's state); `generator`'s
        draws are made at the unpadded batch's shape on every shard, which
        keeps its rows (`parallel.mesh.global_row_draw`)."""
        with span("sample.call", rows=len(x_init)):
            if output not in ("float32", "uint8"):
                raise ValueError(f"unknown output {output!r}; expected 'float32' or 'uint8'")
            if sampler == "ddpm" and self.learned_sigma:
                raise ValueError("the ddpm sampler needs the learned posterior variance, which "
                                 "is not ported; use ddim or dpm")
            x = torch.as_tensor(x_init, dtype=torch.float32)
            B = x.shape[0]
            labels = torch.as_tensor(labels).to(torch.int64)
            scales = torch.as_tensor(cfg_scales, dtype=torch.float32).reshape(B)
            if noise is not None:
                noise = torch.as_tensor(noise, dtype=torch.float32)
            if row_generators is not None and len(row_generators) != B:
                raise ValueError(f"{len(row_generators)} row generators for a batch of {B}")
            run = dict(sampler=sampler, n_steps=num_inference_steps, eta=eta, output=output)
            devices = [_indexed(d) for d in (devices or [self.device])]
            n = len(devices)
            share = pad_to_multiple(B, n) // n
            order = torch.arange(share * n) % B  # the padded batch: rows wrap around

            def own(g: torch.Generator, dev: torch.device, pad: bool) -> torch.Generator:
                # a row's own generator where it can draw (so it advances as
                # unsharded), else a copy of its state
                return g if not pad and _indexed(g.device) == dev else _generator_copy(g, dev)

            shards = []
            for k, dev in enumerate(devices):
                rows = order[k * share:(k + 1) * share]
                gens = None
                if row_generators is not None:
                    gens = [own(row_generators[int(r)], dev, i >= B)
                            for i, r in zip(range(k * share, (k + 1) * share), rows)]
                draw = None
                if generator is not None:
                    g = own(generator, dev, k > 0)

                    def draw(i, g=g, dev=dev, rows=rows if n > 1 else None):
                        return global_row_draw(
                            lambda: torch.randn(x.shape, generator=g, device=dev), rows)
                shards.append((dev, x[rows].to(dev), labels[rows].to(dev), scales[rows].to(dev),
                               None if noise is None else noise[:, rows].to(dev), gens, draw))

            def work(dev: torch.device) -> dict[int, torch.Tensor]:
                # one thread a device runs that device's shards in turn
                with torch.inference_mode(), (torch.cuda.device(dev) if dev.type == "cuda"
                                              else contextlib.nullcontext()):
                    return {k: self._sample(*shards[k], progress=progress and k == 0, **run)
                            for k in range(n) if devices[k] == dev}

            distinct = list(dict.fromkeys(devices))
            ctx = [contextvars.copy_context() for _ in distinct]  # the caller's site log
            outs: dict[int, torch.Tensor] = {}
            with ThreadPoolExecutor(max_workers=len(distinct)) as pool:
                futures = [pool.submit(c.run, work, dev) for c, dev in zip(ctx, distinct)]
                for f in futures:
                    outs.update(f.result())
            return torch.cat([outs[k].to(self.device) for k in range(n)])[:B]

    def _sample(self, dev: torch.device, x, labels, scales, noise, row_generators, draw,
                sampler: str, n_steps: int | None, eta: float, output: str,
                progress: bool) -> torch.Tensor:
        """The sampler loop and the decode on `dev`'s models, the inputs
        there: `noise` a step-noise block or None, `row_generators` one
        generator a row or None, `draw(i)` step i's batch-shaped noise or
        None (see `sample_batch`)."""
        unet, vae, sched = self._models(dev)
        B = x.shape[0]
        scales = scales.reshape(B, 1, 1, 1)
        ctx = torch.cat([labels, torch.zeros_like(labels)])
        mask = torch.cat([torch.ones(B, 1), torch.zeros(B, 1)]).to(dev)
        z_dim, clip = self.unet_arch.z_dim, self.schedule_cfg.clip_denoised

        def eps_fn(xt, t):
            t2 = torch.full((2 * B,), t, dtype=torch.int64, device=dev)
            out = unet(torch.cat([xt, xt]), t2, ctx, mask)
            eps2 = (out[..., :z_dim] if self.learned_sigma else out).float()
            eps_c, eps_u = eps2[:B], eps2[B:]
            return eps_u + scales * (eps_c - eps_u)

        def step_noise(i):
            if noise is not None:
                return noise[i]
            if row_generators is not None:
                return torch.stack([torch.randn(x.shape[1:], generator=g, device=dev)
                                    for g in row_generators])
            if draw is None:
                raise ValueError(f"sampler {sampler!r} needs `noise`, `row_generators` or a "
                                 "`generator`")
            return draw(i)

        def tvec(t):
            return torch.full((B,), t, dtype=torch.int64, device=dev)

        def steps(it):
            return progress_bar(it, total=len(it), desc="sampling") if progress else it

        if sampler == "ddpm":
            for i, t in enumerate(steps(range(sched.num_steps - 1, -1, -1))):
                with span("sample.step"):
                    x, _ = S.ddpm_step(sched, x, eps_fn(x, t), tvec(t), step_noise(i))
        elif sampler in ("ddim", "dpm"):
            n = n_steps or (20 if sampler == "dpm" else 50)
            ts = S.make_timesteps(sched.num_steps, n).tolist()
            pairs = list(zip(ts, ts[1:] + [-1]))
            if sampler == "ddim":
                for i, (t, t_prev) in enumerate(steps(pairs)):
                    with span("sample.step"):
                        z = step_noise(i) if eta else torch.zeros_like(x)
                        x, _ = S.ddim_step(sched, x, eps_fn(x, t), tvec(t), tvec(t_prev), z,
                                           eta, clip)
            else:
                x0_prev, h_prev = torch.zeros_like(x), -1.0
                for t, t_prev in steps(pairs):
                    with span("sample.step"):
                        x, x0_prev, h_prev = S.dpmpp_2m_step(
                            sched, x, eps_fn(x, t), tvec(t), tvec(t_prev), x0_prev, h_prev, clip)
        else:
            raise ValueError(f"unknown sampler {sampler!r}")

        with span("sample.decode"):
            if self.vae_arch.latent_scale != 1.0:
                x = x / self.vae_arch.latent_scale
            imgs = vae.decode(x, quantize=self.vae_arch.bottleneck == "vq")
            return to_uint8(imgs) if output == "uint8" else imgs.float()

    def sample(self, cfg_scales: Sequence[float] | float, num_images: int = 10,
               seed: int | None = None, sampler: str = "ddpm",
               num_inference_steps: int | None = None, eta: float = 0.0,
               output: str = "float32", progress: bool = False,
               devices: Sequence[str | torch.device] | None = None) -> torch.Tensor:
        """Sample a classes x scales grid -> (B, H, W, 3) images.

        A list of scales gives every class at every scale (B = classes x
        scales, scale-major rows); a scalar gives `num_images` per class at
        that scale.  Initial latents and step noise come from one generator
        seeded with `seed` (0 when None) on the pipeline's device, drawn at
        the grid's shape; `progress` and `devices` as in `sample_batch` (3
        images on 8 devices pad to 8 rows)."""
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
                                 generator=gen, output=output, progress=progress,
                                 devices=devices)

    # ------------------------------------------------------------------ io

    def to_checkpoint(self, path: str) -> None:
        """Write an inference bundle in the JAX package's layout, or, for a
        DiT (which the JAX package has not), the port's own: the same file
        format and metadata, the denoiser under "dit", both trees keyed by
        the port's state-dict names."""
        if isinstance(self.unet_arch, DiTArch):
            ckpt.save_checkpoint(
                path,
                architecture={"vae": self.vae_arch.to_dict(), "dit": self.unet_arch.to_dict(),
                              "scheduler": self.schedule_cfg.to_dict(),
                              "classes": ",".join(self.classes)},
                vae=_port_tree(self.vae_state), dit=_port_tree(self.unet_state))
            return
        ckpt.save_checkpoint(
            path,
            architecture={
                "vae": self.vae_arch.to_dict(),
                "unet": self.unet_arch.to_dict(),
                "scheduler": self.schedule_cfg.to_dict(),
                "classes": ",".join(self.classes),
            },
            vae=vae_flax_variables(self.vae_state),
            unet={"params": unet_flax_params(self.unet_state)},
        )

    @classmethod
    def from_checkpoint(cls, path: str, dtype: torch.dtype = torch.bfloat16,
                        device="cuda") -> "DiffusionPipeline":
        """Load an inference bundle written by either package."""
        trees, meta = ckpt.load_checkpoint(path)
        arch = meta["architecture"]
        if "dit" in arch:
            return cls(_build(VAEArch, arch["vae"]), _port_state(trees["vae"]),
                       _build(DiTArch, arch["dit"]), _port_state(trees["dit"]),
                       _build(ScheduleConfig, arch["scheduler"]), arch["classes"],
                       dtype=dtype, device=device)
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
