"""The end-to-end run's stage 1 alone, to see where its reconstruction
quality comes from.

    python -m image_diffusion_torch.tools.stage1_probe --bottleneck kl --seeds 0 1
    python -m image_diffusion_torch.tools.stage1_probe --bottleneck vq --seeds 0 1 \\
        --precisions bf16 fp32

Makes the run's data and dev set (`e2e_synthetic_run.make_dataset`, seeds 0
and 777) and its seed-11 random Inception, and prints the dev set's FID
against a fresh draw of the same process (seed 778): the floor a FID over
this many images reads between two real sets.  Then, for each seed and
precision, it trains the run's stage-1 VAE (`e2e_synthetic_run
.stage1_config`, `--vae-steps` at batch 48) and prints the reconstruction
FID of the dev set as the run computes it (fp32 features, KL from sampled
latents), with bf16 convolution inputs to the Inception
(`torch.autocast`: the rounding a TPU applies to f32 convolutions at its
default precision), and for KL from the posterior means; the mean
per-image reconstruction loss over the dev set; for VQ the codebook's
utilization and perplexity.  Runs on the CUDA card unless `--device cpu`.

`--channels` and `--image-size` train a reduced width at a lower image
size on the same data process; `--cpu-draws` takes each step's flips and
noise from CPU generators seeded as the trainer's own, so that a card run
and a `--device cpu` run see the same inputs; `--no-fid` skips the
Inception and prints the dev losses and VQ numbers only.  `--init-vae`
starts every run from the VAE weights (and codebook) of a model file in
place of the trainer's own seed-0 draw, e.g. the JAX trainer's initial
state written by `tests/torch_port_stage1_harness.py --write-init`;
`--init-seed K` from the port's own draw with generator seed K.

`--trace-every N` also prints, every N training steps, the step's
reconstruction and prior losses and the state of the latents over the dev
set (`trace_numbers`): their RMS and largest magnitude (KL: of the
posterior means, with the mean posterior std), and for VQ the codes the
dev set's tokens pick, the live codes (cluster size above 1e-3) and the
10/50/90% quantiles of the dead codes' norms.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..core import resolve_device
from ..core.cli import add_device_argument
from ..core.config import VAEArch
from ..core.logging import BasicLogger
from ..core.metrics import MetricHolder
from ..models.fid import FID
from ..models import build_vae
from ..models.inception import load_inception
from ..models.io import read_vae
from ..training.data import ArrayDataset
from ..training.vae_trainer import (VAEDraws, VAETrainer, draw, make_eval_step,
                                    normalize_batch)
from . import e2e_synthetic_run as e2e

LIVE = 1e-3  # a code whose (smoothed) EMA cluster size exceeds this is live


def trace_numbers(raw: np.ndarray, bottleneck: str, codes: np.ndarray | None = None,
                  cluster_size: np.ndarray | None = None,
                  embeddings: np.ndarray | None = None) -> dict:
    """The latents' state from the encoder's raw NHWC output over a probe
    set (fp32 numpy): `latent_rms` and `latent_max` (max |z|) of the
    posterior means (KL, whose log_var is clipped to [-30, 20] as in
    `VAE.encode`, adding the mean posterior std `posterior_std`) or of the
    pre-quantization latents (VQ).  VQ also takes the probe's nearest
    `codes` and the codebook's `cluster_size` and `embeddings`: the
    distinct codes the probe picks (`probe_codes`), the live codes
    (cluster size above LIVE) and the 10/50/90% quantiles of the dead
    codes' norms (NaN when none is dead)."""
    raw = np.asarray(raw, np.float64)
    out = {}
    if bottleneck == "kl":
        z, log_var = np.split(raw, 2, axis=-1)
        out["posterior_std"] = float(np.mean(np.exp(0.5 * np.clip(log_var, -30.0, 20.0))))
    else:
        z = raw
    out["latent_rms"] = float(np.sqrt(np.mean(z**2)))
    out["latent_max"] = float(np.max(np.abs(z)))
    if bottleneck == "vq":
        live = np.asarray(cluster_size) > LIVE
        norms = np.linalg.norm(np.asarray(embeddings, np.float64)[~live], axis=-1)
        out["probe_codes"] = int(len(np.unique(codes)))
        out["live_codes"] = int(live.sum())
        for q in (10, 50, 90):
            out[f"dead_norm_q{q}"] = float(np.percentile(norms, q)) if len(norms) else float("nan")
    return out


@torch.no_grad()
def vae_trace(vae, probe: np.ndarray, batch: int) -> dict:
    """`trace_numbers` of the port's VAE over the uint8 `probe` images, in
    batches of `batch` on the VAE's device."""
    device = next(vae.parameters()).device
    raws, codes = [], []
    for i in range(0, len(probe), batch):
        raw = vae._encoder(normalize_batch(torch.from_numpy(probe[i:i + batch]).to(device)))
        raws.append(raw.float().cpu().numpy())
        if vae.arch.bottleneck == "vq":
            codes.append(vae.codebook.indices(raw).cpu().numpy())
    if vae.arch.bottleneck == "kl":
        return trace_numbers(np.concatenate(raws), "kl")
    cb = vae.codebook
    return trace_numbers(np.concatenate(raws), "vq", np.concatenate(codes),
                         cb.ema_cluster_size.cpu().numpy(), cb.embeddings.weight.cpu().numpy())


def traced(vt: VAETrainer, every: int, probe: np.ndarray, emit) -> None:
    """Wrap `vt.train_step` so that after every `every`-th step `emit`
    gets {step, recon, prior, **vae_trace} (the step's losses, then the
    latents over `probe`)."""
    step_fn = vt.train_step

    def step(state, *args, **kwargs):
        metrics = step_fn(state, *args, **kwargs)
        if state.step % every == 0:
            emit({"step": state.step, "recon": float(metrics["vae/recon_loss"]),
                  "prior": float(metrics["vae/prior_loss"]),
                  **vae_trace(state.vae, probe, vt.cfg.train.batch_size)})
        return metrics

    vt.train_step = step


def cpu_draws(vt: VAETrainer) -> None:
    """Wrap `vt.train_step` so that each step's flips and noise come from a
    CPU generator seeded as the epoch's own generator, then move to the
    batch's device: the same inputs on any device."""
    step_fn, gens = vt.train_step, {}
    factor = 2 ** (len(vt.cfg.arch.channels) - 1)

    def step(state, x, gen, *args, **kwargs):
        cpu = gens.setdefault(gen.initial_seed(), torch.Generator().manual_seed(gen.initial_seed()))
        d = draw(cpu, x.shape[0], (x.shape[1] // factor, x.shape[2] // factor,
                                   vt.cfg.arch.z_dim))
        return step_fn(state, x, VAEDraws(d.flip.to(x.device), d.noise.to(x.device)), *args,
                       **kwargs)

    vt.train_step = step


def trace_line(row: dict) -> str:
    """One printed line of a trace row."""
    return "trace " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in row.items())


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bottleneck", choices=["kl", "vq"], default="kl")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--precisions", nargs="+", choices=["bf16", "fp32"], default=["bf16"])
    p.add_argument("--n-per-class", type=int, default=2000)
    p.add_argument("--vae-steps", type=int, default=500)
    p.add_argument("--fid-images", type=int, default=1002)
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--channels", type=int, nargs="+", default=None,
                   help="The VAE's channels (default: the shipped (128, 256, 384)).")
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--cpu-draws", action="store_true",
                   help="Draw each step's flips and noise on the CPU (the same inputs on any "
                        "device).")
    p.add_argument("--no-fid", action="store_true", help="Skip the Inception and the FIDs.")
    p.add_argument("--init-vae", default=None,
                   help="A VAE model file whose weights every run starts from.")
    p.add_argument("--init-seed", type=int, default=None,
                   help="Start every run from the port's own initial draw with this torch "
                        "generator seed (the trainer's is 0).")
    p.add_argument("--trace-every", type=int, default=0,
                   help="Print the losses and the latents' state over the dev set every N "
                        "training steps (0: never).")
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = tempfile.mkdtemp()
    size = args.image_size
    imgs, _ = e2e.make_dataset(args.n_per_class, size=size)
    n_dev = max(args.fid_images // 3, 90)
    dev, _ = e2e.make_dataset(n_dev, size=size, seed=777)
    arch = VAEArch(init_resolution=size,
                   **({} if args.channels is None else {"channels": tuple(args.channels)}))
    fids = {}
    if not args.no_fid:
        fresh, _ = e2e.make_dataset(n_dev, size=size, seed=778)
        weights = os.path.join(out, "inception.pt")
        e2e.random_inception_file(weights, e2e.INCEPTION_SEED)
        inception = load_inception(weights, device)

        def bf16_conv(x):
            with torch.autocast(device.type, dtype=torch.bfloat16):
                return inception(x).float()

        fids = {"fp32": FID(inception, 2048), "bf16-conv": FID(bf16_conv, 2048)}
    for name, fid in fids.items():
        e2e.ingest_dev(fid, dev, device)
        for i in range(0, len(fresh), e2e.REAL_CHUNK):
            chunk = fresh[i:i + e2e.REAL_CHUNK].astype(np.float32) / 255.0
            fid.update_fake(torch.from_numpy(chunk).to(device))
        print(f"floor: dev (seed 777) against a fresh draw (seed 778), {len(dev)} images each, "
              f"{name} features: FID {fid.compute():.3f}", flush=True)
        fid.reset_fake()

    spe = len(imgs) // args.batch
    epochs = max(args.vae_steps // spe, 1)
    eval_step = make_eval_step()

    def mean_eval_step(vae, x, noise, n_valid):
        with torch.no_grad():
            x_hat = vae(normalize_batch(x), sample=False)[0]
        return (torch.clamp(x_hat.float(), -1.0, 1.0),)

    for precision in args.precisions:
        for seed in args.seeds:
            cfg = e2e.stage1_config(arch, args.bottleneck, args.batch, epochs, out, seed=seed,
                                    precision=precision)
            run = f"{args.bottleneck}-{precision}-seed{seed}"
            vt = VAETrainer(cfg, ArrayDataset(imgs), None, BasicLogger(out, run, True, 50),
                            MetricHolder(50), run_name=run, device=device)
            if args.init_vae:
                init_arch, state = read_vae(args.init_vae)
                if init_arch != cfg.arch:
                    raise ValueError(f"{args.init_vae} holds {init_arch}, the run trains {cfg.arch}")
                vt.state.vae.load_state_dict(state)
            if args.init_seed is not None:
                vt.state.vae.load_state_dict(build_vae(
                    cfg.arch, torch.float32, "cpu", torch.Generator().manual_seed(args.init_seed))
                    .state_dict())
            if args.cpu_draws:
                cpu_draws(vt)
            if args.trace_every:
                traced(vt, args.trace_every, dev,
                       lambda row: print(f"{run}: " + trace_line(row), flush=True))
            t0 = time.time()
            vt.train()
            vae, losses = vt.state.vae, []

            def recording(*a):
                res = eval_step(*a)
                losses.append(res[1][:a[3]])
                return res

            parts = []
            for name, fid in fids.items():
                losses.clear()
                score = e2e.reconstruction_fid(vae, recording, fid, dev, args.batch, device)
                parts.append(f"recon FID {name} {score:.3f}")
                if args.bottleneck == "kl":
                    means = e2e.reconstruction_fid(vae, mean_eval_step, fid, dev, args.batch,
                                                   device)
                    parts.append(f"from the means {means:.3f}")
            if not fids:  # the dev losses alone, as the FID loop takes them
                gen, h = torch.Generator(device=device).manual_seed(9), arch.latent_resolution
                for i in range(0, len(dev), args.batch):
                    x = torch.from_numpy(e2e._padded(dev[i:i + args.batch], args.batch)).to(device)
                    noise = torch.randn((args.batch, h, h, arch.z_dim), generator=gen,
                                        device=device)
                    recording(vae, x, noise, min(args.batch, len(dev) - i))
            loss = float(torch.cat(losses).mean())
            if args.bottleneck == "vq":
                nums = e2e.vq_numbers(*e2e.code_counts(vae, dev, args.batch, device))
                parts.append(f"utilization {nums['vq_codebook_utilization']}, perplexity "
                             f"{nums['vq_dev_perplexity']}")
            print(f"{run}: {epochs * spe} steps in {time.time() - t0:.1f} s; dev recon loss "
                  f"{loss:.5f}; " + "; ".join(parts), flush=True)
            del vt, vae
            if device.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
