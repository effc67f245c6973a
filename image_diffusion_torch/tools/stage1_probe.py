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
from ..models.inception import load_inception
from ..training.data import ArrayDataset
from ..training.vae_trainer import VAETrainer, make_eval_step, normalize_batch
from . import e2e_synthetic_run as e2e


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bottleneck", choices=["kl", "vq"], default="kl")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--precisions", nargs="+", choices=["bf16", "fp32"], default=["bf16"])
    p.add_argument("--n-per-class", type=int, default=2000)
    p.add_argument("--vae-steps", type=int, default=500)
    p.add_argument("--fid-images", type=int, default=1002)
    p.add_argument("--batch", type=int, default=48)
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = tempfile.mkdtemp()
    imgs, _ = e2e.make_dataset(args.n_per_class)
    n_dev = max(args.fid_images // 3, 90)
    dev, _ = e2e.make_dataset(n_dev, seed=777)
    fresh, _ = e2e.make_dataset(n_dev, seed=778)
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
            cfg = e2e.stage1_config(VAEArch(), args.bottleneck, args.batch, epochs, out, seed=seed,
                                    precision=precision)
            run = f"{args.bottleneck}-{precision}-seed{seed}"
            vt = VAETrainer(cfg, ArrayDataset(imgs), None, BasicLogger(out, run, True, 50),
                            MetricHolder(50), run_name=run, device=device)
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
