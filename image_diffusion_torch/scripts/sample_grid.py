"""CFG sample grid from a bundle, the port's counterpart of
scripts/sample_grid.py (the headline workload).

    python -m image_diffusion_torch.scripts.sample_grid checkpoints/bundle.ckpt \
        --cfg 1 10 --seed 0 --out out.png

Every class at every guidance scale in `--cfg`'s half-open range, through
the 1000-step DDPM chain by default (27 images, one 54-row UNet call a
step, for the shipped three classes).  Runs on the CUDA card unless
`--device cpu` is given.  Not ported yet: `--data-parallel` (multi-GPU
sampling).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

from ..core.cli import add_device_argument, setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", type=str, help="Path to a Diffusion bundle checkpoint.")
    p.add_argument("--cfg", type=int, nargs=2, default=[1, 10],
                   help="Half-open range of CFG scales, e.g. --cfg 1 10 -> scales 1..9.")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", type=str, default="./out.png")
    p.add_argument("--sampler", choices=["ddpm", "ddim", "dpm"], default="ddpm",
                   help="ddpm: the full 1000-step ancestral sampler; "
                        "ddim: fast subsequence sampling (see --steps/--eta); "
                        "dpm: DPM-Solver++(2M), high quality in ~20 steps.")
    p.add_argument("--steps", type=int, default=None,
                   help="Inference steps for ddim/dpm (default: 50 for ddim, "
                        "20 for dpm; ddpm always runs the full schedule).")
    p.add_argument("--eta", type=float, default=0.0, help="DDIM stochasticity.")
    p.add_argument("--progress", action="store_true", help="Per-step progress bar.")
    add_device_argument(p)
    return p.parse_args(argv)


def sample(args):
    """Load the bundle and sample the grid -> (pipeline, scales, images
    (B, H, W, 3) fp32 in [-1, 1] on the host, seconds).  The seconds end
    with the images' copy to the host, which waits for the card."""
    from ..pipelines import DiffusionPipeline

    pipeline = DiffusionPipeline.from_checkpoint(args.model, device=args.device)
    cfg_scales = list(range(args.cfg[0], args.cfg[1]))
    n = len(cfg_scales) * len(pipeline.classes)
    logging.info(f"Sampling {n} images ({len(pipeline.classes)} classes x {len(cfg_scales)} scales).")

    t0 = time.perf_counter()
    images = pipeline.sample(cfg_scales, seed=args.seed, sampler=args.sampler,
                             num_inference_steps=args.steps, eta=args.eta,
                             progress=args.progress).cpu()
    dt = time.perf_counter() - t0
    logging.info(f"Sampled {n} images in {dt:.2f}s ({n / dt:.2f} img/s).")
    return pipeline, cfg_scales, images, dt


def main(argv=None):
    args = parse_args(argv)
    setup_logging()

    from ..core.plotting import plot_cfg_grid, pyplot

    pyplot()  # without matplotlib, fail before sampling
    pipeline, cfg_scales, images, _ = sample(args)
    fig = plot_cfg_grid(images.numpy(), pipeline.classes, cfg_scales)
    dirname = os.path.dirname(args.out)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    fig.savefig(args.out, bbox_inches="tight", pad_inches=0)
    logging.info(f"Saved grid to {args.out}")


if __name__ == "__main__":
    main()
