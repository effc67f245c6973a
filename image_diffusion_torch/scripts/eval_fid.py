"""Generative FID of a bundle, the port's counterpart of scripts/eval_fid.py.

    python -m image_diffusion_torch.scripts.eval_fid checkpoints/bundle.ckpt \
        --real ./data/vqgan/dev.npy --fid-weights ./pt_inception-2015-12-05.pth \
        --num-images 2700 --cfg 3 --sampler ddim --steps 50

Samples `--num-images` images from the bundle (DDIM by default) and
computes their FID against a .npy of real uint8 NHWC images with
InceptionV3's pool3 features (`models/inception.py`; the weights come from
a local file).  The real images go in chunks of min(256, n_real), the
tail padded and counted by its valid rows; at most `--max-real` of them.
Each sampling call is every class at `--cfg`, `--batch // classes` images
each, seeds 0, 1, 2, ...; the last call keeps what is still missing.  The
FID is the last line printed.  Runs on the CUDA card unless `--device cpu`
is given.  Not ported yet: `--data-parallel` (multi-GPU sampling).
"""

from __future__ import annotations

import argparse
import logging
import time

from ..core.cli import add_device_argument, setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", type=str, help="Diffusion bundle checkpoint.")
    p.add_argument("--real", type=str, required=True, help=".npy of real uint8 images (NHWC).")
    p.add_argument("--fid-weights", type=str, required=True,
                   help="torch-format InceptionV3 weights (torchvision naming).")
    p.add_argument("--num-images", type=int, default=2700)
    p.add_argument("--cfg", type=float, default=3.0, help="Guidance scale.")
    p.add_argument("--sampler", choices=["ddpm", "ddim", "dpm"], default="ddim")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--batch", type=int, default=64, help="Images per sampling call.")
    p.add_argument("--max-real", type=int, default=10000)
    add_device_argument(p)
    return p.parse_args(argv)


def ingest_real(fid, path: str, max_real: int, device) -> int:
    """Add the first min(len, `max_real`) images of the .npy at `path` to
    `fid`'s real statistics, in chunks of min(256, n) with the tail padded
    -> n.  Fewer than 2 raise SystemExit."""
    import numpy as np
    import torch

    real = np.load(path, mmap_mode="r")
    n_real = min(len(real), max_real)
    if n_real < 2:
        raise SystemExit(f"need >= 2 real images for covariance, got {n_real} "
                         f"(--real {path}, --max-real {max_real})")
    chunk_size = min(256, n_real)
    for i in range(0, n_real, chunk_size):
        chunk = np.asarray(real[i:min(i + chunk_size, n_real)], np.float32) / 255.0
        n_valid = len(chunk)
        if n_valid < chunk_size:
            pad = np.zeros((chunk_size - n_valid, *chunk.shape[1:]), np.float32)
            chunk = np.concatenate([chunk, pad])
        fid.update_real_once(torch.from_numpy(chunk).to(device), n_valid=n_valid)
    return n_real


def evaluate(args) -> dict:
    """Ingest the real images, sample and score -> {"fid", "n_real",
    "images", "calls", "seconds"}; the seconds are the sampling's with the
    fake images' features, each call's copied to the host (which waits for
    the card)."""
    from ..models.fid import FID
    from ..models.inception import load_inception
    from ..pipelines import DiffusionPipeline

    fid = FID(load_inception(args.fid_weights, args.device), dim=2048)
    pipeline = DiffusionPipeline.from_checkpoint(args.model, device=args.device)
    per_call = max(args.batch // len(pipeline.classes), 1)

    logging.info("Ingesting real features...")
    n_real = ingest_real(fid, args.real, args.max_real, pipeline.device)

    logging.info(f"Sampling {args.num_images} images ({args.sampler}, {args.steps} steps)...")
    t0 = time.perf_counter()
    done, seed = 0, 0
    while done < args.num_images:
        imgs = pipeline.sample(args.cfg, num_images=per_call, seed=seed, sampler=args.sampler,
                               num_inference_steps=args.steps, eta=args.eta)
        take = min(len(imgs), args.num_images - done)
        fid.update_fake((imgs[:take] + 1.0) / 2.0)
        done += take
        seed += 1
        if seed % 10 == 0:
            logging.info(f"sampled {done}/{args.num_images}")
    dt = time.perf_counter() - t0
    score = fid.compute()
    logging.info(f"FID = {score:.3f} over {done} generated images ({done / dt:.2f} img/s sampling)")
    return dict(fid=score, n_real=n_real, images=done, calls=seed, seconds=dt)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    print(f"{evaluate(args)['fid']:.4f}")


if __name__ == "__main__":
    main()
