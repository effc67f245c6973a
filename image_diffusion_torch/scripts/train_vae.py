"""Stage-1 training entry point, the port's counterpart of
scripts/train_vae.py.

    python -m image_diffusion_torch.scripts.train_vae --config configs/vae-kl-32x32.yaml \
        --lpips-weights vgg_lpips.pth

Runs on the CUDA card unless `--device cpu` is given, and data-parallel
under `torchrun`, one process per card, as `train_diffusion` does
(`--data-parallel`, when given, must equal the number of processes).
Reads the uint8
NHWC images named by the config (`train_set`, and `dev_set` when it exists),
trains the KL or VQ VAE-GAN (`configs/vae-kl-32x32.yaml`,
`configs/vae-vq-32x32.yaml`) at any `grad_accum` that divides the batch,
evaluates on the dev set each epoch, draws reconstruction figures of
`plot_set` when that file exists, and writes per-epoch checkpoints in the
JAX trainer's layout.  Training without LPIPS weights changes the
objective, so it needs `--allow-no-lpips`.  `--fid-weights` (InceptionV3 in
torchvision's layout) adds `dev/FID` to each epoch's dev evaluation;
`--debug-nans` stops at the first non-finite loss or gradient norm (see
README).  With `IDTPU_PROFILE=<dir>` the run writes a torch.profiler trace
there.
"""

from __future__ import annotations

import argparse
import os
import warnings

import numpy as np
import torch

from ..core.cli import add_device_argument


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True, help="YAML training config.")
    p.add_argument("--experiment-name", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None, help="Resume from checkpoint.")
    p.add_argument("--comment", type=str, default=None)
    p.add_argument("--no-mlflow", action="store_true")
    p.add_argument("--lpips-weights", type=str, default=None,
                   help="Path to torch-format LPIPS/VGG16 weights.")
    p.add_argument("--allow-no-lpips", action="store_true",
                   help="Acknowledge training WITHOUT the perceptual loss, which "
                        "changes what the VAE optimizes.")
    p.add_argument("--fid-weights", type=str, default=None,
                   help="Path to torch-format InceptionV3 weights (e.g. "
                        "pt_inception-2015-12-05.pth); enables per-epoch dev FID.")
    p.add_argument("--debug-nans", action="store_true",
                   help="Anomaly detection in the backward, and stop at the first non-finite "
                        "loss or gradient norm (FloatingPointError naming the step).")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="Data-parallel mesh size (default: every process of the torchrun "
                        "launch; one process per card).")
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv=None):
    """Parse `argv`, train, and return the trainer."""
    args = parse_args(argv)

    from ..core.config import VAEConfig
    from ..core.logging import BasicLogger, get_run_name
    from ..core.metrics import MetricHolder
    from ..core.profiling import trace
    from ..models.fid import FID
    from ..models.inception import load_inception
    from ..models.lpips import try_load_lpips
    from ..parallel.mesh import initialize_distributed, trainer_mesh
    from ..training.data import ArrayDataset
    from ..training.vae_trainer import VAETrainer

    device = initialize_distributed(args.device)
    mesh = trainer_mesh(args.data_parallel, device)
    cfg = VAEConfig.from_yaml(args.config)
    run_name = args.experiment_name or get_run_name("vae")
    logger = BasicLogger(cfg.train.logs_dir, run_name, args.no_mlflow, cfg.train.log_interval)
    holder = MetricHolder(cfg.train.log_interval)
    if args.comment:
        logger.log_params(comment=args.comment)

    percept_fn = try_load_lpips(args.lpips_weights)
    if percept_fn is None:
        msg = (f"LPIPS weights not provided/loadable: the perceptual loss term (percept_weight="
               f"{cfg.train.percept_weight}) will contribute ZERO, which CHANGES the training "
               "objective.")
        if not args.allow_no_lpips:
            raise SystemExit(msg + " Pass --lpips-weights <file> or acknowledge with "
                                   "--allow-no-lpips.")
        warnings.warn(msg)
        logger.log_console("WARNING: " + msg)
        logger.log_params(lpips_disabled=True)

    fid_fn = None
    if args.fid_weights:
        fid_fn = FID(load_inception(args.fid_weights, device), 2048)
        logger.log_console("Per-epoch dev FID enabled (InceptionV3 pool3).")

    train_ds = ArrayDataset(np.load(cfg.train.train_set))
    dev_ds = ArrayDataset(np.load(cfg.train.dev_set)) if os.path.exists(cfg.train.dev_set) else None
    trainer = VAETrainer(cfg, train_ds, dev_ds, logger, holder, checkpoint=args.checkpoint,
                         run_name=run_name, percept_fn=percept_fn, device=device,
                         fid_fn=fid_fn, debug_nans=args.debug_nans, mesh=mesh)
    with trace():
        trainer.train()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
