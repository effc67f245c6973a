"""Stage-2 training entry point, the port's counterpart of
scripts/train_diffusion.py.

    python -m image_diffusion_torch.scripts.train_diffusion --config configs/diff-kl-lin-32x32.yaml

Runs on the CUDA card unless `--device cpu` is given.  Reads the latents
(NCHW datasets are converted once to NHWC) and labels named by the config,
trains, and writes per-epoch checkpoints in the JAX trainer's layout.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True, help="YAML training config.")
    p.add_argument("--experiment-name", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None, help="Resume from checkpoint.")
    p.add_argument("--comment", type=str, default=None)
    p.add_argument("--no-mlflow", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    return p.parse_args(argv)


def main(argv=None):
    """Parse `argv`, train, and return the trainer."""
    args = parse_args(argv)

    from ..core.config import DiffusionConfig
    from ..core.logging import BasicLogger, get_run_name
    from ..core.metrics import MetricHolder
    from ..training.data import ArrayDataset
    from ..training.diffusion_trainer import DiffusionTrainer

    cfg = DiffusionConfig.from_yaml(args.config)
    run_name = args.experiment_name or get_run_name("unet")
    logger = BasicLogger(cfg.train.logs_dir, run_name, args.no_mlflow, cfg.train.log_interval)
    holder = MetricHolder(cfg.train.log_interval)
    if args.comment:
        logger.log_params(comment=args.comment)

    latents = np.load(cfg.train.train_set)
    if latents.ndim == 4 and latents.shape[1] < latents.shape[2]:
        # datasets of the original implementation are NCHW (N, 6, 32, 32)
        latents = np.ascontiguousarray(latents.transpose(0, 2, 3, 1))
    labels = np.load(cfg.train.train_labels)
    trainer = DiffusionTrainer(cfg, ArrayDataset(latents, labels), logger, holder,
                               checkpoint=args.checkpoint, run_name=run_name,
                               device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
