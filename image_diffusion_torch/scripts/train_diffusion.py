"""Stage-2 training entry point, the port's counterpart of
scripts/train_diffusion.py.

    python -m image_diffusion_torch.scripts.train_diffusion --config configs/diff-kl-lin-32x32.yaml

Runs on the CUDA card unless `--device cpu` is given.  Under `torchrun`
it trains data-parallel, one process per card:

    torchrun --nproc-per-node 8 -m image_diffusion_torch.scripts.train_diffusion \
        --config configs/diff-kl-lin-32x32.yaml

rank r on `cuda:LOCAL_RANK` over NCCL (with `--device cpu`, on the CPU over
gloo); `--data-parallel`, when given, must equal the number of processes.
Reads the latents
(NCHW datasets are converted once to NHWC) and labels named by the config,
trains, and writes per-epoch checkpoints in the JAX trainer's layout.
`--remat` overrides the config's activation remat policy; `--preview-vae`
with `--preview-freq N` logs a sampled CFG grid every N epochs (needs
matplotlib); `--debug-nans` stops at the first non-finite loss or gradient
norm (see README).  With `IDTPU_PROFILE=<dir>` the run writes a
torch.profiler trace there.
"""

from __future__ import annotations

import argparse

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
    p.add_argument("--debug-nans", action="store_true",
                   help="Anomaly detection in the backward, and stop at the first non-finite "
                        "loss or gradient norm (FloatingPointError naming the step).")
    p.add_argument("--preview-vae", type=str, default=None,
                   help="VAE checkpoint for in-training sample previews.")
    p.add_argument("--preview-freq", type=int, default=0,
                   help="Log a sampled CFG grid every N epochs (0 = off).")
    p.add_argument("--preview-steps", type=int, default=20,
                   help="DPM-Solver++ steps per preview.")
    p.add_argument("--remat", choices=["none", "dots", "full"], default=None,
                   help="Activation remat policy of the train step (overrides the YAML "
                        "`remat:` key; see models/unet.py).")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="Data-parallel mesh size (default: every process of the torchrun "
                        "launch; one process per card).")
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv=None):
    """Parse `argv`, train, and return the trainer."""
    args = parse_args(argv)

    from ..core.config import DiffusionConfig
    from ..core.logging import BasicLogger, get_run_name
    from ..core.metrics import MetricHolder
    from ..core.profiling import trace
    from ..parallel.mesh import initialize_distributed, trainer_mesh
    from ..training.data import ArrayDataset
    from ..training.diffusion_trainer import DiffusionTrainer

    device = initialize_distributed(args.device)
    mesh = trainer_mesh(args.data_parallel, device)
    overrides = {} if args.remat is None else {"remat": args.remat}
    cfg = DiffusionConfig.from_yaml(args.config, **overrides)
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
                               device=device, preview_vae=args.preview_vae,
                               preview_freq=args.preview_freq, preview_steps=args.preview_steps,
                               debug_nans=args.debug_nans, mesh=mesh)
    with trace():
        trainer.train()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
