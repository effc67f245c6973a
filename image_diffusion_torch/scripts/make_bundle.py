"""Combine trained stage-1 and stage-2 checkpoints into an inference
bundle, the port's counterpart of scripts/make_bundle.py.

    python -m image_diffusion_torch.scripts.make_bundle \
        --vae checkpoints/<run>/vae-epoch-14.ckpt \
        --unet checkpoints/<run>/unet-epoch-129.ckpt \
        --config configs/diff-kl-lin-32x32.yaml \
        --classes "a hot place,a cold place,a mild place" \
        --out checkpoints/bundle.ckpt

Each model comes from a per-model file, a trainer epoch checkpoint (of
either package) or an original `.pt` file; the noise schedule from the
diffusion config.  The bundle, in the JAX package's layout, holds the
checkpoints' fp32 weights unchanged.  The pipeline is built on the CUDA
card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

from ..core.cli import add_device_argument


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--vae", required=True, help="VAE checkpoint (native or original .pt; "
                   "trainer epoch checkpoints also accepted).")
    p.add_argument("--unet", required=True, help="UNet checkpoint (same).")
    p.add_argument("--config", required=True, help="Diffusion YAML (for the noise schedule).")
    p.add_argument("--classes", default="a hot place,a cold place,a mild place")
    p.add_argument("--out", default="./checkpoints/bundle.ckpt")
    p.add_argument("--ema", action="store_true",
                   help="Bundle the EMA weights (requires a trainer checkpoint "
                        "saved with ema_decay enabled).")
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..compat.from_jax import unet_state_dict
    from ..core import checkpoint as ckpt
    from ..core.config import DiffusionConfig, UNetArch, _build
    from ..models.io import read_unet, read_vae
    from ..pipelines import DiffusionPipeline

    cfg = DiffusionConfig.from_yaml(args.config)
    vae_arch, vae_state = read_vae(args.vae)
    if args.ema:
        trees, meta = ckpt.load_checkpoint(args.unet)
        if "unet_ema" not in trees:
            raise SystemExit("--ema: checkpoint has no unet_ema tree "
                             "(train with ema_decay set)")
        unet_arch = _build(UNetArch, meta["architecture"])
        unet_state = unet_state_dict(trees["unet_ema"])
    else:
        unet_arch, unet_state = read_unet(args.unet)

    pipeline = DiffusionPipeline(vae_arch, vae_state, unet_arch, unet_state, cfg.schedule,
                                 args.classes, device=args.device)
    pipeline.to_checkpoint(args.out)
    print(f"Wrote bundle to {args.out}")


if __name__ == "__main__":
    main()
