"""Visualize VAE latents as RGB images next to their reconstructions, the
port's counterpart of scripts/visualize_latents.py.

Each image is encoded, and the posterior mean (KL) or the codes (VQ) are
decoded, in bf16.  The latent's first 3 channels (zero-padded below 3)
are squashed by a sigmoid into RGB; with the shipped z_dim=3 configs the
latent map is a 32x32 3-channel image.

    python -m image_diffusion_torch.scripts.visualize_latents checkpoints/vae.ckpt \
        --images data/vae_dataset.npy --n 6 --out latents.png

Runs on the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ..core.cli import add_device_argument, setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("vae", type=str, help="VAE checkpoint (per-model or trainer).")
    p.add_argument("--images", type=str, required=True,
                   help="uint8 images .npy (the vae_dataset.npy blob).")
    p.add_argument("--n", type=int, default=6, help="Rows to visualize.")
    p.add_argument("--start", type=int, default=0, help="First image index.")
    p.add_argument("--out", type=str, default="./latents.png")
    add_device_argument(p)
    return p.parse_args(argv)


def encode_decode(vae, batch_u8):
    """uint8 NHWC images on the VAE's device -> (latents, reconstructions),
    both fp32: KL's posterior mean, or VQ's codes, and their decode."""
    import torch

    with torch.inference_mode():
        x = batch_u8.float() / 127.5 - 1.0
        z = vae.encode(x, sample=False)[0].float()
        if vae.arch.bottleneck == "kl":  # the raw mean || log_var map: take the mean
            z = z[..., : vae.arch.z_dim]
        x_hat = vae.decode(z, quantize=vae.arch.bottleneck == "vq")
    return z, x_hat.float()


def latent_rgb(z: np.ndarray) -> np.ndarray:
    """Latents -> uint8 RGB: sigmoid of the first 3 channels, zero-padded
    below 3."""
    rgb = 1.0 / (1.0 + np.exp(-z))
    if rgb.shape[-1] < 3:
        rgb = np.concatenate([rgb, np.zeros((*rgb.shape[:-1], 3 - rgb.shape[-1]), rgb.dtype)], -1)
    return (rgb[..., :3] * 255).astype(np.uint8)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()

    import torch

    from ..core import resolve_device
    from ..core.plotting import pyplot, to_uint8
    from ..models.io import load_vae

    plt = pyplot()
    device = resolve_device(args.device)
    vae, _ = load_vae(args.vae, dtype=torch.bfloat16, device=device)
    images = np.load(args.images, mmap_mode="r")
    batch = np.array(images[args.start : args.start + args.n])
    if batch.ndim != 4 or batch.shape[0] == 0:
        raise SystemExit(f"no images in [{args.start}, {args.start + args.n})")
    z, x_hat = (t.cpu().numpy() for t in encode_decode(vae, torch.from_numpy(batch).to(device)))
    rgb = latent_rgb(z)

    n = batch.shape[0]
    fig, axs = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i in range(n):
        axs[i, 0].imshow(batch[i])
        axs[i, 1].imshow(rgb[i], interpolation="nearest")
        axs[i, 2].imshow(to_uint8(x_hat[i]))
        for ax in axs[i]:
            ax.axis("off")
    axs[0, 0].set_title("Original", fontsize=14)
    axs[0, 1].set_title(f"Latent ({z.shape[1]}x{z.shape[2]}, sigmoid RGB)", fontsize=14)
    axs[0, 2].set_title("Reconstruction", fontsize=14)
    plt.tight_layout()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.savefig(args.out, bbox_inches="tight", dpi=120)
    logging.info(f"Saved {args.out}")


if __name__ == "__main__":
    main()
