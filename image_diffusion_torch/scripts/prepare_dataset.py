"""Dataset preparation, the port's counterpart of scripts/prepare_dataset.py.

  vae mode:       folder of jpg/png -> RGB resize to NxN -> one uint8 .npy blob
  diffusion mode: images .npy + VAE checkpoint -> fp16 latent blob (the raw
                  KL mean || log_var map, or the VQ codes; NHWC) + uint8 CLIP
                  zero-shot labels

    python -m image_diffusion_torch.scripts.prepare_dataset vae --vae-images ./lhq --out ./data
    python -m image_diffusion_torch.scripts.prepare_dataset diffusion \
        --diffusion-images ./data/vae_dataset.npy --vae-checkpoint ./checkpoints/vae.ckpt \
        --out ./data/diffusion --clip ./clip-vit-base-patch32

The latents are encoded in batches on the CUDA card unless `--device cpu`
is given, fed from the memory-mapped images through pinned host memory.
CLIP labels (`--labels-mode clip`, the default) need the `transformers`
package, whose `CLIPProcessor` tokenizes the prompts and preprocesses the
images on the host, and a CLIP checkpoint (`--clip`: a local directory or
an id in the transformers cache).  The model runs on the device as the
port's `models/clip.py` (`--clip-backend port`, the default) or as
transformers' eager `CLIPModel` (`--clip-backend torch`); the JAX
package's `jax` backend has no counterpart.  `--labels-mode random`
assigns uniform labels, for pipeline testing.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ..core.cli import add_device_argument, setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("type", choices=["vae", "diffusion"])
    p.add_argument("--out", type=str, default="./")
    # vae mode
    p.add_argument("--vae-images", type=str, help="Folder with images.")
    p.add_argument("--image-size", type=int, default=128)
    # diffusion mode
    p.add_argument("--diffusion-images", type=str, help=".npy of resized [0,255] images.")
    p.add_argument("--vae-checkpoint", type=str)
    p.add_argument("--clip", type=str, default=None,
                   help="Path / HF id of a CLIP model for zero-shot labels.")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--classes", type=str, default="a hot place,a cold place,a mild place")
    p.add_argument("--labels-mode", choices=["clip", "random"], default="clip",
                   help="'random' assigns uniform labels (pipeline testing without CLIP weights).")
    p.add_argument("--clip-backend", choices=["port", "torch"], default="port",
                   help="Run the CLIP forward as the port's model (default) or as "
                        "transformers' eager CLIPModel.")
    add_device_argument(p)
    return p.parse_args(argv)


def vae_dataset(args):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the vae mode reads and resizes images with PIL (pillow), "
                          "which is not installed") from e

    # sorted: os.listdir order is filesystem-dependent, and the row order
    # defines the dataset identity downstream (latents, labels, dev split)
    names = sorted(
        f for f in os.listdir(args.vae_images)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    logging.info(f"Creating VAE dataset. Found {len(names)} files.")
    size = args.image_size
    buffer = np.zeros((len(names), size, size, 3), np.uint8)
    logging.info(f"Buffer requires ~{buffer.nbytes / 1024**3:,.2f}GB of memory.")

    for i, name in enumerate(names):
        with Image.open(os.path.join(args.vae_images, name)) as img:
            img = img.convert("RGB") if img.mode != "RGB" else img
            buffer[i] = np.asarray(img.resize((size, size)), np.uint8)
        if (i + 1) % 5000 == 0:
            logging.info(f"resized {i + 1}/{len(names)}")

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "vae_dataset.npy"), buffer)
    logging.info("Saved vae_dataset.npy")


def encode(vae, batch_u8):
    """uint8 NHWC images on the VAE's device -> the stored-latent map in
    the compute dtype: KL's raw mean || log_var, or VQ's codes."""
    x = batch_u8.float() / 127.5 - 1.0
    return vae.encode(x, sample=False)[0]


def extract_latents(vae, images: np.ndarray, batch_size: int, device) -> np.ndarray:
    """(n, H, W, 3) uint8 images (an array or a memory map) -> (n, h, w,
    c) fp16 latents, encoded in batches under inference mode.  The tail
    batch runs at its own size: rows are independent (GroupNorm normalises
    each sample), so padding it would change nothing."""
    import torch

    n = images.shape[0]
    # one pinned staging buffer: each batch's output copy to the host waits
    # for the card, so the buffer is free again when the next batch fills it
    staging = torch.empty((min(batch_size, n), *images.shape[1:]), dtype=torch.uint8,
                          pin_memory=torch.device(device).type == "cuda")
    buffer = None
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            m = min(batch_size, n - i)
            staging.numpy()[:m] = images[i : i + m]
            z = encode(vae, staging[:m].to(device, non_blocking=True))
            if buffer is None:
                buffer = np.zeros((n, *z.shape[1:]), np.float16)
                logging.info(f"Latent shape {tuple(z.shape[1:])}; buffer "
                             f"~{buffer.nbytes / 1024**3:,.2f}GB.")
            buffer[i : i + m] = z.to(torch.float16).cpu().numpy()
    return buffer


def diffusion_dataset(args):
    import torch

    from ..core import resolve_device
    from ..models.io import load_vae

    device = resolve_device(args.device)
    classes = args.classes.split(",")
    # CLIP is loaded before the latents are extracted, so a missing package
    # or checkpoint fails at once
    clip = load_clip(args.clip) if args.labels_mode == "clip" else None

    images = np.load(args.diffusion_images, mmap_mode="r")
    n = images.shape[0]
    logging.info(f"Creating Diffusion dataset. Found {n} images.")

    vae, _ = load_vae(args.vae_checkpoint, dtype=torch.bfloat16, device=device)
    buffer = extract_latents(vae, images, args.batch_size, device)
    del vae
    logging.info("Latent extraction done.")

    if clip is None:
        logging.warning("Assigning RANDOM labels (--labels-mode random) — "
                        "use only for pipeline testing.")
        labels = np.random.default_rng(0).integers(0, len(classes), size=(n,)).astype(np.uint8)
    else:
        labels = clip_labels(images, classes, *clip, args.clip_backend, args.batch_size, device)

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "diffusion_dataset.npy"), buffer)
    np.save(os.path.join(args.out, "diffusion_labels.npy"), labels)
    logging.info("Saved diffusion_dataset.npy + diffusion_labels.npy")


def load_clip(source: str | None):
    """(transformers `CLIPModel` in eval mode, `CLIPProcessor`) from
    `source` (default: openai/clip-vit-base-patch32 from the cache)."""
    try:
        from transformers import CLIPModel, CLIPProcessor
    except ImportError as e:
        raise SystemExit("--labels-mode clip needs the transformers package (CLIPModel, "
                         f"CLIPProcessor), which does not import here: {e}") from e
    source = source or "openai/clip-vit-base-patch32"
    logging.info(f"Loading CLIP from {source}")
    return CLIPModel.from_pretrained(source).eval(), CLIPProcessor.from_pretrained(source)


def zero_shot_labels(clip, pixel_batches, input_ids, attention_mask=None) -> np.ndarray:
    """Zero-shot labels with the port's `CLIPZeroShot`: for each image of
    each batch of processed pixels (NCHW, the processor's output), the
    prompt (token ids, one row each) of the largest scaled cosine logit;
    softmax is monotone, so this is the original's
    `logits_per_image.softmax(-1).argmax(-1)`.  The prompts are encoded
    once.  -> (n,) uint8."""
    import torch

    from ..core import no_tf32

    labels = []
    with torch.inference_mode():
        txt = clip.encode_text(input_ids, attention_mask)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        scale = clip.logit_scale.exp()
        for i, pixel in enumerate(pixel_batches):
            img = clip.encode_images(pixel)
            img = img / img.norm(dim=-1, keepdim=True)
            with no_tf32():
                logits = scale * img @ txt.T
            labels.append(logits.argmax(-1).to(torch.uint8).cpu().numpy())
            if i % 50 == 0:
                logging.info(f"labeled {sum(map(len, labels))} images")
    return np.concatenate(labels)


def clip_labels(images, classes, model, processor, backend: str, batch_size: int,
                device) -> np.ndarray:
    """Zero-shot classify each image against the class prompts with CLIP
    (the original runs OpenAI ViT-B/32).  Tokens and pixels come from the
    processor on the host; the forward runs on `device`, as the port's
    model or (`backend` "torch") as transformers' eager one."""
    import torch

    from ..core import no_tf32
    from ..models.clip import CLIPZeroShot

    n = images.shape[0]
    text = processor(text=classes, return_tensors="np", padding=True)

    def pixel_batches():
        for i in range(0, n, batch_size):
            batch = [images[j] for j in range(i, min(i + batch_size, n))]
            yield processor(images=batch, return_tensors="np")["pixel_values"]

    logging.info(f"CLIP labels of {n} images (backend={backend}, device={device})")
    if backend == "port":
        clip = CLIPZeroShot.from_torch_model(model, device=device)
        return zero_shot_labels(clip, pixel_batches(), text["input_ids"],
                                text.get("attention_mask"))

    model = model.to(device)
    tt = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in text.items()}
    labels = []
    with torch.no_grad(), no_tf32():
        for pixel in pixel_batches():
            out = model(pixel_values=torch.from_numpy(pixel).to(device), **tt)
            labels.append(out.logits_per_image.softmax(-1).argmax(-1).to(torch.uint8).cpu().numpy())
    return np.concatenate(labels)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    if args.type == "vae":
        vae_dataset(args)
    else:
        diffusion_dataset(args)


if __name__ == "__main__":
    main()
