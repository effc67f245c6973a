"""End-to-end quality run on synthetic class data at full model size, the
port's counterpart of the JAX package's `tools/e2e_synthetic_run.py`.

    python -m image_diffusion_torch.tools.e2e_synthetic_run --profile r4 \\
        --bottleneck kl --history docs/e2e_history_torch.jsonl --round-tag <tag>

  1. A 3-class synthetic dataset of 128x128 images whose classes a
     statistic tells apart (numpy, bit-equal to the JAX tool's for every
     seed): class 0 horizontal bands, class 1 vertical stripes, class 2
     isotropic gaussian blobs.  `classify` grades an image by its gradient
     anisotropy r = mean|dI/dx| / (mean|dI/dx| + mean|dI/dy|).
  2. Stage 1: the shipped 36M VAE (KL, or VQ with the shipped codebook
     1024 / beta 0.25 / gamma 0.99), reconstruction and prior terms only
     (the discriminator never starts, no LPIPS), through the port's
     `VAETrainer`.
  3. The reconstruction FID over a held-out dev set (`make_dataset(...,
     seed=777)`): real statistics in chunks of 90, reconstructions through
     the trainer's eval step at `--batch`, the tails padded and counted by
     their valid rows.  VQ adds the codebook's utilization and perplexity
     over the dev set.
  4. Latents (posterior maps for KL, quantized codes for VQ, as
     `prepare_dataset` stores them) at fp16, and the shipped 60M UNet
     trained class-conditionally through the port's `DiffusionTrainer`.
  5. A CFG grid (ddpm-1000, `--sample-per-class` rows of the 3 classes at
     `--cfg-scale`) graded by `classify`: the pass bar is a conditional
     accuracy of 0.8.
  6. The generative FID: calls of 30 images (`--fid-sampler`,
     `--fid-steps`, seeds from 1000) against the same dev statistics.

The FID's InceptionV3 comes from `--fid-weights`, or random weights in
torchvision's layout written by `random_inception_file` at seed 11 (the
recipe of the JAX tool's test oracle, so both packages grade with the same
network).  The run writes `e2e_report.json`, `e2e_grid.png`, the dev set,
the bundle and the trainers' per-epoch checkpoints into `--out`;
`--history` appends the round-tagged report, with a note naming the card,
to a JSONL file that the JAX package's `tools/check_e2e_history.py` reads.
`run` returns the report to an in-process caller.

Runs on the CUDA card unless `--device cpu` is given.  Deliberate
differences from the JAX tool: `--device` in place of the JAX platform;
`--out` defaults to a directory under the temporary directory; torch
generators in place of threefry keys (the trained weights and samples
differ, the metrics are compared); without matplotlib the grid is written
unannotated with PIL, and the run says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..core import resolve_device
from ..core.cli import add_device_argument
from ..core.config import (DiffusionConfig, DiffusionTrainConfig, ScheduleConfig, UNetArch, VAEArch,
                           VAEConfig, VAETrainConfig)
from ..core.logging import BasicLogger
from ..core.metrics import MetricHolder
from ..core.plotting import make_grid, plot_cfg_grid
from ..models.fid import FID
from ..models.inception import InceptionV3Features, load_inception
from ..pipelines.diffusion import DiffusionPipeline
from ..training.data import ArrayDataset
from ..training.diffusion_trainer import DiffusionTrainer
from ..training.vae_trainer import VAETrainer, make_eval_step, normalize_batch

RUN_NAMES = {"vae": "e2e_vae", "unet": "e2e_unet"}
CLASSES = ["bands", "stripes", "blobs"]
REAL_CHUNK = 90          # real images per feature call of the dev statistics
FID_PER_CALL = 30        # generated images per sampling call: 3 classes x 10
INCEPTION_SEED = 11      # the random Inception both packages' histories use


def make_dataset(n_per_class: int, size: int = 128, seed: int = 0) -> tuple:
    """-> (uint8 images (3n, size, size, 3), uint8 labels 0, 1, 2, 0, ...)."""
    rng = np.random.default_rng(seed)
    n = 3 * n_per_class
    imgs = np.zeros((n, size, size, 3), np.uint8)
    labels = np.tile(np.arange(3, dtype=np.uint8), n_per_class)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size

    for i, c in enumerate(labels):
        color = rng.uniform(0.3, 1.0, (3,)).astype(np.float32)
        if c == 0:  # horizontal bands: varies along y
            freq = rng.uniform(2, 6)
            phase = rng.uniform(0, 2 * np.pi)
            base = 0.5 + 0.5 * np.sin(2 * np.pi * freq * yy + phase)
        elif c == 1:  # vertical stripes: varies along x
            freq = rng.uniform(2, 6)
            phase = rng.uniform(0, 2 * np.pi)
            base = 0.5 + 0.5 * np.sin(2 * np.pi * freq * xx + phase)
        else:  # isotropic gaussian blobs
            base = np.zeros((size, size), np.float32)
            for _ in range(rng.integers(3, 7)):
                cx, cy = rng.uniform(0.1, 0.9, (2,))
                s = rng.uniform(0.05, 0.15)
                base += np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
            base = np.clip(base, 0, 1)
        imgs[i] = np.clip(base[..., None] * color * 255, 0, 255).astype(np.uint8)
    return imgs, labels


def anisotropy(img01: np.ndarray) -> float:
    """r = mean|dI/dx| / (mean|dI/dx| + mean|dI/dy|) on the gray image."""
    g = img01.mean(-1)
    dx = np.abs(np.diff(g, axis=1)).mean()
    dy = np.abs(np.diff(g, axis=0)).mean()
    return float(dx / (dx + dy + 1e-9))


def classify(img01: np.ndarray) -> int:
    r = anisotropy(img01)
    # class 0 (bands, varies along y): r small; class 1 (stripes): r large
    return int(np.argmin(np.abs(np.array([0.08, 0.92, 0.5]) - r)))


# Named step-count profiles: quality numbers compare only at identical step
# counts and FID image counts, so a profile pins all three, and history
# rows record the profile that made them.
PROFILES = {
    "r4": {"vae_steps": 500, "unet_steps": 2125, "fid_images": 1002},
    "r3": {"vae_steps": 1000, "unet_steps": 5000, "fid_images": 1002},
    "vq-smoke": {"vae_steps": 500, "unet_steps": 500, "fid_images": 1002},
}


def random_inception_file(path: str, seed: int) -> None:
    """Random FID InceptionV3 weights in torchvision's layout, saved as a
    torch state dict: He-scaled convolutions, then BatchNorm affines and
    running statistics uniform in fixed ranges, drawn in module order from
    `np.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    model = InceptionV3Features()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                w = rng.normal(0, np.sqrt(2.0 / fan_in), tuple(mod.weight.shape))
                mod.weight.copy_(torch.from_numpy(w.astype(np.float32)))
            elif isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                for t, (lo, hi) in ((mod.weight, (0.5, 1.5)), (mod.bias, (-0.1, 0.1)),
                                    (mod.running_mean, (-0.2, 0.2)), (mod.running_var, (0.5, 1.5))):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, (n,)).astype(np.float32)))
    torch.save(model.state_dict(), path)


def latest_ckpt(out: str, run_name: str, prefix: str) -> str | None:
    """The newest `{prefix}-epoch-N.ckpt` in out/run_name by N (the names
    are zero-padded to 2 digits only, so a lexicographic sort would rank
    epoch-99 above epoch-100), or None."""
    def epoch_no(path: str) -> int:
        m = re.search(r"-epoch-(\d+)\.ckpt$", path)
        return int(m.group(1)) if m else -1

    found = sorted(glob.glob(os.path.join(out, run_name, f"{prefix}-epoch-*.ckpt")), key=epoch_no)
    return found[-1] if found else None


def stage1_config(arch: VAEArch, bottleneck: str, batch: int, epochs: int, out: str,
                  seed: int = 0, precision: str = "bf16") -> VAEConfig:
    """The run's stage-1 config: `arch` with the bottleneck (VQ: the
    shipped configs/vae-vq-32x32.yaml codebook 1024 / beta 0.25 / gamma
    0.99, prior weight 1.0; KL: prior weight 5e-6), lr 1e-4 after 100
    warmup steps, clip 1, the discriminator never started."""
    if bottleneck == "vq":
        arch = dataclasses.replace(arch, bottleneck="vq", codebook_size=1024, codebook_beta=0.25,
                                   codebook_gamma=0.99)
    return VAEConfig(arch=arch, train=VAETrainConfig(
        learning_rate=1e-4, warmup_steps=100, batch_size=batch, epochs=epochs, clip_grad=1.0,
        precision=precision, seed=seed, log_interval=50, disc_start=10**9,
        prior_weight=1.0 if bottleneck == "vq" else 5e-6, checkpoints_dir=out, logs_dir=out))


def _padded(chunk: np.ndarray, size: int) -> np.ndarray:
    """`chunk` with zero rows appended up to `size` rows."""
    if len(chunk) == size:
        return chunk
    return np.concatenate([chunk, np.zeros((size - len(chunk), *chunk.shape[1:]), chunk.dtype)])


def ingest_dev(fid, dev_imgs: np.ndarray, device) -> None:
    """The dev set's real statistics, in chunks of REAL_CHUNK images in [0,
    1], the tail padded and counted by its valid rows."""
    for i in range(0, len(dev_imgs), REAL_CHUNK):
        chunk = dev_imgs[i:i + REAL_CHUNK].astype(np.float32) / 255.0
        fid.update_real_once(torch.from_numpy(_padded(chunk, REAL_CHUNK)).to(device),
                             n_valid=len(chunk))


def reconstruction_fid(vae, eval_step, fid, dev_imgs: np.ndarray, batch: int, device,
                       noise=None) -> float:
    """The FID of the dev set's reconstructions against the real statistics
    `fid` holds: batches of `batch` through `eval_step(vae, x_u8, noise,
    n_valid)`, the tail padded, then `fid.reset_fake()`.  `noise(i, shape)`
    gives the KL reparametrization draw of the batch starting at row i
    (default: one generator seeded 9 on `device`, a draw a batch)."""
    gen = torch.Generator(device=device).manual_seed(9)
    h = vae.arch.latent_resolution
    for i in range(0, len(dev_imgs), batch):
        chunk = dev_imgs[i:i + batch]
        n_valid = len(chunk)
        x = torch.from_numpy(_padded(chunk, batch)).to(device)
        shape = (batch, h, h, vae.arch.z_dim)
        z = (noise(i, shape) if noise is not None
             else torch.randn(shape, generator=gen, device=device))
        x_hat = eval_step(vae, x, z, n_valid)[0]
        fid.update_fake(((x_hat + 1.0) / 2.0).clamp(0, 1), n_valid=n_valid)
    score = fid.compute()
    fid.reset_fake()
    return score


def code_counts(vae, probe: np.ndarray, batch: int, device) -> tuple[np.ndarray, int]:
    """VQ: how often each code is the nearest over `probe` in whole
    batches of min(batch, len(probe)) -> (counts float64 (K,), images
    counted)."""
    pb = min(batch, len(probe))
    counts = np.zeros((vae.arch.codebook_size,), np.float64)
    with torch.no_grad():
        for i in range(0, len(probe) - pb + 1, pb):
            x = normalize_batch(torch.from_numpy(probe[i:i + pb]).to(device))
            idx = vae.encode_indices(x).reshape(-1)
            counts += torch.bincount(idx, minlength=vae.arch.codebook_size).cpu().numpy()
    return counts, (len(probe) // pb) * pb


def vq_numbers(counts: np.ndarray, n_images: int) -> dict:
    """The report's codebook size, utilization (share of codes used),
    perplexity (exp of the codes' entropy) and image count."""
    if counts.sum() <= 0:
        raise ValueError("empty VQ probe set")
    probs = counts / counts.sum()
    ent = -np.sum(probs[probs > 0] * np.log(probs[probs > 0]))
    return {"vq_codebook_size": int(len(counts)),
            "vq_codebook_utilization": round(float(np.mean(counts > 0)), 4),
            "vq_dev_perplexity": round(float(np.exp(ent)), 2),
            "vq_dev_images": int(n_images)}


def encode_latents(vae, imgs: np.ndarray, batch: int, device) -> np.ndarray:
    """Stored latents of `imgs` in whole batches, fp16: KL's posterior map
    (mean || log_var), VQ's quantized codes."""
    out = []
    with torch.no_grad():
        for i in range(0, len(imgs) - batch + 1, batch):
            x = normalize_batch(torch.from_numpy(imgs[i:i + batch]).to(device))
            z = vae.encode(x, sample=False)[0]
            out.append(z.float().cpu().numpy().astype(np.float16))
    return np.concatenate(out)


def grade(out01: np.ndarray, per_class: int) -> tuple[float, dict[int, float]]:
    """Conditional accuracy of a class-major grid (rows 0, 1, 2, 0, ...)
    -> (overall, per class)."""
    want = np.tile(np.arange(3), per_class)
    got = np.array([classify(im) for im in out01])
    return float(np.mean(got == want)), {c: float(np.mean(got[want == c] == c)) for c in range(3)}


def save_grid(images: np.ndarray, classes: list[str], scales: list, path: str) -> str:
    """The sampled grid (NHWC in [-1, 1]) as a PNG: the annotated figure of
    `core.plotting.plot_cfg_grid` when matplotlib is installed, else the
    unannotated `make_grid` written with PIL -> what was written."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        from PIL import Image

        Image.fromarray(make_grid(images, nrow=len(classes))).save(path)
        return "matplotlib is not installed: the annotated figure was not drawn; wrote the " \
               "unannotated grid with PIL"
    import matplotlib.pyplot as plt

    fig = plot_cfg_grid(images, classes, scales)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return "the annotated figure"


def card_note(device) -> str:
    """Names the package and the card (with its power limit) a history row
    came from."""
    if torch.device(device).type != "cuda":
        return "image_diffusion_torch on the CPU (the kernels' plain versions)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = f"{torch.cuda.get_device_name(0)} (nvidia-smi gave no power limit)"
    return f"image_diffusion_torch on {smi}"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "e2e_synth"))
    p.add_argument("--n-per-class", type=int, default=2000)
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--vae-steps", type=int, default=1000)
    p.add_argument("--unet-steps", type=int, default=5000)
    p.add_argument("--profile", choices=sorted(PROFILES), default=None,
                   help="Named step/FID-count profile; overrides --vae-steps/--unet-steps/"
                        "--fid-images so that runs compare (see PROFILES).")
    p.add_argument("--bottleneck", choices=["kl", "vq"], default="kl",
                   help="Stage-1 bottleneck.  'vq' trains the shipped configs/vae-vq-32x32.yaml "
                        "bottleneck (codebook 1024, beta .25, gamma .99, prior weight 1.0) and "
                        "reports dev perplexity and codebook utilization.")
    p.add_argument("--history", default=None,
                   help="JSONL file to APPEND the round-tagged report to; the run's report "
                        "JSON still lands in --out.")
    p.add_argument("--round-tag", default=None, help="Tag recorded in the history row.")
    p.add_argument("--cfg-scale", type=float, default=3.0)
    p.add_argument("--sample-per-class", type=int, default=9)
    p.add_argument("--fid-weights", type=str, default=None,
                   help="InceptionV3 weight file (torchvision layout); random weights at seed "
                        f"{INCEPTION_SEED} are written to --out when omitted.")
    p.add_argument("--fid-images", type=int, default=1002,
                   help="Generated images for the FID estimate (0 disables); >= 1000 keeps "
                        "FID's small-sample bias in check.")
    p.add_argument("--fid-steps", type=int, default=20, help="Sampler steps for FID sampling.")
    p.add_argument("--fid-sampler", default="dpm", choices=["dpm", "ddim"],
                   help="Few-step sampler for FID generation.")
    p.add_argument("--resume", action="store_true",
                   help="Resume both stages from the newest per-epoch checkpoints in --out; the "
                        "data and latents are made again from their seeds, so only completed "
                        "epochs are reused.")
    add_device_argument(p)
    args = p.parse_args(argv)
    if args.profile:
        for k, v in PROFILES[args.profile].items():
            setattr(args, k, v)
    return args


def _elapsed(t0: float, device) -> float:
    """Seconds since `t0`, after the card's queued work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return round(time.time() - t0, 1)


def run(argv=None, vae_arch=None, unet_arch=None) -> dict:
    """The whole run -> its report.  `vae_arch` / `unet_arch` replace the
    shipped architectures (the tests pass tiny ones; the bottleneck is
    still `--bottleneck`'s)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    report = {}
    t_all = time.time()

    def resume_from(stage: str) -> str | None:
        path = latest_ckpt(args.out, RUN_NAMES[stage], stage) if args.resume else None
        if path is not None:
            print(f"[resume] {path}", flush=True)
            report.setdefault("resumed_from", {})[stage] = os.path.basename(path)
        return path

    # ---- 1. data
    imgs, labels = make_dataset(args.n_per_class)
    # sanity: the classifier separates the real data
    real_acc = np.mean([classify(imgs[i].astype(np.float32) / 255.0) == labels[i]
                        for i in range(min(300, len(imgs)))])
    report["real_classifier_acc"] = float(real_acc)
    if not real_acc > 0.95:
        raise RuntimeError(f"stat classifier broken on real data: {real_acc}")
    print(f"[data] {len(imgs)} images; stat-classifier on real data: {real_acc:.2f}", flush=True)

    # ---- 2. stage 1: the shipped VAE, reconstruction and prior terms only
    spe = len(imgs) // args.batch
    vae_epochs = max(args.vae_steps // spe, 1)
    report["bottleneck"] = args.bottleneck
    vcfg = stage1_config(vae_arch or VAEArch(), args.bottleneck, args.batch, vae_epochs, args.out)
    arch = vcfg.arch
    logger = BasicLogger(args.out, RUN_NAMES["vae"], no_mlflow=True, log_interval=50)
    vt = VAETrainer(vcfg, ArrayDataset(imgs), None, logger, MetricHolder(50),
                    checkpoint=resume_from("vae"), run_name=RUN_NAMES["vae"], device=device)
    vae = vt.state.vae
    t0 = time.time()
    vt.train()
    report["vae_steps"] = vae_epochs * spe
    report["vae_train_s"] = _elapsed(t0, device)

    eval_step = make_eval_step()
    h = arch.latent_resolution
    x = torch.from_numpy(imgs[:8]).to(device)
    noise = torch.randn((8, h, h, arch.z_dim),
                        generator=torch.Generator(device=device).manual_seed(0), device=device)
    report["vae_final_recon"] = float(eval_step(vae, x, noise, 8)[1].mean())
    print(f"[vae] {report['vae_steps']} steps in {report['vae_train_s']}s; "
          f"recon={report['vae_final_recon']:.4f}", flush=True)

    # ---- 2b. the reconstruction FID on the held-out dev set
    fid, dev_imgs = None, None
    if args.fid_images > 0:
        weights = args.fid_weights
        if weights is None:
            weights = os.path.join(args.out, "inception_oracle.pt")
            random_inception_file(weights, INCEPTION_SEED)
        fid = FID(load_inception(weights, device), dim=2048)
        report["fid_weights"] = os.path.basename(weights)

        # fresh draws of the same process; their statistics serve both FIDs
        dev_imgs, _ = make_dataset(max(args.fid_images // 3, 90), seed=777)
        np.save(os.path.join(args.out, "e2e_dev.npy"), dev_imgs)
        ingest_dev(fid, dev_imgs, device)
        t0 = time.time()
        report["recon_fid"] = round(reconstruction_fid(vae, eval_step, fid, dev_imgs,
                                                       args.batch, device), 3)
        report["recon_fid_images"] = int(len(dev_imgs))
        print(f"[fid] reconstruction FID {report['recon_fid']} over {len(dev_imgs)} dev images "
              f"({time.time() - t0:.1f}s)", flush=True)

    # ---- 2c. VQ: codebook utilization and perplexity over held-out data
    if args.bottleneck == "vq":
        probe = dev_imgs if dev_imgs is not None else make_dataset(334, seed=777)[0]
        report.update(vq_numbers(*code_counts(vae, probe, args.batch, device)))
        print(f"[vq] utilization {report['vq_codebook_utilization']:.1%} of "
              f"{arch.codebook_size} codes; dev perplexity {report['vq_dev_perplexity']}",
              flush=True)

    # ---- 3. latents, with the true labels
    lat = encode_latents(vae, imgs, args.batch, device)
    lab = labels[:len(lat)]
    print(f"[latents] {lat.shape} extracted", flush=True)

    # ---- 4. stage 2: the class-conditional UNet
    spe2 = len(lat) // args.batch
    unet_epochs = max(args.unet_steps // spe2, 1)
    dcfg = DiffusionConfig(arch=unet_arch or UNetArch(), schedule=ScheduleConfig(),
                           train=DiffusionTrainConfig(
        learning_rate=1e-4, warmup_steps=200, batch_size=args.batch, epochs=unet_epochs,
        clip_grad=1.0, precision="bf16", seed=0, log_interval=50, ae_type=args.bottleneck,
        cond_drop_prob=0.15, checkpoints_dir=args.out, logs_dir=args.out))
    logger2 = BasicLogger(args.out, RUN_NAMES["unet"], no_mlflow=True, log_interval=50)
    dt = DiffusionTrainer(dcfg, ArrayDataset(lat, lab), logger2, MetricHolder(50),
                          checkpoint=resume_from("unet"), run_name=RUN_NAMES["unet"],
                          device=device)
    t0 = time.time()
    dt.train()
    report["unet_steps"] = unet_epochs * spe2
    report["unet_train_s"] = _elapsed(t0, device)
    print(f"[unet] {report['unet_steps']} steps in {report['unet_train_s']}s", flush=True)

    # ---- 5. sample and grade (VQ bundles re-quantize in the decode)
    pipe = DiffusionPipeline(vcfg.arch, vae.state_dict(), dcfg.arch, dt.state.unet.state_dict(),
                             dcfg.schedule, CLASSES, device=device)
    del vt, dt
    scales = [args.cfg_scale] * args.sample_per_class
    out01 = ((pipe.sample(scales, seed=123) + 1.0) / 2.0).cpu().numpy()
    acc, per_class = grade(out01, args.sample_per_class)
    report["cond_accuracy"] = acc
    report["cond_accuracy_per_class"] = per_class
    print(f"[sample] conditional accuracy {acc:.2f} per-class {per_class}", flush=True)
    drawn = save_grid(out01 * 2 - 1, pipe.classes, scales, os.path.join(args.out, "e2e_grid.png"))
    print(f"[sample] e2e_grid.png: {drawn}", flush=True)

    # ---- 6. the generative FID against the same dev statistics
    if fid is not None:
        pipe.to_checkpoint(os.path.join(args.out, "e2e_bundle.ckpt"))
        t0 = time.time()
        done, seed = 0, 1000
        while done < args.fid_images:
            fimgs = pipe.sample([args.cfg_scale] * (FID_PER_CALL // 3), seed=seed,
                                sampler=args.fid_sampler, num_inference_steps=args.fid_steps)
            take = min(len(fimgs), args.fid_images - done)
            fid.update_fake(((fimgs[:take] + 1.0) / 2.0).clamp(0, 1))
            done += take
            seed += 1
        fid_dt = time.time() - t0
        report["generative_fid"] = round(float(fid.compute()), 3)
        report["fid_images"] = done
        report["fid_sampler"] = f"{args.fid_sampler}-{args.fid_steps}"
        report["fid_img_per_sec"] = round(done / fid_dt, 2)
        print(f"[fid] generative FID {report['generative_fid']} over {done} images "
              f"({report['fid_img_per_sec']} img/s)", flush=True)

    report["wall_s"] = round(time.time() - t_all, 1)
    report["profile"] = args.profile or "custom"
    with open(os.path.join(args.out, "e2e_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    if args.history:
        entry = {"round": args.round_tag or "untagged", **report, "note": card_note(device)}
        os.makedirs(os.path.dirname(args.history) or ".", exist_ok=True)
        with open(args.history, "a") as f:
            f.write(json.dumps(entry) + "\n")
        print(f"[history] appended to {args.history}", flush=True)
    print(json.dumps(report))
    print("E2E_SYNTH", "PASS" if acc >= 0.8 else "FAIL", flush=True)
    return report


def main(argv=None) -> int:
    """The run; exit code 1 when the conditional accuracy is below 0.8."""
    return 0 if run(argv)["cond_accuracy"] >= 0.8 else 1


if __name__ == "__main__":
    sys.exit(main())
