#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero:
  1. the card: name and power limit (nvidia-smi); python, torch, CUDA and
     triton versions; whether matplotlib, PIL and tqdm import and whether
     transformers is installed;
  2. build every kernel of the sampling and both training paths from the
     sources in this checkout (nvcc, sm_90a, one process per source, all
     started together), with the build seconds, nvcc's release and ptxas'
     registers per kernel; a kernel that spills registers fails the phase;
  3. the forward kernel and the row sums it hands to the backward against
     their plain PyTorch version at the shapes the sampling grid gives it
     (batch 54, bf16), at the served batch's (16 rows: 8 conditional and
     8 unconditional), at a phase 14 grid shard's (28 rows) and at a
     call of phase 15's generative FID (60 rows: 30 images), with times of the kernel, the plain version and one
     PyTorch library call, the card's bound and the time its
     special-function units need for the exponentials;
  3b. the backward kernels against their plain version at the same site
     shapes at the training batch (48, bf16, random dO) and at a phase 14
     rank's half of it (24), per operand, both
     called alone (the wrapper launches the forward first) and through
     the forward operator's gradient with its saved output and row sums, which
     is what training runs, with the same times (library: SDPA's backward
     through autograd);
  3c. the flash kernel against its plain version at the VAE's attention
     site (one head, N 1024, D 384) at batches 27 (the grid's decode), 24
     (training's micro-batch at grad_accum 2, and a phase 14 rank's rows),
     48 (training, and phase 15's encode and reconstruction batches), 64
     (prepare_dataset's batch), 8 (the server's decode), 14 (a phase 14
     grid shard's decode) and 30 (a decode of phase 15's generative FID),
     with the same
     times (library: SDPA, its backend named),
     the gradient through `FlashAttention` against autograd of the plain
     version, and the device time of that gradient (the einsum path's
     autograd, which has no kernel);
  4. the full-width UNet forward at batch 54 in bf16: kernel launches per
     forward, its device time by kernel (torch.profiler), and two rows
     against the same rows run on the CPU;
  5. the main path: a random-weight bundle of the shipped KL config
     (UNetArch(), VAEArch()) written and read back with
     `DiffusionPipeline.from_checkpoint`, the 27-image CFG grid over the
     1000-step DDPM schedule, then the dpm-20 grid as uint8 (and its
     device busy time, torch.profiler), each grid's decode launching the
     flash kernel once, and a tiny pipeline on the card against the CPU;
  6. training on the card: full-width UNet gradients at batch 2 through
     the kernel pair against the CPU's plain pair; 25 steps of the shipped
     config (`configs/diff-kl-lin-32x32.yaml`, batch 48, bf16 compute on
     fp32 parameters) through `image_diffusion_torch.scripts
     .train_diffusion` on synthetic latents, with ms/step, loss and
     gradient norm at each flush, and kernel launches per step; a resume
     from its checkpoint; a torch.profiler trace of 3 train steps;
  7. stage-1 training on the card: full-width VAE + discriminator + LPIPS
     gradients at batch 2 through the flash kernel against the CPU's plain
     version; 3 steps of the end-to-end run's KL stage 1 at full width,
     batch 2, fp32 with TF32 off, card against CPU from one state (losses,
     parameter updates), and the same steps on the card in bf16 (2 flash
     launches a step) against the CPU's fp32; 25 steps of
     `configs/vae-kl-32x32.yaml` (batch 48 of 128x128x3 uint8, bf16
     compute on fp32 parameters, random LPIPS weights from a file; only
     paths, epochs: 1, log_interval: 5 and disc_start: 10 overridden)
     through `image_diffusion_torch.scripts.train_vae` on synthetic
     images with a dev set whose last batch is padded, with losses and
     imgs/s at each flush, ms/step, and flash launches per step; a resume
     from its checkpoint; a torch.profiler trace of 3 train steps;
  8. the two stages joined through the CLIs' `main`s: `prepare_dataset
     diffusion --labels-mode random` on phase 7's images and checkpoint
     (batches of 64: images/s, one flash launch a batch, rows against the
     CPU at fp32), `train_diffusion` (the shipped config, EMA on) on
     those latents and labels, `make_bundle --ema` (the bundle's weights
     against the checkpoints' fp32 trees), and `sample_grid`'s defaults
     (ddpm-1000, 27 images) and `--sampler dpm`: img/s as the CLI logs
     it, launches, and the images against `pipe.sample` with the same
     arguments; the figure when matplotlib is installed;
  9. stage-1 VQ training on the card (`configs/vae-vq-32x32.yaml`, EMA
     codebook 1024x3): (a) full-width gradients at batch 2 against the
     CPU, with the share of tokens whose code differs between them; (f)
     3 steps of the end-to-end run's VQ stage 1 as phase 7's KL ones, the
     codebook held too and the share of tokens whose code differs printed
     per step; (b)
     the codebook lookup on the card's fp32 encoder output for batch 48
     against float64 distances; (c) one EMA update at batch 48 against its
     float64 statement, and the codebook's device time; (d) 25 steps
     through `train_vae` as in phase 7, the perplexity at each flush and
     on the dev set, a resume that restores the codebook, a profile; (e)
     one step at grad_accum 2 against grad_accum 1 from one state and
     batch: gradient, codebook, peak memory, ms/step and flash launches;
  10. the UNet trainer's remaining features at full width: (a) one train
     step at batch 48 of the shipped config under each remat policy (none,
     dots, full) from one deep-copied state and batch: the gradient against
     none's, peak memory above the held state, median ms/step over 5 steps,
     device busy, and packed launches a step (14 + 14 under every policy);
     (b) 10 steps through `train_diffusion --remat dots`; (c) the trainer's
     preview (`Preview`, dpm-20 at scale 3) from phase 7's VAE checkpoint
     and phase 8's EMA weights against `pipe.sample` of phase 8's --ema
     bundle, bit for bit, with its seconds and launches; (d) `--debug-nans`
     raising FloatingPointError at a NaN in one latent;
  11. FID: (a) random InceptionV3 weights in torchvision's layout written to
     a file; (b) the card's features against the CPU's in fp32 on 8 of
     phase 7's images (and, not held, with TF32 on); (c) feature
     throughput at chunks of 256; (d) one epoch of phase 7's config through
     `train_vae --fid-weights`: dev/FID against its recomputation from the
     same evaluation outputs, and what FID adds to the dev evaluation; (e)
     `eval_fid` on phase 8's bundle against phase 7's images (270 images,
     ddim-50, batch 64): the FID against the port's FID over `pipe.sample`
     with the same seeds, img/s, launches a DDIM step;
  12. serving: (a) `python -m image_diffusion_torch.scripts.serve` as a
     subprocess (batch 8, dpm-20, linger 40 ms) on a bundle of the shipped
     KL config: seconds until /healthz says warm, the median latency of 10
     sequential requests, a burst of 64 concurrent requests (3 classes, cfg
     1-9, distinct seeds: wall time, img/s, p50/p95 latency, errors, batches
     against requests from /info) and two of its requests again alone,
     byte-identical; (b) the server's `Engine` in this process: launches
     a served batch, its device idle share, the batch against
     `sample_batch` with the same per-row generators, bit for bit, and
     under ddim-50 with eta 1 a request alone in slot 0 against the same
     request in slot 5 of a full batch, byte for byte;
  13. CLIP zero-shot labels at ViT-B/32's widths, random weights in
     transformers' layout from numpy: logits card vs CPU in fp32 (and, not
     held, with TF32 on), `encode_images` images/s at batch 64, and
     `prepare_dataset.zero_shot_labels` on 1,200 synthetic processed images
     against the CPU's labels (a difference must be a near-tie); where
     transformers is installed, `prepare_dataset --labels-mode clip` with
     phase 7's VAE on 1,200 images from a CLIP directory of those weights
     written by the script, `--clip-backend port` against `torch`;
  14. the multi-device layer on the one card: (a) under `torchrun
     --nproc-per-node 1` over NCCL, one data-parallel step of the shipped
     UNet at batch 48 against the plain step from a deep copy of one
     state, bit for bit, then 5 steps of `train_diffusion --data-parallel
     1`; two NCCL ranks on the one card refused; (b) two ranks sharing the
     card over gloo (CUDA tensors), each on 24 of 48 rows: one UNet step
     replicated, one under FSDP (data 1 x model 2), and one KL and one VQ
     stage-1 step with the discriminator active, each against the
     one-process step of 48 from the same state (losses, gradient norms
     before the clip, clipped gradients, Adam's second moments, BatchNorm
     and codebook statistics), the ranks' parameters bit-equal, launches per rank, and the gloo all-reduce's
     time (the cost of gloo on one card, not a scaling figure); (c) the
     27-image dpm-20 and ddpm-1000 grids sharded in one process over
     ["cuda:0", "cuda:0"] (28 padded rows) against the unsharded grids,
     each shard bit-equal to sampling its rows alone, with wall time and
     idle share beside phase 5's, and `sample_grid --data-parallel 1`.
     The ranks are this script under `--rank-worker`.
  15. the end-to-end quality run in this process
     (`image_diffusion_torch.tools.e2e_synthetic_run.run`), KL and then
     VQ, at full width and reduced depth (`E2E_ARGS`: 1,200 images, 50
     stage-1 and 50 UNet steps at batch 48, 270 dev images, 90 images for
     the generative FID): seconds, the report's keys against the JAX
     tool's, its numbers finite, the real data's grade, the bundle
     against the trainers' last checkpoints bit for bit, and each
     kernel's launches against the count of the path (14 + 14 packed a
     UNet step, 14 packed a sampler step, 2 flash a stage-1 step and a
     reconstruction batch, 1 flash an encode batch and a decode); the
     conditional accuracy is printed, not held, at this depth.
Then a JSON line of kernel records, the nvidia-smi line, and as the last
line `{"ok": true, "device": {...}}`.  Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from importlib import metadata

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 rate
EXP_PER_CLOCK = 16 * 132  # special-function results a clock: 16 on each of 132 SMs
B_GRID = 54               # 27 images x 2 (conditional + unconditional rows)
B_TRAIN = 48              # the shipped config's batch_size
B_ENCODE = 64             # prepare_dataset's default --batch-size
B_RANK = B_TRAIN // 2     # a UNet or stage-1 step's rows on each of phase 14's two ranks
B_SHARD = 2 * 14          # a UNet call on each of phase 14's two grid shards: 14 of 28 padded images
B_FID = 2 * 30            # a UNet call of phase 15's generative FID: 30 images (3 classes x 10)
TRAIN_STEPS = 25          # trainer steps in phase 6: 5 flushes of log_interval 5
CONFIG = "configs/diff-kl-lin-32x32.yaml"
VAE_CONFIG = "configs/vae-kl-32x32.yaml"
VAE_TRAIN_STEPS = 25      # stage-1 trainer steps in phase 7, log_interval 5
VAE_DISC_START = 10       # phase 7's disc_start: steps without and with the discriminator
VQ_CONFIG = "configs/vae-vq-32x32.yaml"  # phase 9, the same overrides as phase 7
# (N tokens, C channels, heads) of the UNet's 14 self-attention sites, two each
SITES = [(1024, 256, 8), (256, 384, 8), (64, 512, 8), (16, 512, 8),
         (64, 384, 8), (256, 256, 8), (1024, 128, 8)]
# kernel vs plain version: |k - p| <= ATOL + RTOL * |p| elementwise (bf16
# outputs; the repo's on-chip kernel bar was 2e-2)
ATOL = RTOL = 2e-2
# backward kernel, per operand: max|k - p| / max|p| (the CPU tests' bar).
# The gradients' typical size is ~0.05 at N=1024, so the elementwise bar
# above alone would let a systematic error of a few percent through
BWD_REL_MAX = 2e-2
# the forward's fp32 row sums vs the plain version's: max |k - p| / p (the
# same fp32 weights summed in another order)
ROW_SUM_REL = 1e-3
# full-width UNet, card vs CPU rows in bf16: relative L2 error.  Both sides
# round to bf16 at the same points, but sum in different orders through ~100
# layers (bf16 vs fp32 of a reduced-width UNet on the CPU differ by 3.4e-2);
# a wiring fault (wrong head band, layout) gives O(1)
UNET_REL_L2 = 1e-1
# tiny pipeline, card vs CPU in bf16 through 4 dpm steps and the decode
TINY_REL_L2 = 1e-1
# full-width UNet gradients at batch 2, card (kernel pair) vs CPU (plain
# pair), bf16 compute on the same fp32 parameters: relative L2 of the whole
# gradient vector and of the 14 sites' to_q/to_k/to_v weight gradients
# together, of the same kind as UNET_REL_L2; a site whose attention
# gradient is lost gives 1.0 on its projections.  Each site's own
# projections are held to the looser SITE_GRAD_REL_L2
GRAD_REL_L2 = 1e-1
SITE_GRAD_REL_L2 = 2.5e-1
# Phase 7 holds the stage-1 gradients to the same two bars: the VAE's, the
# 2 sites' q/k/v weights', and the discriminator's d_loss gradient as its
# fake and real terms apart.  At init those terms nearly cancel (their sum's
# norm is ~15% of theirs), so the sum's relative error is several times its
# terms' bf16 rounding; it is printed, not held
# phase 9: the EMA codebook update and the state after a step, card vs float64
# or accum 2 vs 1: max|diff| / max|reference| per tensor.  The cluster sizes
# and ema_w are fp32 sums over up to 49,152 tokens a code, which index_add_
# on the card adds in no fixed order
EMA_REL = 1e-4
# phases 7 and 9: 3 steps of the end-to-end run's stage 1 at full width,
# batch 2, fp32 with TF32 off, card vs CPU from one state: each step's
# losses (relative), the parameter updates p - p0 over all tensors
# (relative L2: the CPU tests' fp32 bar against JAX, Adam turning fp noise
# in near-zero gradients into lr-sized steps) and the codebook (EMA_REL,
# on the card's codes)
STEPS_N, STEPS_BATCH = 3, 2
STEPS_LOSS_REL = 1e-4
STEPS_UPDATE_REL_L2 = 1e-3
# the same steps on the card in bf16 (the mid-block attention through the
# flash kernel, 2 launches a step) against the CPU's fp32 run: bf16 rounding
# of the recon loss (the prior loss is printed: VQ's moves with the tokens
# that take another code), of the parameter updates over all tensors and
# over the attention sites' to_q/to_k/to_v/out_proj alone (two unrelated
# updates read ~1.4), and of the codebook (max|diff| / max); bars at about
# 3x the readings on an H100 (recon loss 2.1e-3, updates 2.1e-1 and 1.9e-1
# at the sites, codebook 6.9e-2, all at the first VQ steps)
STEPS_BF16_LOSS_REL = 6e-3
STEPS_BF16_UPDATE_REL_L2 = 6e-1
STEPS_BF16_CODEBOOK_REL = 2e-1
# phase 8: a few rows of prepare_dataset's latents (bf16 on the card, stored
# as fp16) against the same rows encoded on the CPU at fp32: relative L2,
# of the same kind as UNET_REL_L2 through the encoder's ~40 layers
ENCODE_REL_L2 = 5e-2
# phase 10: a remat policy's clipped gradient against none's from one state
# and batch, max|diff| / max|none|.  The recomputed GroupNorm/SiLU chains
# are the same kernels on the same inputs, so the gradients are bit-equal
# unless a backward sums in another order (none against none is printed)
REMAT_GRAD_REL = 1e-3
# phase 11: the FID Inception's features, card vs CPU in fp32 with TF32 off,
# max|diff| / max|CPU|, through ~95 fp32 convolutions summed in other orders
INCEPTION_REL = 1e-4
# phase 11: a FID against its recomputation from the same images and
# features (the same float64 sums in the same order): |diff| / FID
FID_REL = 1e-6
# phase 12: the server's fixed batch, sampler and linger, as users start it,
# and the burst of concurrent requests
SERVE_ARGS = ["--batch-size", "8", "--sampler", "dpm", "--steps", "20", "--linger-ms", "40"]
SERVE_BATCH = 8
SERVE_BURST = 64
# phase 13: CLIP at openai/clip-vit-base-patch32's widths (its config.json;
# the text tower's eos_token_id 2 selects transformers' legacy pooling)
CLIP_B32 = dict(vision_width=768, vision_layers=12, vision_heads=12, vision_hidden=3072,
                image_size=224, patch_size=32, text_width=512, text_layers=12, text_heads=8,
                text_hidden=2048, vocab_size=49408, text_positions=77, projection_dim=512)
CLIP_IMAGES = 1200
# phase 13: CLIP logits, card vs CPU in fp32 with TF32 off, max|diff| / max
# |CPU| through 12 + 12 fp32 layers summed in other orders; a label that
# differs must be a near-tie: the two logits within CLIP_TIE of the row's
# largest |logit|
CLIP_REL = 1e-4
CLIP_TIE = 1e-4
# phase 14: a data-parallel step on the card (2 ranks of 24 rows, or FSDP)
# against the one-process step of 48 from one state, both bf16 compute:
# the losses' relative difference (means over 48 x 3,072 or more terms,
# each rounded in bf16 at another row count), and BatchNorm's running
# statistics and the codebook after the step, max|diff| / max (bf16 batch
# statistics over 24 + 24 against 48 rows; phase 9 (e) found 1.8e-4 on the
# codebook when 89 tokens changed code).  The gradients' global norms
# before the clip (`unet/grad`, `vae/vae_grad`, `gan/disc_grad`) are held
# to DP_LOSS_REL as well: the clip fires in these steps (norms ~2.4 and ~20
# against clip_grad 1), so the clipped gradients and Adam's moments do not
# depend on the gradient's scale, and the norm is what shows a gradient
# averaged by a wrong factor (2x gives 1.0).  The clipped gradients are held
# to phase 6's card-vs-CPU bar GRAD_REL_L2, of the same kind, and Adam's
# second moments, the clipped gradients squared, to twice it (squaring
# doubles a relative error), both relative L2.  The parameters are not held:
# Adam's first update moves an element by about the learning rate in its
# gradient's sign, so any two first steps differ by up to 2 x lr wherever a
# near-zero gradient element changes sign; they follow from the moments
DP_LOSS_REL = 1e-2
DP_NU_REL_L2 = 2 * GRAD_REL_L2
DP_STATS_REL = 1e-2
# the metrics that are a gradient's global norm before the clip
GRAD_NORMS = ("unet/grad", "vae/vae_grad", "gan/disc_grad")
# phase 14: the grid sharded over two shards of the card (28 UNet rows a
# call) against the unsharded grid (54): relative L2.  Each shard is held
# bit-equal to `sample_batch` of its own rows (dpm-20); against the
# 54-row grid the rows see cuBLAS and cuDNN at another row count, and the
# random-weight UNet with guidance up to 9 magnifies that bf16 rounding
# (1.0e-1 for dpm-20 on an H100 80GB HBM3 at 700 W); a row that took
# another row's label, scale or noise gives O(1)
SHARD_GRID_REL = 0.5
# csrc/<name>.cu of every kernel the paths run
KERNEL_SOURCES = ["packed_attention", "packed_attention_bwd", "flash_attention"]
# phase 15: the end-to-end quality tool at full width and reduced depth
# (1,200 images; 2 epochs of 25 steps of 48 in each stage; 270 dev images;
# 90 generated images for the generative FID in 3 calls of 30)
E2E_ARGS = ["--n-per-class", "400", "--vae-steps", "50", "--unet-steps", "50",
            "--fid-images", "90"]
# the report's keys, the JAX tool's for each bottleneck
# (tools/e2e_synthetic_run.py:213-451)
E2E_KEYS = ["real_classifier_acc", "bottleneck", "vae_steps", "vae_train_s", "vae_final_recon",
            "fid_weights", "recon_fid", "recon_fid_images", "unet_steps", "unet_train_s",
            "cond_accuracy", "cond_accuracy_per_class", "generative_fid", "fid_images",
            "fid_sampler", "fid_img_per_sec", "wall_s", "profile"]
E2E_VQ_KEYS = ["vq_codebook_size", "vq_codebook_utilization", "vq_dev_perplexity", "vq_dev_images"]


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_summary(text: str) -> tuple[list[str], int]:
    """(["kernel<template args> registers, spill stores/loads", ...] for each
    entry function in ptxas' verbose output, the spill bytes of all of them
    together)."""
    out, name, spill, spilled = [], None, "", 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"([A-Za-z_]*kernel)(I((?:Li\d+E)+)E)?", m.group(1))
            name = k.group(1) if k else m.group(1)
            if k and k.group(3):
                name += "<" + ",".join(re.findall(r"Li(\d+)E", k.group(3))) + ">"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores/loads {m.group(1)}/{m.group(2)} B"
            spilled += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)} registers, {spill}")
    return out, spilled


def rel_l2(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, fn, iters: int = 3):
    """Kernels the card ran per call of `fn`, from a torch.profiler (CUPTI)
    trace of `iters` calls: ({kernel name: device ms per call}, kernels
    launched per call, host-clock ms per call ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = {e.key: e.self_device_time_total / 1e3 / iters for e in kernels}
    return ms, sum(e.count for e in kernels) / iters, wall_ms


def device_ms(torch, fn) -> float:
    """Device time of one call of `fn`: its kernels' durations summed, from
    a torch.profiler trace of 5 calls.  Unlike the CUDA-event time of a run
    of calls it leaves out the gaps the host leaves between short kernels.
    A trace now and then comes back without device events (seen once in
    three dozen traces of one call); it is taken again, up to twice."""
    fn()
    for _ in range(3):
        ms = sum(device_profile(torch, fn, iters=5)[0].values())
        if ms > 0:
            break
    return ms


def idle_share(busy_ms: float, wall_ms: float) -> str:
    return f"{1 - busy_ms / wall_ms:.3f}" if busy_ms > 0 else "not measured (no device events)"


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi gives it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def exp_ms(exponentials: float, clock_hz: float) -> float:
    """The least time the card's special-function units need for that many
    exp2: 16 a clock on each of 132 SMs at the maximum SM clock.  Not part
    of `bound_ms` (a polynomial on the FMA units could share the load)."""
    return exponentials / (EXP_PER_CLOCK * clock_hz) * 1e3


def phase_kernels(torch, F, attn, clock_hz, B):
    """Phase 3: packed attention, and the row sums it hands to the
    backward, vs its plain version and SDPA per site, at batch B."""
    sites = []
    for N, C, h in SITES:
        d = C // h
        g = torch.Generator(device="cuda").manual_seed(1000 * N + C + B)
        q, k, v = (torch.randn(B, N, C, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        with torch.no_grad():  # as the sampler calls it: the kernel gets no row_sum pointer
            got = attn.packed_attention(q, k, v, h)
        _, sums = attn.packed_attention_with_row_sum(q, k, v, h)
        ref, ref_sums = attn.reference_packed_attention(q, k, v, h, return_row_sum=True)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        max_abs = float(diff.max())
        ratio = float((diff / (ATOL + RTOL * ref.float().abs())).max())
        sum_rel = float(((sums - ref_sums).abs() / ref_sums).max())
        del sums, ref_sums
        heads = [t.view(B, N, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
        with torch.no_grad():
            ms = cuda_ms(lambda: attn.packed_attention(q, k, v, h), iters=20)
            dev_ms = device_ms(torch, lambda: attn.packed_attention(q, k, v, h))
        plain_ms = cuda_ms(lambda: attn.reference_packed_attention(q, k, v, h), iters=5)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads), iters=20)
        lib_dev_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(*heads))
        flops, nbytes = 4 * B * N * N * C, 4 * B * N * C * 2
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        site = dict(B=B, N=N, C=C, d=d, max_abs_err=max_abs, tol_ratio=ratio, row_sum_rel_err=sum_rel,
                    ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                    bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
                    exp_ms=exp_ms(B * h * N * N, clock_hz))  # one exp2 per score
        sites.append(site)
        log(f"phase 3 kernel  B={B} N={N:5d} C={C} d={d}: max|err|={max_abs:.3e} "
            f"(tolerance ratio {ratio:.3f}), row sums max rel err {sum_rel:.3e} (tolerance "
            f"{ROW_SUM_REL}); kernel {ms:.4f} ms ({dev_ms:.4f} ms on the device), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms on the device), "
            f"bound {bound_ms:.4f} ms ({site['bound_by']}), "
            f"exponentials {site['exp_ms']:.4f} ms")
        if not (ratio <= 1.0 and sum_rel <= ROW_SUM_REL):
            raise AssertionError(f"kernel disagrees with its plain version at B={B} N={N} C={C}")
    return sites


def phase_bwd_kernels(torch, F, attn, clock_hz, B):
    """Phase 3b: the backward kernels vs their plain version and SDPA's
    backward per site, at batch B: called alone, and through the forward
    operator's gradient with its saved output and row sums."""
    sites = []
    for N, C, h in SITES:
        d = C // h
        g = torch.Generator(device="cuda").manual_seed(2000 * N + C)
        q, k, v, do = (torch.randn(B, N, C, generator=g, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        alone = attn.packed_attention_bwd(q, k, v, do, h)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (attn.packed_attention.launches, attn.packed_attention_bwd.launches)
        attn.packed_attention(*leaves, h).backward(do)
        launched = (attn.packed_attention.launches - before[0],
                    attn.packed_attention_bwd.launches - before[1])
        got = [t.grad for t in leaves]
        ref = attn.reference_packed_attention_bwd(q, k, v, do, h)
        torch.cuda.synchronize()
        # the same kernels on the same statistics: bit for bit
        same = all(torch.equal(a, b) for a, b in zip(alone, got))
        errs, ratios, rels = {}, {}, {}
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            diff = (a.float() - b.float()).abs()
            errs[name] = float(diff.max())
            ratios[name] = float((diff / (ATOL + RTOL * b.float().abs())).max())
            rels[name] = errs[name] / float(b.float().abs().max())
        del alone, got, ref, leaves
        out, sums = attn.packed_attention_with_row_sum(q, k, v, h)
        heads = [t.view(B, N, h, d).transpose(1, 2).contiguous().requires_grad_()
                 for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*heads)
        do_heads = do.view(B, N, h, d).transpose(1, 2).contiguous()
        # what the forward operator's gradient calls: the kernels on the saved statistics
        ms = cuda_ms(lambda: attn.packed_attention_bwd(q, k, v, do, h, out, sums), iters=20)
        by_kernel = device_profile(torch, lambda: attn.packed_attention_bwd(q, k, v, do, h, out, sums),
                                   iters=5)[0]
        dev_ms = sum(by_kernel.values())
        dkdv_dev_ms = sum(t for name, t in by_kernel.items() if "dkdv_kernel" in name)
        alone_ms = cuda_ms(lambda: attn.packed_attention_bwd(q, k, v, do, h), iters=20)
        plain_ms = cuda_ms(lambda: attn.reference_packed_attention_bwd(q, k, v, do, h), iters=3,
                           warmup=1)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, heads, do_heads, retain_graph=True),
                         iters=20)
        lib_dev_ms = device_ms(torch, lambda: torch.autograd.grad(lib_out, heads, do_heads,
                                                                  retain_graph=True))
        del lib_out, heads, out, sums
        # five products; q, k, v, dO read and dq, dk, dv written once
        flops, nbytes = 10 * B * N * N * C, 7 * B * N * C * 2
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        site = dict(B=B, N=N, C=C, d=d, max_abs_err=max(errs.values()), max_abs_err_by_operand=errs,
                    tol_ratio_by_operand=ratios, rel_max_by_operand=rels, ms=ms, device_ms=dev_ms,
                    dq_device_ms=dev_ms - dkdv_dev_ms, dkdv_device_ms=dkdv_dev_ms,
                    alone_ms=alone_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                    bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
                    # the dq and the dk/dv kernel each take one exp2 per score
                    exp_ms=exp_ms(2 * B * h * N * N, clock_hz))
        sites.append(site)
        log(f"phase 3b bwd kernel B={B} N={N:5d} C={C} d={d}: max|err| "
            + " ".join(f"{n} {errs[n]:.3e}" for n in errs) + "; tolerance ratio "
            + " ".join(f"{n} {ratios[n]:.3f}" for n in ratios) + "; max|err|/max|plain| "
            + " ".join(f"{n} {rels[n]:.3e}" for n in rels) + f" (tolerance {BWD_REL_MAX})"
            + f"; alone equals through the operator's gradient bit for bit: {same}; kernel {ms:.4f} ms "
            f"with the forward's statistics ({dev_ms:.4f} ms on the device: dq "
            f"{dev_ms - dkdv_dev_ms:.4f}, dk/dv {dkdv_dev_ms:.4f}), {alone_ms:.4f} ms "
            f"alone, plain {plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms on the "
            f"device), bound {bound_ms:.4f} ms ({site['bound_by']}), "
            f"exponentials {site['exp_ms']:.4f} ms")
        if launched != (1, 1):
            raise AssertionError(f"the packed operators launched {launched} forward and backward "
                                 f"kernels at B={B} N={N} C={C}, expected one each")
        if not (same and max(ratios.values()) <= 1.0 and max(rels.values()) < BWD_REL_MAX):
            raise AssertionError(f"backward kernel disagrees with its plain version at B={B} N={N} "
                                 f"C={C}")
    return sites


def phase_flash_kernel(torch, F, attn, clock_hz):
    """Phase 3c: the flash kernel against its plain version at the VAE's
    attention site (one head, N = 32*32, D = 384) at the grid's decode batch,
    the training batch and a rank's half of it, prepare_dataset's batch, the
    server's batch and a grid shard's decode, with times, and the gradient
    through `FlashAttention` against autograd of the plain version."""
    from torch.nn.attention import SDPBackend

    N, D = 1024, 384
    scale = 1.0 / D ** 0.5
    batches = []
    for B in (B_GRID // 2, B_RANK, B_TRAIN, B_ENCODE, SERVE_BATCH, B_SHARD // 2, B_FID // 2):
        g = torch.Generator(device="cuda").manual_seed(3000 + B)
        q, k, v = (torch.randn(B, 1, N, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        with torch.no_grad():
            before = attn.flash_attention.launches
            got = attn.flash_attention(q, k, v, scale)
            ref = attn.reference_flash_attention(q, k, v, scale)
            torch.cuda.synchronize()
            launched = attn.flash_attention.launches - before
            diff = (got.float() - ref.float()).abs()
            max_abs = float(diff.max())
            ratio = float((diff / (ATOL + RTOL * ref.float().abs())).max())
            rel = max_abs / float(ref.float().abs().max())
            del got, ref, diff
            ms = cuda_ms(lambda: attn.flash_attention(q, k, v, scale), iters=20)
            dev_ms = device_ms(torch, lambda: attn.flash_attention(q, k, v, scale))
            plain_ms = cuda_ms(lambda: attn.reference_flash_attention(q, k, v, scale), iters=5)
            backend = SDPBackend(torch._fused_sdp_choice(q, k, v, scale=scale)).name
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters=20)
            lib_dev_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))

        # the gradient: FlashAttention (kernel forward) vs the plain version's autograd
        w = torch.randn(B, 1, N, D, generator=g, device="cuda").to(torch.bfloat16)
        grads = []
        for fn in (attn.flash_attention, attn.reference_flash_attention):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = attn.flash_attention.launches
            (fn(*leaves, scale).float() * w.float()).sum().backward()
            if fn is attn.flash_attention and attn.flash_attention.launches - before != 1:
                raise AssertionError("FlashAttention with grad did not launch the kernel once")
            grads.append([t.grad for t in leaves])
        grad_rel = {}
        for name, a, b in zip(("dq", "dk", "dv"), *grads):
            grad_rel[name] = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        del grads
        # what a train step pays for the gradient: FlashAttention's backward,
        # autograd of the einsum path (no kernel of the port)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attn.flash_attention(*leaves, scale)
        bwd_dev_ms = device_ms(torch, lambda: torch.autograd.grad(out, leaves, w, retain_graph=True))
        del leaves, out, w

        flops, nbytes = 4 * B * N * N * D, 4 * B * N * D * 2
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row = dict(B=B, H=1, N=N, D=D, max_abs_err=max_abs, tol_ratio=ratio, rel_max=rel,
                   grad_rel_max_by_operand=grad_rel, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library_device_ms=lib_dev_ms, library_backend=backend,
                   einsum_backward_device_ms=bwd_dev_ms, bound_ms=bound_ms,
                   bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
                   exp_ms=exp_ms(B * N * N, clock_hz))  # one exp2 per score
        batches.append(row)
        log(f"phase 3c flash kernel B={B} H=1 N={N} D={D}: max|err|={max_abs:.3e} (tolerance ratio "
            f"{ratio:.3f}, max|err|/max|plain| {rel:.3e}); gradient max|err|/max|plain| "
            + " ".join(f"{n} {grad_rel[n]:.3e}" for n in grad_rel)
            + f" (tolerance {BWD_REL_MAX}); kernel {ms:.4f} ms ({dev_ms:.4f} ms on the device), "
            f"plain {plain_ms:.4f} ms, sdpa ({backend}) {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms on the "
            f"device), bound {bound_ms:.4f} ms ({row['bound_by']}), exponentials "
            f"{row['exp_ms']:.4f} ms; the gradient's einsum backward {bwd_dev_ms:.4f} ms on the device")
        if not (launched == 1 and ratio <= 1.0 and rel < BWD_REL_MAX
                and max(grad_rel.values()) < BWD_REL_MAX):
            raise AssertionError(f"flash kernel disagrees with its plain version at B={B}")
        del q, k, v
    return batches


def _random_lpips_file(torch, path: str) -> None:
    """Random LPIPS weights in torchvision's VGG16 layout (He-scaled convs,
    positive lin weights), saved as a torch state dict."""
    from image_diffusion_torch.models.lpips import VGG16_STAGES

    g = torch.Generator().manual_seed(0)
    state, idx, cin = {}, 0, 3
    for i, (cout, n_convs) in enumerate(VGG16_STAGES):
        for _ in range(n_convs):  # features.{idx}: conv, then its ReLU at idx + 1
            state[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=g) * (2.0 / (cin * 9)) ** 0.5
            state[f"features.{idx}.bias"] = torch.randn(cout, generator=g) * 0.05
            cin, idx = cout, idx + 2
        idx += 1  # the max pool
        state[f"lin.{i}.weight"] = (torch.randn(1, cout, 1, 1, generator=g) * 0.1).abs()
    torch.save(state, path)


def _override(text: str, values: dict) -> str:
    """The flat YAML `text` with the named keys' values replaced."""
    lines = []
    for line in text.splitlines():
        key = line.split(":", 1)[0].strip()
        lines.append(f"{key}: {values[key]}" if key in values and not line.startswith("#") else line)
    return "\n".join(lines) + "\n"


def _diffusion_config(tmp, name, latents, labels):
    """The shipped UNet config with the data paths, `epochs: 1` and
    `log_interval: 5` overridden, written to `tmp`."""
    with open(CONFIG) as f:
        text = _override(f.read(), {
            "train_set": latents, "train_labels": labels,
            "checkpoints_dir": os.path.join(tmp, "ckpt"), "logs_dir": os.path.join(tmp, "logs"),
            "epochs": 1, "log_interval": 5})
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_train(torch, np, attn, unet_state):
    """Phase 6: training on the card."""
    import csv

    from image_diffusion_torch.core.config import UNetArch
    from image_diffusion_torch.models import build_unet
    from image_diffusion_torch.scripts.train_diffusion import main as train_main

    # 1. full-width gradients at batch 2, card (kernel pair) vs CPU (plain pair)
    g = torch.Generator().manual_seed(6)
    x, noise = torch.randn(2, 32, 32, 3, generator=g), torch.randn(2, 32, 32, 3, generator=g)
    t, c, mask = torch.tensor([10, 900]), torch.tensor([0, 2]), torch.tensor([[1.0], [0.0]])
    grads, secs = [], []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        unet = build_unet(UNetArch(), torch.bfloat16, dev, param_dtype=torch.float32)
        unet.load_state_dict(unet_state)
        eps = unet(*(a.to(dev) for a in (x, t, c, mask)))
        torch.mean((eps.float() - noise.to(dev)) ** 2).backward()
        grads.append({n: p.grad.float().cpu() for n, p in unet.named_parameters()})
        secs.append(time.perf_counter() - t0)
        del unet, eps
    card, cpu = grads

    def rel(names):
        a = torch.cat([card[n].flatten() for n in names])
        b = torch.cat([cpu[n].flatten() for n in names])
        return float((a - b).norm() / b.norm())

    qkv = [n for n in cpu if n.rsplit(".", 2)[-2] in ("to_q", "to_k", "to_v") and n.endswith("weight")]
    site_names = sorted({n.rsplit(".", 2)[0] for n in qkv})
    per_site = {s: rel([n for n in qkv if n.startswith(s + ".")]) for s in site_names}
    whole, qkv_err = rel(list(cpu)), rel(qkv)
    log(f"phase 6 gradients: full-width UNet, batch 2, card vs CPU rel L2: all parameters "
        f"{whole:.3e}, to_q/to_k/to_v weights of {len(site_names)} sites {qkv_err:.3e} "
        f"(tolerance {GRAD_REL_L2}), worst site {max(per_site.values()):.3e} "
        f"(tolerance {SITE_GRAD_REL_L2}); card {secs[0]:.1f} s, CPU {secs[1]:.1f} s")
    if len(site_names) != 14 or not (whole <= GRAD_REL_L2 and qkv_err <= GRAD_REL_L2
                                     and max(per_site.values()) <= SITE_GRAD_REL_L2):
        raise AssertionError("full-width UNet gradients on the card disagree with the CPU")
    del grads, card, cpu

    # 2. the trainer through its entry point, 25 steps of the shipped config
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        n = TRAIN_STEPS * B_TRAIN
        np.save(os.path.join(tmp, "latents.npy"),
                rng.standard_normal((n, 32, 32, 6), dtype=np.float32).astype(np.float16))
        np.save(os.path.join(tmp, "labels.npy"), rng.integers(0, 3, n).astype(np.uint8))
        config = _diffusion_config(tmp, "config", os.path.join(tmp, "latents.npy"),
                                   os.path.join(tmp, "labels.npy"))
        args = ["--config", config, "--experiment-name", "smoke", "--no-mlflow"]
        attn.packed_attention.launches = attn.packed_attention_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train_main(args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {"forward": attn.packed_attention.launches,
                    "backward": attn.packed_attention_bwd.launches}
        with open(os.path.join(tmp, "logs", "smoke_metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        flushes = {}
        for r in rows:
            flushes.setdefault(int(r["step"]), {})[r["name"]] = float(r["value"])
        flushes.pop(0, None)  # the epoch loss row (step = epoch 0)
        steps = sorted(flushes)
        # the flushes after the first: 5 steps each, timed between syncs
        later = [flushes[s]["unet/samples_per_sec"] for s in steps[1:]]
        step_ms = sum(5 * B_TRAIN / sps for sps in later) / (5 * len(later)) * 1e3
        for s in steps:
            log(f"phase 6 train flush at step {s + 1}: loss {flushes[s]['unet/loss']:.5f}, "
                f"grad norm {flushes[s]['unet/grad']:.4f}, lr {flushes[s]['unet/lr']:.3e}, "
                f"{flushes[s]['unet/samples_per_sec']:.1f} samples/s")
        init = build_unet(UNetArch(), torch.float32, "cpu", torch.Generator().manual_seed(0))
        moved = [(p.detach().cpu() - q.detach()).abs().flatten() for (name, p), q in
                 zip(trainer.unet.named_parameters(), init.parameters())
                 if name.endswith("weight") and p.dim() > 1]
        moved = torch.cat(moved)
        frac_moved, mean_moved = float((moved > 0).float().mean()), float(moved.mean())
        ckpt = os.path.join(tmp, "ckpt", "smoke", "unet-epoch-00.ckpt")
        finite = all(np.isfinite([f["unet/loss"], f["unet/grad"]]).all() for f in flushes.values())
        fp32 = all(p.dtype == torch.float32 for p in trainer.unet.parameters())
        log(f"phase 6 trainer: {trainer.state.step} steps in {run_s:.1f} s through "
            f"image_diffusion_torch.scripts.train_diffusion (set-up and checkpoint included); "
            f"{step_ms:.2f} ms/step after the first 5 ({B_TRAIN / step_ms * 1e3:.1f} samples/s); "
            f"kernel launches {launches['forward']} forward, {launches['backward']} backward "
            f"({launches['forward'] / TRAIN_STEPS:.0f} + {launches['backward'] / TRAIN_STEPS:.0f} "
            f"per step); fp32 parameters {fp32}, {frac_moved:.4f} of weight elements moved, "
            f"mean |change| {mean_moved:.3e}; checkpoint written {os.path.exists(ckpt)}")
        if not (trainer.state.step == TRAIN_STEPS and len(steps) == TRAIN_STEPS // 5 and finite
                and fp32 and frac_moved > 0.9 and os.path.exists(ckpt)):
            raise AssertionError("trainer: wrong step count, non-finite metrics, fp32 parameters "
                                 "that did not move, or no checkpoint")
        if launches != {"forward": 14 * TRAIN_STEPS, "backward": 14 * TRAIN_STEPS}:
            raise AssertionError(f"trainer: {launches} kernel launches, expected 14 + 14 per step")

        # 3. resume from the checkpoint: step, parameters and moments equal
        resumed = train_main(args + ["--checkpoint", ckpt])
        mu, nu = trainer.state.optimizer.moments()
        mu2, nu2 = resumed.state.optimizer.moments()
        same = (resumed.state.step == trainer.state.step
                and all(torch.equal(a, b) for a, b in zip(trainer.state.optimizer.params,
                                                          resumed.state.optimizer.params))
                and all(torch.equal(a, b) for a, b in zip(mu + nu, mu2 + nu2)))
        log(f"phase 6 resume: step {resumed.state.step}, epoch {resumed.curr_epoch}; parameters "
            f"and Adam moments equal: {same}")
        if not same:
            raise AssertionError("resume: step, parameters or Adam moments differ")
        del resumed

        # 4. profile 3 train steps
        x_dev = torch.from_numpy(np.load(os.path.join(tmp, "latents.npy"))[:B_TRAIN]).cuda()
        c_dev = torch.from_numpy(np.load(os.path.join(tmp, "labels.npy"))[:B_TRAIN]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    prof, kernels, wall = device_profile(
        torch, lambda: trainer.train_step(trainer.state, x_dev, c_dev, gen), iters=3)
    busy = sum(prof.values())
    bwd_ms = sum(v for k, v in prof.items() if "dq_kernel" in k or "dkdv_kernel" in k)
    fwd_ms = sum(v for k, v in prof.items() if "packed_attention_kernel" in k)
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:6]
    log(f"phase 6 profile: device busy {busy:.3f} ms of a {wall:.3f} ms train step "
        f"(idle share {idle_share(busy, wall)}); {kernels:.0f} kernels per step; "
        f"packed_attention_bwd {bwd_ms:.3f} ms, packed_attention {fwd_ms:.3f} ms; top: "
        + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))
    return dict(step_ms=step_ms, busy_ms=busy, wall_ms=wall, launches=launches,
                bwd_device_ms=bwd_ms, grad_rel_l2=whole, qkv_grad_rel_l2=qkv_err)


class _Lookup:
    """Within `with`, the VQ codebook's nearest-code lookup records the codes
    and fp32 tokens of its calls on the host (`taken`), and returns the
    next of `codes` instead of its own when they are given (each call takes
    as many as it has tokens)."""

    def __init__(self, codes=None):
        self.codes, self.taken, self.used = codes, [], 0

    def __enter__(self):
        import image_diffusion_torch.models.vae as vae_module

        self.module, self.nearest = vae_module, vae_module.nearest_code

        def lookup(flat, emb):
            if self.codes is None:
                idx = self.nearest(flat, emb)
            else:
                idx = self.codes[self.used:self.used + len(flat)].to(flat.device)
                self.used += len(flat)
            self.taken.append((idx.cpu(), flat.detach().cpu()))
            return idx

        vae_module.nearest_code = lookup
        return self

    def __exit__(self, *exc):
        self.module.nearest_code = self.nearest


def _stage1_grads(torch, cfg, dev, states, lpips, x_u8, draws, codes=None):
    """Gradients of one stage-1 step's two objectives at `dev` (bf16 compute
    on fp32 parameters): the VAE's (percept + recon + prior + g_loss through
    the discriminator; also its autoencoder and g_loss terms apart, under
    vae_ae. and vae_g.) and the discriminator's d_loss, the latter as its
    fake and its real term's, by parameter name; the flash launches the
    forward made; and for VQ the (codes, fp32 tokens) of its lookup on the
    host, which takes `codes` when they are given."""
    from image_diffusion_torch.models import build_discriminator, build_vae
    from image_diffusion_torch.ops import attention as attn
    from image_diffusion_torch.training.losses import D_LOSSES, G_LOSSES, recon_loss
    from image_diffusion_torch.training.vae_trainer import normalize_batch

    tc = cfg.train
    vae = build_vae(cfg.arch, tc.compute_dtype, dev, param_dtype=torch.float32)
    vae.load_state_dict(states[0])
    disc = build_discriminator(tc.disc_channels, tc.compute_dtype, dev)
    disc.load_state_dict(states[1])
    percept = lpips.astype(tc.compute_dtype).to(dev)
    x = normalize_batch(x_u8.to(dev), draws[0].to(dev))
    before = attn.flash_attention.launches
    with _Lookup(codes) as lookup:  # KL: the default sample=True, VQ: noise unused
        x_hat, prior, _ = vae(x, noise=draws[1].to(dev))
    launches = attn.flash_attention.launches - before
    x_hat = torch.clamp(x_hat.float(), -1.0, 1.0)
    out_fake, out_real = disc(x_hat.detach()).float(), disc(x).float()
    names, params = zip(*disc.named_parameters())
    grads = {}
    # d_loss is a sum of a fake and a real term: their gradients, apart
    for half, d_loss in (("fake", D_LOSSES[tc.gan_loss](out_fake, out_real.detach())),
                         ("real", D_LOSSES[tc.gan_loss](out_fake.detach(), out_real))):
        grads.update((f"disc_{half}.{n}", g) for n, g in
                     zip(names, torch.autograd.grad(d_loss, params, retain_graph=True)))
    # the VAE's objective as its autoencoder terms and its g_loss term apart
    ae_loss = (percept(x, x_hat) * tc.percept_weight + recon_loss(x, x_hat) * tc.recon_weight
               + prior * tc.prior_weight)
    g_loss = G_LOSSES[tc.gan_loss](disc(x_hat).float()) * tc.disc_weight
    names, params = zip(*vae.named_parameters())
    ae = torch.autograd.grad(ae_loss, params, retain_graph=True)
    for n, a, b in zip(names, ae, torch.autograd.grad(g_loss, params)):
        grads["vae." + n], grads["vae_ae." + n], grads["vae_g." + n] = a + b, a, b
    return ({n: g.float().cpu() for n, g in grads.items()}, launches,
            lookup.taken[0] if lookup.taken else None)


def _stage1_grad_errors(torch, card, cpu):
    """Card vs CPU gradients of `_stage1_grads`, relative L2: {vae, disc_fake,
    disc_real, qkv} (held to GRAD_REL_L2), per site's q/k/v (held to
    SITE_GRAD_REL_L2), and, printed, not held, d_loss's whole gradient and
    the VAE gradient's autoencoder and g_loss terms."""

    def rel(names):
        a = torch.cat([card[n].flatten() for n in names])
        b = torch.cat([cpu[n].flatten() for n in names])
        return float((a - b).norm() / b.norm())

    vae_names = [n for n in cpu if n.startswith("vae.")]
    fake_names = [n for n in cpu if n.startswith("disc_fake.")]
    real_names = [n for n in cpu if n.startswith("disc_real.")]
    d_loss_err = float(torch.cat([(card[f] + card[r] - cpu[f] - cpu[r]).flatten()
                                  for f, r in zip(fake_names, real_names)]).norm()
                       / torch.cat([(cpu[f] + cpu[r]).flatten()
                                    for f, r in zip(fake_names, real_names)]).norm())
    qkv = [n for n in vae_names
           if n.rsplit(".", 2)[-2] in ("to_q", "to_k", "to_v") and n.endswith("weight")]
    sites = sorted({n.rsplit(".", 2)[0] for n in qkv})
    per_site = {s: rel([n for n in qkv if n.startswith(s + ".")]) for s in sites}
    errs = dict(vae=rel(vae_names), disc_fake=rel(fake_names), disc_real=rel(real_names),
                qkv=rel(qkv))
    terms = {t: rel([n.replace("vae.", f"vae_{t}.", 1) for n in vae_names]) for t in ("ae", "g")}
    held = (len(sites) == 2 and max(errs.values()) <= GRAD_REL_L2
            and max(per_site.values()) <= SITE_GRAD_REL_L2)
    text = (f"VAE parameters {errs['vae']:.3e}, discriminator's fake and real terms "
            f"{errs['disc_fake']:.3e} and {errs['disc_real']:.3e} (tolerance {GRAD_REL_L2}; their "
            f"sum, not held, {d_loss_err:.3e}), to_q/to_k/to_v weights of {len(sites)} sites "
            f"{errs['qkv']:.3e} (tolerance {GRAD_REL_L2}), worst site "
            f"{max(per_site.values()):.3e} (tolerance {SITE_GRAD_REL_L2}); the VAE gradient's "
            f"autoencoder and g_loss terms, not held, {terms['ae']:.3e} and {terms['g']:.3e}")
    return errs, held, text


def _stage1_steps(torch, bottleneck):
    """STEPS_N steps of the end-to-end run's stage 1 (`stage1_config`: lr
    1e-4 after 100 warmup steps, clip 1, no discriminator or LPIPS) at
    full width and fp32 with TF32 off, batch STEPS_BATCH of the run's own
    images, on the card and on the CPU from one state and the same flips
    and noise; each step's losses, parameter updates and (VQ) codebook
    held, the share of tokens whose code differs printed.  When codes
    differ, the codebook is held against the CPU run again on the card's
    codes.  At fp32 the mid-block attention takes the plain path on both,
    so the same steps run on the card once more in bf16, where it takes
    the flash kernel, and are held against the CPU's fp32 run at the
    STEPS_BF16 bars."""
    import image_diffusion_torch.ops.attention as attn
    from image_diffusion_torch.core.config import VAEArch
    from image_diffusion_torch.models import build_vae
    from image_diffusion_torch.tools.e2e_synthetic_run import make_dataset, stage1_config
    from image_diffusion_torch.training.diffusion_trainer import Optimizer
    from image_diffusion_torch.training.vae_trainer import (VAEDraws, VAETrainState, draw,
                                                            make_vae_train_step)

    phase = "phase 7" if bottleneck == "kl" else "phase 9 (f)"
    cfg = stage1_config(VAEArch(), bottleneck, STEPS_BATCH, 1, "unused", precision="fp32")
    tc, B = cfg.train, STEPS_BATCH
    imgs = torch.from_numpy(make_dataset(B)[0])  # 3 B images: one batch a step
    g = torch.Generator().manual_seed(11)
    state0 = build_vae(cfg.arch, torch.float32, "cpu", g).state_dict()
    draws = [draw(g, B, (32, 32, cfg.arch.z_dim)) for _ in range(STEPS_N)]
    p0 = torch.cat([v.flatten() for k, v in state0.items() if not k.startswith("codebook.")])
    step = make_vae_train_step(cfg)

    def run(dev, codes=None, dtype=torch.float32):
        vae = build_vae(cfg.arch, dtype, dev, param_dtype=torch.float32)  # fp32: TF32 off
        vae.load_state_dict(state0)
        st = VAETrainState(vae.train(), None, Optimizer(vae.parameters(), tc.learning_rate,
                                                        tc.warmup_steps, tc.clip_grad), None)
        rows, t0 = [], time.perf_counter()
        with _Lookup(codes) as lookup:
            for i in range(STEPS_N):
                m = step(st, imgs[i * B:(i + 1) * B].to(dev),
                         VAEDraws(*(t.to(dev) for t in draws[i])), False)
                sd = vae.state_dict()
                rows.append(dict(
                    losses=[float(m["vae/recon_loss"]), float(m["vae/prior_loss"])],
                    update=torch.cat([sd[k].float().cpu().flatten() for k in state0
                                      if not k.startswith("codebook.")]) - p0,
                    codebook=[sd[k].double().cpu() for k in state0 if k.startswith("codebook.")]))
        secs = time.perf_counter() - t0
        return rows, [c for c, _ in lookup.taken], secs

    card, card_codes, card_s = run("cuda")
    cpu, cpu_codes, cpu_s = run("cpu")
    flips = [float((a != b).float().mean()) for a, b in zip(card_codes, cpu_codes)]
    cpu_own = cpu
    if any(flips):
        cpu, _, _ = run("cpu", torch.cat(card_codes))
    before = attn.flash_attention.launches
    bf16, bf16_codes, bf16_s = run("cuda", dtype=torch.bfloat16)
    bf16_launches = attn.flash_attention.launches - before
    sites = torch.cat([torch.full((v.numel(),), k.rsplit(".", 2)[-2] in ("to_q", "to_k", "to_v",
                                                                         "out_proj"))
                       for k, v in state0.items() if not k.startswith("codebook.")])

    def errors(got, ref, which=slice(None)):
        loss_rel = [max(abs(a - b) / max(abs(b), 1e-12)
                        for a, b in zip(c["losses"][which], r["losses"][which]))
                    for c, r in zip(got, ref)]
        update_rel = [float((c["update"] - r["update"]).norm() / r["update"].norm())
                      for c, r in zip(got, ref)]
        site_rel = [float((c["update"] - r["update"])[sites].norm() / r["update"][sites].norm())
                    for c, r in zip(got, ref)]
        cb_rel = [max((float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(c["codebook"], r["codebook"])), default=0.0)
                  for c, r in zip(got, ref)]
        return loss_rel, update_rel, site_rel, cb_rel

    loss_rel, update_rel, _, cb_rel = errors(card, cpu)
    b_loss, b_update, b_site, b_cb = errors(bf16, cpu_own, slice(0, 1))
    b_prior = errors(bf16, cpu_own, slice(1, 2))[0]
    b_flips = [float((a != b).float().mean()) for a, b in zip(bf16_codes, cpu_codes)]
    log(f"{phase} steps: {STEPS_N} steps of the end-to-end run's {bottleneck.upper()} stage 1, "
        f"full width, batch {B}, fp32 with TF32 off, card vs CPU from one state: losses "
        f"{', '.join(f'{v:.3e}' for v in loss_rel)} (tolerance {STEPS_LOSS_REL}); parameter "
        f"updates rel L2 {', '.join(f'{v:.3e}' for v in update_rel)} (tolerance "
        f"{STEPS_UPDATE_REL_L2})"
        + (f"; codebook max|diff|/max {', '.join(f'{v:.3e}' for v in cb_rel)} (tolerance "
           f"{EMA_REL}{', on the card codes' if any(flips) else ''}); share of tokens whose code "
           f"differs {', '.join(f'{v:.4f}' for v in flips)} of {card_codes[0].numel()}"
           if bottleneck == "vq" else "")
        + f"; card {card_s:.1f} s, CPU {cpu_s:.1f} s")
    log(f"{phase} steps in bf16: the same steps on the card in bf16 ({bf16_launches} flash "
        f"launches) vs the CPU's fp32: recon loss {', '.join(f'{v:.3e}' for v in b_loss)} "
        f"(tolerance {STEPS_BF16_LOSS_REL}), prior loss, not held, "
        f"{', '.join(f'{v:.3e}' for v in b_prior)}; parameter updates rel L2 "
        f"{', '.join(f'{v:.3e}' for v in b_update)}, of the attention sites "
        f"{', '.join(f'{v:.3e}' for v in b_site)} (tolerance {STEPS_BF16_UPDATE_REL_L2})"
        + (f"; codebook max|diff|/max {', '.join(f'{v:.3e}' for v in b_cb)} (tolerance "
           f"{STEPS_BF16_CODEBOOK_REL}); share of tokens whose code differs "
           f"{', '.join(f'{v:.4f}' for v in b_flips)}" if bottleneck == "vq" else "")
        + f"; card {bf16_s:.1f} s")
    if not (max(loss_rel) <= STEPS_LOSS_REL and max(update_rel) <= STEPS_UPDATE_REL_L2
            and max(cb_rel) <= EMA_REL):
        raise AssertionError(f"{phase}: the full-width stage-1 steps on the card part from the "
                             f"CPU's")
    if not (bf16_launches == 2 * STEPS_N and max(b_loss) <= STEPS_BF16_LOSS_REL
            and max(b_update + b_site) <= STEPS_BF16_UPDATE_REL_L2
            and max(b_cb) <= STEPS_BF16_CODEBOOK_REL):
        raise AssertionError(f"{phase}: the full-width stage-1 steps in bf16 on the card part "
                             f"from the CPU's fp32 steps")
    return dict(loss_rel=loss_rel, update_rel=update_rel, codebook_rel=cb_rel, code_flips=flips,
                bf16_recon_rel=b_loss, bf16_prior_rel=b_prior, bf16_update_rel=b_update,
                bf16_site_update_rel=b_site, bf16_codebook_rel=b_cb, bf16_code_flips=b_flips,
                bf16_launches=bf16_launches)


def phase_vae_train(torch, np, attn, tmp):
    """Phase 7: stage-1 VAE-GAN training on the card, its files in `tmp`
    (phases 8 and 9 read its images, LPIPS file and checkpoint)."""
    from image_diffusion_torch.core.config import VAEConfig
    from image_diffusion_torch.models import build_discriminator, build_vae
    from image_diffusion_torch.models.lpips import LPIPS
    from image_diffusion_torch.training.vae_trainer import draw

    cfg = VAEConfig.from_yaml(VAE_CONFIG)
    lpips_path = os.path.join(tmp, "lpips.pth")
    _random_lpips_file(torch, lpips_path)
    lpips = LPIPS.from_torch_file(lpips_path)

    # 1. full-width gradients at batch 2, card (flash kernel) vs CPU (plain version)
    g = torch.Generator().manual_seed(7)
    states = (build_vae(cfg.arch, torch.float32, "cpu", g).state_dict(),
              build_discriminator(cfg.train.disc_channels, torch.float32, "cpu", g).state_dict())
    x_u8 = torch.randint(0, 256, (2, 128, 128, 3), generator=g, dtype=torch.uint8)
    draws = draw(g, 2, (32, 32, cfg.arch.z_dim))
    grads, secs, launches = [], [], []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got, n, _ = _stage1_grads(torch, cfg, dev, states, lpips, x_u8, draws)
        grads.append(got)
        launches.append(n)
        secs.append(time.perf_counter() - t0)
    errs, held, text = _stage1_grad_errors(torch, *grads)
    log(f"phase 7 gradients: full-width VAE + discriminator + LPIPS, batch 2, card vs CPU rel "
        f"L2: {text}; flash launches on the card {launches[0]}; card {secs[0]:.1f} s, "
        f"CPU {secs[1]:.1f} s")
    if launches[0] != 2 or not held:
        raise AssertionError("full-width stage-1 gradients on the card disagree with the CPU")
    del grads
    steps = _stage1_steps(torch, "kl")

    # 2. the trainer through its entry point, 25 steps of the shipped config
    rng = np.random.default_rng(0)
    n_train, n_dev = VAE_TRAIN_STEPS * B_TRAIN, 2 * B_TRAIN + 4  # the dev tail: 4 of 48
    np.save(os.path.join(tmp, "train.npy"), rng.integers(0, 256, (n_train, 128, 128, 3), dtype=np.uint8))
    np.save(os.path.join(tmp, "dev.npy"), rng.integers(0, 256, (n_dev, 128, 128, 3), dtype=np.uint8))
    run = _stage1_cli_run(torch, np, attn, tmp, "phase 7", VAE_CONFIG, "smoke", lpips_path)
    del run["trainer"], run["x"]
    return dict(run, grad_rel_l2=errs, steps=steps, images=os.path.join(tmp, "train.npy"))


def _stage1_config(tmp, config_path, run):
    """The stage-1 config `config_path` with phase 7's files in `tmp` (no
    plot_set file), `epochs: 1`, `log_interval: 5` and `disc_start: 10`
    overridden, written to `tmp`."""
    with open(config_path) as f:
        text = _override(f.read(), {
            "train_set": os.path.join(tmp, "train.npy"), "dev_set": os.path.join(tmp, "dev.npy"),
            "plot_set": os.path.join(tmp, "plot.npy"),
            "checkpoints_dir": os.path.join(tmp, "ckpt"), "logs_dir": os.path.join(tmp, "logs"),
            "epochs": 1, "log_interval": 5, "disc_start": VAE_DISC_START})
    path = os.path.join(tmp, f"{run}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _stage1_cli_run(torch, np, attn, tmp, phase, config_path, run, lpips_path):
    """25 steps of the stage-1 config `config_path` through
    `image_diffusion_torch.scripts.train_vae.main` on phase 7's images in
    `tmp` (paths, epochs: 1, log_interval: 5 and disc_start: 10
    overridden; no plot_set file), with its flushes, flash launches and
    checks; a resume from its checkpoint; a profile of 3 train steps with
    the discriminator active."""
    import csv

    from image_diffusion_torch.core.config import VAEConfig
    from image_diffusion_torch.scripts.train_vae import main as train_main

    cfg = VAEConfig.from_yaml(config_path)
    is_vq = cfg.arch.bottleneck == "vq"
    n_dev = len(np.load(os.path.join(tmp, "dev.npy"), mmap_mode="r"))
    config = _stage1_config(tmp, config_path, run)
    args = ["--config", config, "--experiment-name", run, "--no-mlflow",
            "--lpips-weights", lpips_path]
    attn.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = train_main(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches = attn.flash_attention.launches
    dev_batches = -(-n_dev // B_TRAIN)
    with open(os.path.join(tmp, "logs", f"{run}_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    flushes, dev = {}, {}
    for r in rows:
        if r["name"].startswith("dev/"):
            dev[r["name"]] = float(r["value"])
        else:
            flushes.setdefault(int(r["step"]), {})[r["name"]] = float(r["value"])
    steps = sorted(flushes)
    later = [flushes[s]["util/imgs_per_sec"] for s in steps[1:]]
    step_ms = sum(5 * B_TRAIN / ips for ips in later) / (5 * len(later)) * 1e3
    for s in steps:
        f = flushes[s]
        loss = (f["vae/percept_loss"] * cfg.train.percept_weight
                + f["vae/recon_loss"] * cfg.train.recon_weight
                + f["vae/prior_loss"] * cfg.train.prior_weight)
        gan = (f"d_loss {f['gan/d_loss']:.5f}, g_loss {f['gan/g_loss']:.5f}, fake_acc "
               f"{f['gan/fake_acc']:.3f}, real_acc {f['gan/real_acc']:.3f}"
               if "gan/d_loss" in f else "discriminator inactive")
        perplexity = f", perplexity {f['vae/perplexity']:.3f}" if "vae/perplexity" in f else ""
        log(f"{phase} train flush at step {s + 1}: loss {loss:.5f} (recon {f['vae/recon_loss']:.5f}, "
            f"percept {f['vae/percept_loss']:.5f}, prior {f['vae/prior_loss']:.3f}{perplexity}), "
            f"vae grad {f['vae/vae_grad']:.4f}; {gan}; {f['util/imgs_per_sec']:.1f} imgs/s")
    st = trainer.state
    ckpt = os.path.join(tmp, "ckpt", run, "vae-epoch-00.ckpt")
    finite = all(np.isfinite(list(f.values())).all() for f in flushes.values())
    gan_flushes = [s for s in steps if "gan/d_loss" in flushes[s]]
    fp32 = all(p.dtype == torch.float32 for p in st.vae_opt.params + st.disc_opt.params)
    dev_names = {"dev/recon_loss", "dev/percept_loss"} | ({"dev/perplexity"} if is_vq else set())
    log(f"{phase} trainer: {st.step} steps ({st.disc_opt.count} with the discriminator) in "
        f"{run_s:.1f} s through image_diffusion_torch.scripts.train_vae (set-up, dev "
        f"evaluation and checkpoint included); {step_ms:.2f} ms/step after the first 5 "
        f"({B_TRAIN / step_ms * 1e3:.1f} imgs/s); flash launches {run_launches} = "
        f"{VAE_TRAIN_STEPS} steps x 2 + {dev_batches} dev batches x 2; "
        + ", ".join(f"{k} {dev.get(k, float('nan')):.5f}" for k in sorted(dev_names))
        + f"; fp32 parameters {fp32}; checkpoint written {os.path.exists(ckpt)}")
    if not (st.step == VAE_TRAIN_STEPS and st.disc_opt.count == VAE_TRAIN_STEPS - VAE_DISC_START
            and len(steps) == VAE_TRAIN_STEPS // 5 and finite and fp32
            and gan_flushes == [s for s in steps if s >= VAE_DISC_START]
            and all(("vae/perplexity" in f) == is_vq for f in flushes.values())
            and set(dev) == dev_names
            and np.isfinite(list(dev.values())).all() and os.path.exists(ckpt)):
        raise AssertionError(f"{phase} stage-1 trainer: wrong step counts or metrics, non-finite "
                             f"metrics, the discriminator active at the wrong steps, or no "
                             f"checkpoint")
    if run_launches != 2 * (VAE_TRAIN_STEPS + dev_batches):
        raise AssertionError(f"{phase} stage-1 trainer: {run_launches} flash launches, expected 2 "
                             f"per step and per dev batch")

    # 3. resume from the checkpoint: step, parameters, BN statistics, moments
    # and the VQ codebook equal
    resumed = train_main(args + ["--checkpoint", ckpt]).state

    def tensors(s):
        return (s.vae_opt.params + s.disc_opt.params + sum(s.vae_opt.moments(), [])
                + sum(s.disc_opt.moments(), []) + list(s.disc.buffers()) + list(s.vae.buffers()))

    same = ((resumed.step, resumed.disc_opt.count) == (st.step, st.disc_opt.count)
            and all(torch.equal(a, b) for a, b in zip(tensors(st), tensors(resumed))))
    log(f"{phase} resume: step {resumed.step}, discriminator updates {resumed.disc_opt.count}; "
        f"parameters, BatchNorm statistics, both Adams' moments"
        + (" and the codebook" if is_vq else "") + f" equal: {same}")
    if not same:
        raise AssertionError(f"{phase} stage-1 resume: step, parameters, statistics, moments or "
                             f"codebook differ")
    del resumed

    # 4. profile 3 train steps with the discriminator active
    x_dev = torch.from_numpy(np.load(os.path.join(tmp, "train.npy"))[:B_TRAIN]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    prof, kernels, wall = device_profile(
        torch, lambda: trainer.train_step(st, x_dev, gen, disc_active=True), iters=3)
    busy = sum(prof.values())
    flash_ms = sum(v for k, v in prof.items() if "flash_attention_kernel" in k)
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:6]
    log(f"{phase} profile: device busy {busy:.3f} ms of a {wall:.3f} ms train step "
        f"(idle share {idle_share(busy, wall)}); {kernels:.0f} kernels per step; flash_attention "
        f"{flash_ms:.3f} ms; top: " + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))
    return dict(step_ms=step_ms, busy_ms=busy, wall_ms=wall, launches=run_launches,
                flash_device_ms=flash_ms, ckpt=ckpt, trainer=trainer, x=x_dev)


def phase_vq_train(torch, np, attn, tmp):
    """Phase 9: stage-1 VQ VAE-GAN training (EMA codebook) on the card, on
    phase 7's images, dev set and LPIPS file in `tmp`."""
    import copy
    from dataclasses import replace

    from image_diffusion_torch.core.config import VAEConfig
    from image_diffusion_torch.models import build_discriminator, build_vae
    from image_diffusion_torch.models.lpips import LPIPS
    from image_diffusion_torch.training.vae_trainer import draw, make_vae_train_step, normalize_batch

    cfg = VAEConfig.from_yaml(VQ_CONFIG)
    gamma, K = cfg.arch.codebook_gamma, cfg.arch.codebook_size
    lpips_path = os.path.join(tmp, "lpips.pth")
    lpips = LPIPS.from_torch_file(lpips_path)

    # (a) full-width gradients at batch 2, card (flash kernel) vs CPU (plain
    # version): at the fresh codebook, printed, and held at a codebook spread
    # over the batch's own fp32 encoder tokens.  A fresh codebook is
    # U(+-1/1024): the tokens fall on a handful of codes, both images decode
    # to nearly the same picture, and the bf16 rounding of the terms through
    # the discriminator and LPIPS reaches the bar; the CPU decoding the
    # card's codes leaves the errors as they are, so code flips are not why
    g = torch.Generator().manual_seed(9)
    states = (build_vae(cfg.arch, torch.float32, "cpu", g).state_dict(),
              build_discriminator(cfg.train.disc_channels, torch.float32, "cpu", g).state_dict())
    x_u8 = torch.randint(0, 256, (2, 128, 128, 3), generator=g, dtype=torch.uint8)
    draws = draw(g, 2, (32, 32, cfg.arch.z_dim))

    def compare(label, states, hold):
        t0 = time.perf_counter()
        card, launches, (codes_card, _) = _stage1_grads(torch, cfg, "cuda", states, lpips, x_u8,
                                                        draws)
        t1 = time.perf_counter()
        cpu, _, (codes_cpu, tokens) = _stage1_grads(torch, cfg, "cpu", states, lpips, x_u8, draws)
        secs = (t1 - t0, time.perf_counter() - t1)
        flipped = codes_card != codes_cpu
        emb = states[0]["codebook.embeddings.weight"].double()
        gaps = (tokens[flipped].double()[:, None, :] - emb[None]).square().sum(-1)
        gaps = gaps.topk(2, dim=1, largest=False).values.diff(dim=1).flatten()
        errs, held, text = _stage1_grad_errors(torch, card, cpu)
        log(f"phase 9 gradients, {label}: full-width VQ VAE + discriminator + LPIPS, batch 2, card "
            f"vs CPU rel L2: {text}; " + ("held" if hold else "not held") + f"; codes differing "
            f"between card and CPU {int(flipped.sum())} of {flipped.numel()} tokens "
            f"({float(flipped.float().mean()):.4f})"
            + (f", their float64 gap between the two nearest codes {float(gaps.min()):.3e} to "
               f"{float(gaps.max()):.3e}" if flipped.any() else "")
            + f"; {len(codes_card.unique())} codes used; flash launches on the card {launches}; "
            f"card {secs[0]:.1f} s, CPU {secs[1]:.1f} s")
        if hold and not held and flipped.any():  # the CPU again, decoding the card's codes
            cpu, _, _ = _stage1_grads(torch, cfg, "cpu", states, lpips, x_u8, draws,
                                      codes=codes_card)
            errs, held, text = _stage1_grad_errors(torch, card, cpu)
            log(f"phase 9 gradients, {label}, the CPU on the card's codes: {text}")
        if launches != 2 or (hold and not held):
            raise AssertionError(f"full-width VQ stage-1 gradients on the card disagree with the "
                                 f"CPU ({label})")
        return errs

    compare("fresh codebook", states, hold=False)
    vae_cpu = build_vae(cfg.arch, torch.float32, "cpu")
    vae_cpu.load_state_dict(states[0])
    with torch.no_grad(), _Lookup() as lookup:
        vae_cpu(normalize_batch(x_u8, draws.flip))
    tokens = lookup.taken[0][1]
    pick = torch.randperm(len(tokens), generator=torch.Generator().manual_seed(0))[:K]
    spread = {**states[0], "codebook.embeddings.weight": tokens[pick].clone()}
    errs = compare("codebook spread over the tokens", (spread, states[1]), hold=True)
    del vae_cpu

    # (f) 3 steps of the end-to-end run's VQ stage 1, card vs CPU
    card_steps = _stage1_steps(torch, "vq")

    # (d) 25 steps of the VQ config through the CLI, resume, profile
    run = _stage1_cli_run(torch, np, attn, tmp, "phase 9", VQ_CONFIG, "vq", lpips_path)
    trainer, x = run.pop("trainer"), run.pop("x")
    vae = trainer.state.vae

    # (b) the lookup on the card's fp32 encoder output for batch 48, against float64
    with torch.no_grad(), _Lookup() as lookup:
        vae(normalize_batch(x))
    z = lookup.taken[0][1].cuda().reshape(B_TRAIN, 32, 32, cfg.arch.z_dim)
    cb = copy.deepcopy(vae.codebook)
    state0 = [b.double().cpu() for b in (cb.ema_cluster_size, cb.ema_w, cb.embeddings.weight)]
    with torch.no_grad(), _Lookup() as lookup:
        cb(z, train=True)  # (c)'s update, on the same codes
    codes, flat = lookup.taken[0]
    tokens, e = flat.double(), state0[2]
    dist = (tokens.square().sum(1, keepdim=True) - 2.0 * tokens @ e.T + e.square().sum(1)[None])
    top = dist.topk(2, dim=1, largest=False)
    best, gap = top.indices[:, 0], top.values[:, 1] - top.values[:, 0]
    znorm, enorm = tokens.norm(dim=1), e.norm(dim=1)
    # fp32 rounding of the two distances, each within a few ulps of (|z| + |e|)^2
    rounding = 2.0 ** -21 * ((znorm + enorm[top.indices[:, 0]]) ** 2
                             + (znorm + enorm[top.indices[:, 1]]) ** 2)
    differ = codes != best
    log(f"phase 9 lookup: batch {B_TRAIN}, {codes.numel()} tokens of the trained VAE, codebook "
        f"{K}x{cfg.arch.z_dim} fp32 on the card against float64 distances on the host: "
        f"{int(differ.sum())} codes differ, all with a float64 gap below fp32 rounding: "
        f"{bool((gap[differ] < rounding[differ]).all())} ({int((gap < rounding).sum())} tokens "
        f"have such a gap); {len(best.unique())} codes used")
    if (differ & (gap >= rounding)).any():
        raise AssertionError("the card's nearest codes differ from float64's beyond fp32 rounding")

    # (c) one EMA update on the card at batch 48 against its float64 statement
    counts = torch.bincount(codes, minlength=K).double()
    dw = torch.zeros(K, cfg.arch.z_dim, dtype=torch.float64).index_add_(0, codes, tokens)
    cs = state0[0] * gamma + (1.0 - gamma) * counts
    n = cs.sum()
    smoothed = (cs + 1e-5) / (n + K * 1e-5) * n
    w = state0[1] * gamma + (1.0 - gamma) * dw
    ema_err = {name: float((got.double().cpu() - ref).abs().max() / ref.abs().max())
               for name, got, ref in (("cluster sizes", cb.ema_cluster_size, smoothed),
                                      ("ema_w", cb.ema_w, w),
                                      ("embeddings", cb.embeddings.weight, w / smoothed[:, None]))}
    lookup_ms = device_ms(torch, lambda: cb(z))
    codebook_ms = device_ms(torch, lambda: cb(z, train=True))
    log(f"phase 9 EMA update: batch {B_TRAIN} on the card vs float64 on the host, max|card - "
        f"fp64| / max|fp64|: " + ", ".join(f"{k} {v:.3e}" for k, v in ema_err.items())
        + f" (tolerance {EMA_REL}); the codebook's device time at batch {B_TRAIN}: lookup "
        f"{lookup_ms:.3f} ms, lookup + update {codebook_ms:.3f} ms, {codebook_ms / run['busy_ms']:.4f} "
        f"of the profiled step's {run['busy_ms']:.3f} ms busy")
    if not max(ema_err.values()) <= EMA_REL:
        raise AssertionError("the EMA update on the card disagrees with its float64 statement")
    del cb, z

    # (e) grad accumulation at full width: one state, one batch, accum 1 and 2.
    # The bf16 encoder rounds differently at micro-batch 24 than at 48, which
    # moves near-tie tokens to another code; the codebook is held on accum
    # 1's codes (a second accum 2 step that takes them), the flips printed
    percept = lpips.astype(cfg.train.compute_dtype).to("cuda")
    steps = {a: make_vae_train_step(replace(cfg, train=replace(cfg.train, grad_accum=a)), percept)
             for a in (1, 2)}
    draws = draw(torch.Generator(device="cuda").manual_seed(5), B_TRAIN, (32, 32, cfg.arch.z_dim))

    def accum_step(a, codes=None):
        st = copy.deepcopy(trainer.state)
        torch.cuda.synchronize()
        base_mb = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        attn.flash_attention.launches = 0
        with _Lookup(codes) as lookup:
            metrics = steps[a](st, x, draws, False)
        torch.cuda.synchronize()
        return st, dict(grad=torch.cat([p.grad.flatten() for p in st.vae_opt.params]).float().cpu(),
                        buffers=[b.double().cpu() for b in st.vae.codebook.buffers()],
                        codes=torch.cat([c for c, _ in lookup.taken]),
                        vae_grad=float(metrics["vae/vae_grad"]), base_mb=base_mb,
                        peak_mb=torch.cuda.max_memory_allocated() / 2**20,
                        launches_inactive=attn.flash_attention.launches)

    def rel_max(r2, r1):
        return max(float((b2 - b1).abs().max() / b1.abs().max())
                   for b1, b2 in zip(r1["buffers"], r2["buffers"]))

    acc = {}
    for a in (1, 2):
        st, acc[a] = accum_step(a)
        acc[a]["ms"] = cuda_ms(lambda: steps[a](st, x, draws, False), iters=5, warmup=1)
        attn.flash_attention.launches = 0
        steps[a](st, x, draws, True)
        torch.cuda.synchronize()
        acc[a]["launches_active"] = attn.flash_attention.launches
        del st
    grad_err = float((acc[2]["grad"] - acc[1]["grad"]).norm() / acc[1]["grad"].norm())
    flips = int((acc[1]["codes"] != acc[2]["codes"]).sum())
    cb_err_flips = rel_max(acc[2], acc[1])
    same = accum_step(2, codes=acc[1]["codes"])[1]
    cb_err = rel_max(same, acc[1])
    log(f"phase 9 grad_accum: batch {B_TRAIN}, discriminator inactive, accum 2 vs 1: the clipped "
        f"averaged VAE gradient rel L2 {grad_err:.3e} (tolerance {GRAD_REL_L2}), grad norms "
        f"{acc[2]['vae_grad']:.4f} / {acc[1]['vae_grad']:.4f}; codebook after the step max|diff| / "
        f"max {cb_err:.3e} on accum 1's codes (tolerance {EMA_REL}), {cb_err_flips:.3e} on its "
        f"own, where {flips} of {acc[1]['codes'].numel()} tokens took another code; " + "; ".join(
            f"accum {a}: {acc[a]['ms']:.2f} ms/step, peak memory {acc[a]['peak_mb']:.0f} MiB "
            f"({acc[a]['peak_mb'] - acc[a]['base_mb']:.0f} MiB above the {acc[a]['base_mb']:.0f} "
            f"MiB held), flash launches a step {acc[a]['launches_inactive']} with the "
            f"discriminator inactive, {acc[a]['launches_active']} active" for a in (1, 2)))
    if not (grad_err <= GRAD_REL_L2 and cb_err <= EMA_REL
            and [acc[a]["launches_inactive"] for a in (1, 2)] == [2, 4]
            and [acc[a]["launches_active"] for a in (1, 2)] == [2, 8]):
        raise AssertionError("grad_accum 2 disagrees with grad_accum 1 on the card, or launched "
                             "the flash kernel other than 2 a micro-batch and phase")
    accum = {f"accum_{a}": {k: v for k, v in acc[a].items() if k not in ("grad", "buffers", "codes")}
             for a in (1, 2)}
    return dict(run, grad_rel_l2=errs, lookup_ms=lookup_ms, codebook_ms=codebook_ms,
                ema_rel_err=ema_err, accum=accum, accum_grad_rel_l2=grad_err,
                accum_codebook_rel_err=cb_err, accum_code_flips=flips,
                accum_codebook_rel_err_own_codes=cb_err_flips, steps=card_steps)


def phase_clis(torch, np, attn, vae_ckpt: str, images_path: str, tmp: str):
    """Phase 8: the two stages joined through the CLIs' `main`s, at full
    width: prepare_dataset on phase 7's images and checkpoint,
    train_diffusion on those latents with an EMA, make_bundle --ema, and
    sample_grid's defaults (ddpm-1000, 27 images), then dpm-20.  Each
    CLI's kernel launches are counted from 0 around it."""
    import csv

    from image_diffusion_torch.compat.from_jax import unet_state_dict
    from image_diffusion_torch.core import checkpoint as ckpt
    from image_diffusion_torch.models.io import load_vae, read_vae
    from image_diffusion_torch.pipelines import DiffusionPipeline
    from image_diffusion_torch.scripts import (make_bundle, prepare_dataset, sample_grid,
                                               train_diffusion)

    # 1. prepare_dataset diffusion --labels-mode random, batches of 64
    lat_dir = os.path.join(tmp, "latents")
    images = np.load(images_path, mmap_mode="r")
    n = images.shape[0]
    batches = -(-n // B_ENCODE)
    attn.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepare_dataset.main(["diffusion", "--diffusion-images", images_path, "--vae-checkpoint",
                          vae_ckpt, "--out", lat_dir, "--labels-mode", "random"])
    prep_s = time.perf_counter() - t0
    prep_flash = attn.flash_attention.launches
    latents = np.load(os.path.join(lat_dir, "diffusion_dataset.npy"))
    labels = np.load(os.path.join(lat_dir, "diffusion_labels.npy"))
    # the encode alone, on the same kernels: the same bytes
    vae, _ = load_vae(vae_ckpt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = prepare_dataset.extract_latents(vae, images, B_ENCODE, "cuda")
    encode_s = time.perf_counter() - t0
    del vae
    rows = [0, 1, n - 1]
    vae_cpu, _ = load_vae(vae_ckpt, torch.float32, "cpu")
    with torch.inference_mode():
        ref = prepare_dataset.encode(vae_cpu, torch.from_numpy(images[rows]))
    enc_err = rel_l2(torch.from_numpy(latents[rows]), ref)
    del vae_cpu
    log(f"phase 8 prepare_dataset: {latents.shape} {latents.dtype} from {n} images of phase 7 "
        f"in {prep_s:.2f} s through the CLI ({n / prep_s:.1f} images/s, VAE load and files "
        f"included), the encode alone {encode_s:.3f} s ({n / encode_s:.1f} images/s), the same "
        f"bytes {np.array_equal(again, latents)}; flash launches {prep_flash} over {batches} "
        f"batches of up to {B_ENCODE}; rows {rows} vs the CPU at fp32 rel L2 {enc_err:.3e} "
        f"(tolerance {ENCODE_REL_L2}); labels per class {np.bincount(labels, minlength=3).tolist()}")
    if not (latents.shape == (n, 32, 32, 6) and latents.dtype == np.float16
            and np.isfinite(latents).all() and labels.shape == (n,) and labels.dtype == np.uint8
            and np.array_equal(again, latents)):
        raise AssertionError("prepare_dataset: wrong latents or labels")
    if prep_flash != batches:
        raise AssertionError(f"prepare_dataset: {prep_flash} flash launches, expected one per "
                             f"batch ({batches})")
    if not enc_err <= ENCODE_REL_L2:
        raise AssertionError("prepare_dataset's latents on the card disagree with the CPU")

    # 2. train_diffusion on exactly those latents and labels, with an EMA
    config = _diffusion_config(tmp, "diffusion", os.path.join(lat_dir, "diffusion_dataset.npy"),
                               os.path.join(lat_dir, "diffusion_labels.npy"))
    with open(config, "a") as f:
        f.write("ema_decay: 0.999\n")
    steps = n // B_TRAIN
    attn.packed_attention.launches = attn.packed_attention_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = train_diffusion.main(["--config", config, "--experiment-name", "chain",
                                    "--no-mlflow"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = (attn.packed_attention.launches, attn.packed_attention_bwd.launches)
    unet_ckpt = os.path.join(tmp, "ckpt", "chain", "unet-epoch-00.ckpt")
    with open(os.path.join(tmp, "logs", "chain_metrics.csv")) as f:
        losses = [float(r["value"]) for r in csv.DictReader(f) if r["name"] == "unet/loss"]
    log(f"phase 8 train_diffusion on those latents: {trainer.state.step} steps in {train_s:.1f} s "
        f"(set-up and checkpoint included); kernel launches {train_launches[0]} forward, "
        f"{train_launches[1]} backward; loss at the flushes "
        + " ".join(f"{v:.5f}" for v in losses) + f"; EMA kept {trainer.state.ema is not None}")
    if not (trainer.state.step == steps and losses and np.isfinite(losses).all()
            and trainer.state.ema is not None and os.path.exists(unet_ckpt)):
        raise AssertionError("train_diffusion on prepare_dataset's latents: wrong step count, "
                             "non-finite loss, no EMA or no checkpoint")
    if train_launches != (14 * steps, 14 * steps):
        raise AssertionError(f"train_diffusion: {train_launches} kernel launches, expected 14 + 14 "
                             f"per step")
    del trainer

    # 3. make_bundle --ema; the bundle read back holds the checkpoints' fp32 trees
    bundle = os.path.join(tmp, "bundle.ckpt")
    make_bundle.main(["--vae", vae_ckpt, "--unet", unet_ckpt, "--config", config, "--out", bundle,
                      "--ema"])
    pipe = DiffusionPipeline.from_checkpoint(bundle)
    trees, _ = ckpt.load_checkpoint(unet_ckpt)
    ema, raw = unet_state_dict(trees["unet_ema"]), unet_state_dict(trees["unet"])
    vae_state = read_vae(vae_ckpt)[1]
    same = (set(pipe.unet_state) == set(ema) and set(pipe.vae_state) == set(vae_state)
            and all(torch.equal(pipe.unet_state[k], v) for k, v in ema.items())
            and all(torch.equal(pipe.vae_state[k], v) for k, v in vae_state.items()))
    ema_differs = any(not torch.equal(ema[k], raw[k]) for k in ema)
    log(f"phase 8 make_bundle --ema: read back on {pipe.device} in {pipe.dtype}; weights equal "
        f"the checkpoints' fp32 trees (the UNet's EMA) bit for bit: {same}; EMA differs from the "
        f"raw weights: {ema_differs}")
    if not (same and ema_differs):
        raise AssertionError("make_bundle: the bundle does not hold the checkpoints' EMA and VAE "
                             "weights")
    del pipe, trees, ema, raw, vae_state

    # 4. sample_grid's defaults (ddpm-1000, --cfg 1 10), then --sampler dpm
    png = os.path.join(tmp, "grid.png")
    out = {}
    for name, extra in (("ddpm", []), ("dpm", ["--sampler", "dpm"])):
        args = sample_grid.parse_args([bundle, "--out", png, *extra])
        attn.packed_attention.launches = attn.flash_attention.launches = 0
        grid_pipe, scales, imgs, secs = sample_grid.sample(args)
        launches = (attn.packed_attention.launches, attn.flash_attention.launches)
        t0 = time.perf_counter()
        ref = grid_pipe.sample(scales, seed=args.seed, sampler=args.sampler).cpu()
        ref_s = time.perf_counter() - t0
        diff = float((imgs - ref).abs().max())
        n_steps = 1000 if name == "ddpm" else 20
        out[name] = dict(seconds=secs, pipe_seconds=ref_s, launches=launches, max_diff=diff)
        log(f"phase 8 sample_grid {name}-{n_steps}: {tuple(imgs.shape)} {imgs.dtype} in {secs:.2f} s "
            f"({imgs.shape[0] / secs:.3f} img/s, the CLI's log line); {launches[0]} packed and "
            f"{launches[1]} flash kernel launches; against pipe.sample with the same seed and "
            f"arguments, right after it ({ref_s:.2f} s), max|diff| {diff:.3e}; range "
            f"[{float(imgs.min()):.3f}, {float(imgs.max()):.3f}]")
        if not (imgs.shape == (27, 128, 128, 3) and torch.isfinite(imgs).all() and diff == 0.0):
            raise AssertionError(f"sample_grid {name}: wrong shape, non-finite images, or images "
                                 f"that differ from pipe.sample's")
        if launches != (14 * n_steps, 1):
            raise AssertionError(f"sample_grid {name}: {launches} packed and flash launches, "
                                 f"expected {14 * n_steps} and 1")
        del grid_pipe, imgs, ref
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        figure = "not drawn: matplotlib is not installed on this host (the figure is host work)"
    else:
        sample_grid.main([bundle, "--out", png, "--sampler", "dpm"])
        size = os.path.getsize(png)
        figure = f"drawn by sample_grid.main, {size} bytes"
        if not size:
            raise AssertionError("sample_grid wrote an empty figure")
    log(f"phase 8 sample_grid figure: {figure}")
    return dict(prep_s=prep_s, encode_s=encode_s, images=n, prep_flash=prep_flash,
                encode_rel_l2=enc_err, train_launches=train_launches, grids=out, bundle=bundle,
                unet_ckpt=unet_ckpt)


def phase_remat_preview(torch, np, attn, tmp, vae_ckpt, clis):
    """Phase 10: remat at full width, the trainer's preview, --debug-nans."""
    import copy
    import csv
    import statistics

    from image_diffusion_torch.compat.from_jax import unet_state_dict
    from image_diffusion_torch.core import checkpoint as ckpt
    from image_diffusion_torch.core.config import DiffusionConfig
    from image_diffusion_torch.models import build_unet
    from image_diffusion_torch.ops import schedule as S
    from image_diffusion_torch.pipelines import DiffusionPipeline
    from image_diffusion_torch.scripts import train_diffusion
    from image_diffusion_torch.training.diffusion_trainer import (Optimizer, Preview, TrainState,
                                                                  draw, make_train_step)

    cfg = DiffusionConfig.from_yaml(CONFIG)
    tc, sc = cfg.train, cfg.schedule

    # (a) one deep-copied state and one batch of 48, one step under each policy
    unet = build_unet(cfg.arch, tc.compute_dtype, "cuda", torch.Generator().manual_seed(0),
                      param_dtype=torch.float32).train()
    base = TrainState(unet, Optimizer(unet.parameters(), tc.learning_rate, tc.warmup_steps,
                                      tc.clip_grad))
    sched = S.make_schedule(sc.num_steps, sc.beta_start, sc.beta_end, sc.noise_type, device="cuda")
    step = make_train_step(sched, tc.cond_drop_prob, reparametrize=True)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((B_TRAIN, 32, 32, 6), dtype=np.float32)).cuda()
    c = torch.from_numpy(rng.integers(0, 3, B_TRAIN)).cuda()
    draws = draw(torch.Generator(device="cuda").manual_seed(10), x.shape, sc.num_steps, True)
    step(base, x, c, draws)  # the Adam moments exist: the held state is a trained one's
    torch.cuda.synchronize()

    def one_step(policy):
        st = copy.deepcopy(base)
        st.unet.remat = policy
        torch.cuda.synchronize()
        base_mb = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        attn.packed_attention.launches = attn.packed_attention_bwd.launches = 0
        step(st, x, c, draws)
        torch.cuda.synchronize()
        out = dict(base_mb=base_mb, peak_mb=torch.cuda.max_memory_allocated() / 2**20,
                   launches=(attn.packed_attention.launches, attn.packed_attention_bwd.launches),
                   grad=torch.cat([p.grad.flatten() for p in st.optimizer.params]).float().cpu())
        return st, out

    remat = {}
    for name, policy in (("none", None), ("dots", "dots"), ("full", "full")):
        st, r = one_step(policy)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st, x, c, draws)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof, kernels, wall = device_profile(torch, lambda: step(st, x, c, draws), iters=3)
        r.update(ms=statistics.median(times), busy_ms=sum(prof.values()), wall_ms=wall,
                 kernels=kernels)
        remat[name] = r
        del st
    _, again = one_step(None)  # none twice: the floor of the card's own rounding
    ref = remat["none"]["grad"]
    floor = float((again["grad"] - ref).abs().max() / ref.abs().max())
    for name, r in remat.items():
        grad = r.pop("grad")
        r["grad_rel_max"] = float((grad - ref).abs().max() / ref.abs().max())
        r["bit_equal"] = bool(torch.equal(grad, ref))
        log(f"phase 10 remat {name}: batch {B_TRAIN}, one step from one state, the clipped gradient "
            f"max|diff|/max|none| {r['grad_rel_max']:.3e} (bit equal {r['bit_equal']}; tolerance "
            f"{REMAT_GRAD_REL}; none against none {floor:.3e}); peak memory {r['peak_mb']:.0f} MiB, "
            f"{r['peak_mb'] - r['base_mb']:.0f} MiB above the {r['base_mb']:.0f} MiB held; "
            f"{r['ms']:.2f} ms/step (median of 5), device busy {r['busy_ms']:.3f} ms of "
            f"{r['wall_ms']:.3f} ms (idle share {idle_share(r['busy_ms'], r['wall_ms'])}), "
            f"{r['kernels']:.0f} kernels; packed launches a step {r['launches'][0]} forward, "
            f"{r['launches'][1]} backward")
    del base, unet, again
    torch.cuda.empty_cache()
    if any(r["launches"] != (14, 14) for r in remat.values()):
        raise AssertionError("remat: packed launches other than 14 + 14 a step")
    if max(r["grad_rel_max"] for r in remat.values()) > REMAT_GRAD_REL:
        raise AssertionError("remat: the gradient under a policy differs from none's")

    # (b) 10 steps through the CLI with --remat dots
    lat, lab = os.path.join(tmp, "remat_latents.npy"), os.path.join(tmp, "remat_labels.npy")
    np.save(lat, rng.standard_normal((10 * B_TRAIN, 32, 32, 6), dtype=np.float32).astype(np.float16))
    np.save(lab, rng.integers(0, 3, 10 * B_TRAIN).astype(np.uint8))
    config = _diffusion_config(tmp, "remat", lat, lab)
    attn.packed_attention.launches = attn.packed_attention_bwd.launches = 0
    t0 = time.perf_counter()
    trainer = train_diffusion.main(["--config", config, "--experiment-name", "remat",
                                    "--no-mlflow", "--remat", "dots"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = (attn.packed_attention.launches, attn.packed_attention_bwd.launches)
    with open(os.path.join(tmp, "logs", "remat_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["value"]) for r in rows if r["name"] == "unet/loss"]
    sps = [float(r["value"]) for r in rows if r["name"] == "unet/samples_per_sec"]
    cli_step_ms = B_TRAIN / sps[-1] * 1e3  # the second flush: steps 6-10
    log(f"phase 10 train_diffusion --remat dots: {trainer.state.step} steps in {cli_s:.1f} s "
        f"(set-up and checkpoint included), steps 6-10 {cli_step_ms:.2f} ms/step; "
        f"loss at the flushes " + " ".join(f"{v:.5f}" for v in losses)
        + f"; kernel launches {cli_launches[0]} forward, {cli_launches[1]} backward")
    if not (trainer.unet.remat == "dots" and trainer.state.step == 10 and len(losses) == 2
            and np.isfinite(losses).all() and cli_launches == (140, 140)):
        raise AssertionError("train_diffusion --remat dots: wrong policy, steps, launches or "
                             "non-finite losses")
    del trainer

    # (c) the trainer's preview, sampled from phase 8's VAE and EMA weights,
    # against pipe.sample of phase 8's bundle (make_bundle --ema of the same)
    trees, _ = ckpt.load_checkpoint(clis["unet_ckpt"])
    ema = unet_state_dict(trees["unet_ema"])
    preview = Preview(vae_ckpt, cfg, ema, steps=20, scale=3.0, device="cuda")
    attn.packed_attention.launches = attn.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = preview.images(ema, seed=0)
    torch.cuda.synchronize()
    preview_s = time.perf_counter() - t0
    preview_launches = (attn.packed_attention.launches, attn.flash_attention.launches)
    pipe = DiffusionPipeline.from_checkpoint(clis["bundle"])
    ref = pipe.sample([3.0], seed=0, sampler="dpm", num_inference_steps=20)
    same = bool(torch.equal(imgs, ref))
    log(f"phase 10 preview: {tuple(imgs.shape)} {imgs.dtype} from phase 8's VAE checkpoint and EMA "
        f"weights in {preview_s:.3f} s; {preview_launches[0]} packed and {preview_launches[1]} flash "
        f"launches; equal to pipe.sample of the --ema bundle with the same scale, seed and "
        f"steps bit for bit: {same}")
    if not (same and imgs.shape == (3, 128, 128, 3) and preview_launches == (280, 1)):
        raise AssertionError("preview: images differ from pipe.sample's, or launches other than "
                             "280 packed and 1 flash")
    del preview, pipe, imgs, ref, trees, ema

    # (d) --debug-nans: a NaN in one latent of 2 batches
    bad = rng.standard_normal((2 * B_TRAIN, 32, 32, 6), dtype=np.float32).astype(np.float16)
    bad[7, 3, 3, 0] = np.nan
    np.save(lat, bad)
    np.save(lab, rng.integers(0, 3, 2 * B_TRAIN).astype(np.uint8))
    try:
        train_diffusion.main(["--config", config, "--experiment-name", "nan", "--no-mlflow",
                              "--debug-nans"])
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("--debug-nans: a NaN in the batch raised no FloatingPointError")
    log(f"phase 10 --debug-nans: a NaN in one latent of 2 batches raised FloatingPointError: "
        f"{raised}")
    torch.cuda.empty_cache()
    return dict(remat=remat, remat_grad_floor=floor, cli_launches=cli_launches,
                cli_step_ms=cli_step_ms, preview_s=preview_s,
                preview_launches=preview_launches, debug_nans=raised)


def phase_fid(torch, np, attn, tmp, vae_train, clis):
    """Phase 11: the FID Inception, per-epoch dev/FID, eval_fid."""
    import csv
    from contextlib import nullcontext

    import image_diffusion_torch.models.inception as inception
    from image_diffusion_torch.core.config import VAEConfig
    from image_diffusion_torch.core.rng import epoch_seed, eval_generator, root_seed
    from image_diffusion_torch.models.fid import FID
    from image_diffusion_torch.pipelines import DiffusionPipeline
    from image_diffusion_torch.scripts import eval_fid, train_vae
    from image_diffusion_torch.tools.e2e_synthetic_run import random_inception_file
    from image_diffusion_torch.training.data import ArrayDataset, eval_batches
    from image_diffusion_torch.training.vae_trainer import _latent_shape, normalize_batch

    # (a) random weights
    weights = os.path.join(tmp, "inception.pth")
    t0 = time.perf_counter()
    random_inception_file(weights, seed=0)
    model = inception.load_inception(weights)
    cpu_model = inception.load_inception(weights, "cpu")
    log(f"phase 11 inception: random torchvision-layout weights written and loaded in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters()):,} parameters")

    # (b) card vs CPU in fp32 on 8 of phase 7's images; TF32 on, for the record
    images = np.load(vae_train["images"], mmap_mode="r")
    x8 = torch.from_numpy(np.asarray(images[:8], np.float32) / 255.0)
    ref = cpu_model(x8)
    got = model(x8.cuda()).cpu()
    err = float((got - ref).abs().max() / ref.abs().max())
    saved, inception.no_tf32 = inception.no_tf32, nullcontext
    tf32_saved, torch.backends.cudnn.allow_tf32 = torch.backends.cudnn.allow_tf32, True
    try:
        tf32 = model(x8.cuda()).cpu()
    finally:
        inception.no_tf32, torch.backends.cudnn.allow_tf32 = saved, tf32_saved
    tf32_err = float((tf32 - ref).abs().max() / ref.abs().max())
    log(f"phase 11 inception features: 8 images of 128x128, card vs CPU in fp32 max|diff|/max "
        f"{err:.3e} (tolerance {INCEPTION_REL}); with TF32 on, not held, {tf32_err:.3e}")
    if not (got.shape == (8, 2048) and torch.isfinite(got).all() and err <= INCEPTION_REL):
        raise AssertionError("inception features on the card disagree with the CPU")
    del cpu_model

    # (c) feature throughput at chunks of 256
    x256 = torch.from_numpy(np.asarray(images[:256], np.float32) / 255.0).cuda()
    feat_ms = cuda_ms(lambda: model(x256), iters=3, warmup=1)
    log(f"phase 11 inception throughput: chunks of 256 images of 128x128 (resized to 299): "
        f"{feat_ms:.1f} ms a chunk, {256 / feat_ms * 1e3:.1f} images/s")
    del x256

    # (d) one epoch of phase 7's config through train_vae with --fid-weights
    config = _stage1_config(tmp, VAE_CONFIG, "fid")
    attn.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = train_vae.main(["--config", config, "--experiment-name", "fid", "--no-mlflow",
                              "--lpips-weights", os.path.join(tmp, "lpips.pth"),
                              "--fid-weights", weights])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_flash = attn.flash_attention.launches
    with open(os.path.join(tmp, "logs", "fid_metrics.csv")) as f:
        logged = {r["name"]: float(r["value"]) for r in csv.DictReader(f)
                  if r["name"].startswith("dev/")}
    # the same evaluation outputs again: the trained VAE on the dev set with
    # the epoch's eval draws, features by a fresh model, a fresh FID
    cfg = VAEConfig.from_yaml(config)
    dev = ArrayDataset(np.load(os.path.join(tmp, "dev.npy")))
    seed = epoch_seed(root_seed(cfg.train.seed, offset=cfg.train.epochs), 0)

    def evaluate(fid):
        gen = eval_generator(seed, "cuda")
        for n_valid, (xb,) in eval_batches(dev, cfg.train.batch_size, "cuda"):
            noise = torch.randn((xb.shape[0], *_latent_shape(cfg, xb)), generator=gen, device="cuda")
            x_hat = trainer.eval_step(trainer.state.vae, xb, noise, n_valid)[0]
            if fid is not None:
                fid.update_fake(((x_hat + 1.0) / 2.0)[:n_valid])
                fid.update_real_once(((normalize_batch(xb) + 1.0) / 2.0)[:n_valid])
        torch.cuda.synchronize()
        if fid is None:
            return None, 0.0
        t0 = time.perf_counter()
        return fid.compute(), time.perf_counter() - t0

    t0 = time.perf_counter()
    evaluate(None)
    eval_s = time.perf_counter() - t0
    fresh = FID(inception.load_inception(weights), 2048)
    t0 = time.perf_counter()
    again, distance_s = evaluate(fresh)
    eval_fid_s = time.perf_counter() - t0
    fid_err = abs(logged.get("dev/FID", float("nan")) - again) / abs(again)
    n_dev = len(dev)
    log(f"phase 11 train_vae --fid-weights: {trainer.state.step} steps and the dev evaluation in "
        f"{run_s:.1f} s (set-up and checkpoint included); dev/FID "
        f"{logged.get('dev/FID', float('nan')):.4f}, recomputed from the same evaluation outputs "
        f"{again:.4f} (|diff|/FID {fid_err:.3e}, tolerance {FID_REL}); the dev evaluation of "
        f"{n_dev} images {eval_s:.2f} s without FID, {eval_fid_s:.2f} s with (real and fake "
        f"features, and the distance on the host: {distance_s:.2f} s); flash launches {run_flash}")
    dev_batches = -(-n_dev // B_TRAIN)
    if not (np.isfinite(logged.get("dev/FID", float("nan"))) and fid_err <= FID_REL
            and run_flash == 2 * (VAE_TRAIN_STEPS + dev_batches)):
        raise AssertionError("train_vae --fid-weights: dev/FID missing, non-finite or unequal to "
                             "its recomputation, or flash launches other than 2 a step and a "
                             "dev batch")
    del trainer

    # (e) eval_fid on phase 8's bundle against phase 7's images
    args = eval_fid.parse_args([clis["bundle"], "--real", vae_train["images"], "--fid-weights",
                                weights, "--num-images", "270", "--sampler", "ddim", "--steps",
                                "50", "--batch", "64"])
    attn.packed_attention.launches = attn.flash_attention.launches = 0
    t0 = time.perf_counter()
    res = eval_fid.evaluate(args)
    total_s = time.perf_counter() - t0
    launches = (attn.packed_attention.launches, attn.flash_attention.launches)
    # the port's FID over pipe.sample with the same seeds
    fid = FID(inception.load_inception(weights), 2048)
    pipe = DiffusionPipeline.from_checkpoint(clis["bundle"])
    eval_fid.ingest_real(fid, vae_train["images"], args.max_real, "cuda")
    per_call, done = args.batch // len(pipe.classes), 0
    for seed in range(res["calls"]):
        imgs = pipe.sample(args.cfg, num_images=per_call, seed=seed, sampler="ddim",
                           num_inference_steps=50)
        take = min(len(imgs), args.num_images - done)
        fid.update_fake((imgs[:take] + 1.0) / 2.0)
        done += take
    ref_fid = fid.compute()
    eval_err = abs(res["fid"] - ref_fid) / abs(ref_fid)
    rate = res["images"] / res["seconds"]
    log(f"phase 11 eval_fid: FID {res['fid']:.4f} over {res['images']} images ({res['calls']} "
        f"calls of {per_call} a class at cfg {args.cfg}, ddim-50) against {res['n_real']} real; "
        f"the port's FID over pipe.sample with the same seeds {ref_fid:.4f} (|diff|/FID "
        f"{eval_err:.3e}, tolerance {FID_REL}); sampling {res['seconds']:.2f} s ({rate:.2f} img/s, "
        f"the fake features included), {total_s:.2f} s in all; {launches[0]} packed launches "
        f"({launches[0] / (50 * res['calls']):.0f} a DDIM step), {launches[1]} flash")
    if not (np.isfinite(res["fid"]) and eval_err <= FID_REL and res["images"] == 270
            and res["n_real"] == len(images) and launches == (14 * 50 * res["calls"], res["calls"])):
        raise AssertionError("eval_fid: non-finite FID, unequal to pipe.sample's, or wrong counts")
    return dict(inception_rel_err=err, inception_tf32_rel_err=tf32_err, feature_chunk_ms=feat_ms,
                feature_imgs_per_s=256 / feat_ms * 1e3, vae_fid=logged["dev/FID"],
                vae_fid_rel_diff=fid_err, vae_run_s=run_s, dev_eval_s=eval_s,
                dev_eval_fid_s=eval_fid_s, fid_distance_s=distance_s, vae_flash=run_flash, eval_fid=res["fid"],
                eval_fid_rel_diff=eval_err, eval_fid_imgs_per_s=rate, eval_fid_launches=launches)


def _http(url: str, payload: dict | None = None, timeout: float = 300):
    """(status, body, seconds) of a GET (payload None) or a JSON POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.perf_counter() - t0


def phase_serve(torch, np, attn, tmp, vae_state, unet_state):
    """Phase 12: the port's server on a bundle of the shipped KL config."""
    import argparse
    import socket
    import threading

    from image_diffusion_torch.core.config import ScheduleConfig, UNetArch, VAEArch
    from image_diffusion_torch.pipelines import DiffusionPipeline
    from image_diffusion_torch.scripts import serve

    path = os.path.join(tmp, "serve_bundle.ckpt")
    DiffusionPipeline(VAEArch(), vae_state, UNetArch(), unet_state, ScheduleConfig(),
                      "a hot place,a cold place,a mild place", device="cpu",
                      dtype=torch.float32).to_checkpoint(path)

    # (a) the server as users start it
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    server_log = os.path.join(tmp, "serve.log")
    t0 = time.perf_counter()
    with open(server_log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "image_diffusion_torch.scripts.serve", path,
                                 "--port", str(port), *SERVE_ARGS],
                                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out,
                                stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError("the server died or never warmed up:\n"
                                     + open(server_log).read()[-4000:])
            try:
                status, body, _ = _http(base + "/healthz", timeout=5)
                if status == 200 and json.loads(body)["compiled"]:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        single = [_http(base + "/sample", {"class": i % 3, "cfg_scale": 3.0, "seed": 1000 + i})
                  for i in range(10)]
        if any(r[0] != 200 for r in single):
            raise AssertionError(f"single requests failed: {[r[:2] for r in single if r[0] != 200]}")
        single_ms = float(np.median([r[2] for r in single])) * 1e3
        before = json.loads(_http(base + "/info")[1])["stats"]

        reqs = [{"class": i % 3, "cfg_scale": float(1 + i % 9), "seed": 5000 + i}
                for i in range(SERVE_BURST)]
        burst = [None] * SERVE_BURST
        gate = threading.Barrier(SERVE_BURST + 1)

        def call(i):
            gate.wait()
            try:
                burst[i] = _http(base + "/sample", reqs[i])
            except OSError as e:
                burst[i] = (0, repr(e).encode(), 0.0)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(SERVE_BURST)]
        for t in threads:
            t.start()
        gate.wait()
        t1 = time.perf_counter()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t1
        info = json.loads(_http(base + "/info")[1])
        errors = [(i, r[0], r[1][:200]) for i, r in enumerate(burst) if r[0] != 200]
        p50, p95 = (float(np.percentile([r[2] for r in burst], q)) * 1e3 for q in (50, 95))
        stats = {k: info["stats"][k] - before[k] for k in before}
        # one request of the burst again, alone: the same PNG bytes
        again = [_http(base + "/sample", reqs[i]) for i in (0, 37)]
        same = [again[j][1] == burst[i][1] for j, i in enumerate((0, 37))]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    rate = SERVE_BURST / burst_s
    log(f"phase 12 server: `python -m image_diffusion_torch.scripts.serve {' '.join(SERVE_ARGS)}` "
        f"on a bundle of the shipped KL config, warm after {ready_s:.1f} s; info {info['sampler']}-"
        f"{info['steps']} batch {info['batch_size']} image {info['image_size']}; single request "
        f"median {single_ms:.1f} ms of 10 sequential; burst of {SERVE_BURST} concurrent (3 classes, "
        f"cfg 1-9, distinct seeds): {burst_s:.3f} s, {rate:.2f} img/s, latency p50 "
        f"{p50:.1f} ms p95 {p95:.1f} ms, "
        f"{len(errors)} errors, {stats['requests']} requests in {stats['batches']} batches; "
        f"requests 0 and 37 alone again byte-identical to the burst's: {same}")
    if errors or not stats["batches"] < stats["requests"] == SERVE_BURST or not all(same):
        raise AssertionError(f"serving: errors {errors[:3]}, stats {stats}, identical {same}")

    # (b) the engine in this process: launches, idle share, determinism
    def engine(**kw):
        args = dict(model=path, batch_size=SERVE_BATCH, linger_ms=40.0, sampler="dpm", steps=20,
                    eta=0.0, device="cuda", data_parallel=None)
        e = serve.Engine(argparse.Namespace(**{**args, **kw}))
        e.warmup()
        return e

    eng = engine()
    seeds, labels = list(range(11, 11 + SERVE_BATCH)), [i % 3 for i in range(SERVE_BATCH)]
    scales = [float(1 + i) for i in range(SERVE_BATCH)]
    torch.cuda.synchronize()
    attn.packed_attention.launches = attn.flash_attention.launches = 0
    imgs = eng._run(seeds, labels, scales)
    torch.cuda.synchronize()
    launches = (attn.packed_attention.launches, attn.flash_attention.launches)
    gens = eng._row_generators(seeds)
    with torch.inference_mode():
        x_init = torch.stack([torch.randn(eng.pipe.latent_shape, generator=g, device="cuda")
                              for g in gens])
    ref = eng.pipe.sample_batch(labels, scales, x_init, sampler="dpm", num_inference_steps=20,
                                row_generators=gens, output="uint8")
    equal = bool(torch.equal(imgs, ref))
    prof, kernels, wall = device_profile(torch, lambda: eng._run(seeds, labels, scales).cpu())
    busy = sum(prof.values())
    log(f"phase 12 engine: one served dpm-20 batch of {SERVE_BATCH}: {launches[0]} packed and "
        f"{launches[1]} flash launches; bit-equal to pipe.sample_batch with the same per-row "
        f"generators: {equal}; device busy {busy:.3f} ms of {wall:.3f} ms (the PNG encode "
        f"excluded; idle share {idle_share(busy, wall)}), {kernels:.0f} kernels")
    if launches != (14 * 20, 1) or not equal or imgs.shape != (SERVE_BATCH, 128, 128, 3):
        raise AssertionError("served batch: wrong launches or unequal to pipe.sample_batch")

    # stochastic ddim (eta 1, every step draws noise): a request alone in
    # slot 0 and co-batched in slot 5, and another seed in slot 0
    eng_ddim = engine(sampler="ddim", steps=50, eta=1.0)
    pad = SERVE_BATCH - 1
    attn.packed_attention.launches = attn.flash_attention.launches = 0
    alone = eng_ddim._run([77] + [0] * pad, [2] + [0] * pad, [4.0] + [1.0] * pad)
    torch.cuda.synchronize()
    ddim_launches = (attn.packed_attention.launches, attn.flash_attention.launches)
    co_seeds, co_labels = [5, 6, 7, 8, 9, 77, 10, 11], [0, 1, 2, 0, 1, 2, 0, 1]
    co_scales = [2.0, 3.0, 5.0, 6.0, 7.0, 4.0, 8.0, 9.0]
    cobatched = eng_ddim._run(co_seeds, co_labels, co_scales)
    other = eng_ddim._run([78] + [0] * pad, [2] + [0] * pad, [4.0] + [1.0] * pad)
    slot_equal = bool(torch.equal(alone[0], cobatched[5]))
    differs = not torch.equal(alone[0], other[0])
    n_diff = int((alone[0] != cobatched[5]).sum())
    log(f"phase 12 stochastic ddim-50 eta 1: seed 77 alone in slot 0 vs co-batched in slot 5 next "
        f"to 7 other requests byte-identical: {slot_equal} ({n_diff} bytes differ); seed 78 in "
        f"slot 0 differs: {differs}; {ddim_launches[0]} packed and {ddim_launches[1]} flash "
        f"launches a batch")
    if not (slot_equal and differs) or ddim_launches != (14 * 50, 1):
        raise AssertionError("stochastic serving: a request's image depends on its slot, or "
                             "distinct seeds agree, or wrong launches")
    return dict(ready_s=ready_s, single_ms=single_ms, burst_s=burst_s, burst_imgs_per_s=rate,
                p50_ms=p50, p95_ms=p95,
                errors=len(errors), requests=stats["requests"], batches=stats["batches"],
                launches=launches, ddim_launches=ddim_launches, batch_busy_ms=busy,
                batch_wall_ms=wall, batch_kernels=kernels)


def _random_clip_state(np, seed: int = 0) -> dict:
    """A random fp32 state dict in transformers' CLIPModel layout at
    CLIP_B32's widths (the CPU tests' recipe, tests/test_torch_port_clip.py)."""
    c = CLIP_B32
    rng = np.random.default_rng(seed)

    def normal(*shape, std=0.2):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    state = {"logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}

    def ln(key, width):
        state[key + ".weight"] = 1.0 + normal(width, std=0.1)
        state[key + ".bias"] = normal(width, std=0.1)

    def lin(key, n_in, n_out, bias=True):
        state[key + ".weight"] = normal(n_out, n_in, std=n_in ** -0.5)
        if bias:
            state[key + ".bias"] = normal(n_out, std=0.05)

    def encoder(prefix, width, hidden, layers):
        for i in range(layers):
            base = f"{prefix}.encoder.layers.{i}"
            ln(base + ".layer_norm1", width)
            for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(f"{base}.self_attn.{p}", width, width)
            ln(base + ".layer_norm2", width)
            lin(base + ".mlp.fc1", width, hidden)
            lin(base + ".mlp.fc2", hidden, width)

    v, t, p = "vision_model", "text_model", c["patch_size"]
    state[f"{v}.embeddings.class_embedding"] = normal(c["vision_width"])
    state[f"{v}.embeddings.patch_embedding.weight"] = normal(c["vision_width"], 3, p, p,
                                                             std=(3 * p * p) ** -0.5)
    state[f"{v}.embeddings.position_embedding.weight"] = normal(
        (c["image_size"] // p) ** 2 + 1, c["vision_width"])
    ln(f"{v}.pre_layrnorm", c["vision_width"])
    encoder(v, c["vision_width"], c["vision_hidden"], c["vision_layers"])
    ln(f"{v}.post_layernorm", c["vision_width"])
    lin("visual_projection", c["vision_width"], c["projection_dim"], bias=False)
    state[f"{t}.embeddings.token_embedding.weight"] = normal(c["vocab_size"], c["text_width"])
    state[f"{t}.embeddings.position_embedding.weight"] = normal(c["text_positions"],
                                                                c["text_width"])
    encoder(t, c["text_width"], c["text_hidden"], c["text_layers"])
    ln(f"{t}.final_layer_norm", c["text_width"])
    lin("text_projection", c["text_width"], c["projection_dim"], bias=False)
    return state


def _random_clip_dir(torch, path: str, state: dict) -> None:
    """A `from_pretrained`-loadable CLIP directory at CLIP_B32's widths
    with the weights `state`: transformers' `CLIPModel`, a hand-made BPE
    vocabulary of the prompts' words and single characters (no download;
    tests/test_clip_labels.py's recipe) whose <|endoftext|> the text config
    pools at, and 224x224 preprocessing."""
    from transformers import CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPProcessor, CLIPTokenizer

    c = CLIP_B32
    os.makedirs(path, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for w in "a hot cold mild place".split():
        vocab.setdefault(w + "</w>", len(vocab))
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    # from the files: transformers 5's constructor takes no vocabulary file
    tok = CLIPTokenizer.from_pretrained(path)
    eos = tok.eos_token_id
    if any(eos not in row for row in tok(["a hot place", "a cold place", "a mild place"])["input_ids"]):
        raise AssertionError(f"the hand-made tokenizer ends no prompt with its EOS id {eos}")
    cfg = CLIPConfig(
        text_config=dict(vocab_size=c["vocab_size"], hidden_size=c["text_width"],
                         intermediate_size=c["text_hidden"], num_hidden_layers=c["text_layers"],
                         num_attention_heads=c["text_heads"],
                         max_position_embeddings=c["text_positions"],
                         eos_token_id=eos, projection_dim=c["projection_dim"]),
        vision_config=dict(hidden_size=c["vision_width"], intermediate_size=c["vision_hidden"],
                           num_hidden_layers=c["vision_layers"],
                           num_attention_heads=c["vision_heads"], image_size=c["image_size"],
                           patch_size=c["patch_size"], projection_dim=c["projection_dim"]),
        projection_dim=c["projection_dim"])
    model = CLIPModel(cfg)
    missing, unexpected = model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                                                strict=False)
    if unexpected or any(not k.endswith("position_ids") for k in missing):
        raise AssertionError(f"CLIP state dict against CLIPModel: missing {missing}, "
                             f"unexpected {unexpected}")
    model.save_pretrained(path)
    size = c["image_size"]  # the processor's default, 224
    improc = CLIPImageProcessor(size={"shortest_edge": size},
                                crop_size={"height": size, "width": size})
    CLIPProcessor(image_processor=improc, tokenizer=tok).save_pretrained(path)


def phase_clip(torch, np, attn, tmp, vae_train):
    """Phase 13: CLIP zero-shot labels at ViT-B/32's widths."""
    from contextlib import nullcontext
    from importlib.util import find_spec

    import image_diffusion_torch.models.clip as clip_mod
    from image_diffusion_torch.scripts import prepare_dataset
    from image_diffusion_torch.scripts.prepare_dataset import zero_shot_labels

    t0 = time.perf_counter()
    state = _random_clip_state(np)
    kw = dict(vision_heads=CLIP_B32["vision_heads"], text_heads=CLIP_B32["text_heads"],
              patch_size=CLIP_B32["patch_size"], eos_token_id=2)
    model = clip_mod.CLIPZeroShot.from_state_dict(state, **kw)
    cpu_model = clip_mod.CLIPZeroShot.from_state_dict(state, **kw, device="cpu")
    log(f"phase 13 clip: random ViT-B/32-width weights in transformers' layout built and loaded "
        f"in {time.perf_counter() - t0:.1f} s; {sum(p.numel() for p in model.parameters()):,} "
        f"parameters")

    # 3 prompts as CLIPProcessor tokenizes them (start 49406, words, end
    # 49407 padding to the longest); 8 images normalised as its output
    rng = np.random.default_rng(13)
    L = 7
    ids = np.full((3, L), 49407, np.int64)
    am = np.zeros((3, L), np.int64)
    for i, n in enumerate((4, 6, 5)):
        ids[i, 0], ids[i, 1:n - 1] = 49406, rng.integers(300, 49000, n - 2)
        am[i, :n] = 1
    mean = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)[:, None, None]
    std = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)[:, None, None]

    def pixels(n):
        u8 = rng.integers(0, 256, (n, 3, 224, 224), dtype=np.uint8)
        return (u8.astype(np.float32) / 255.0 - mean) / std

    x8 = pixels(8)
    ref = cpu_model.logits_per_image(x8, ids, am)
    got = model.logits_per_image(x8, ids, am).cpu()
    err = float((got - ref).abs().max() / ref.abs().max())
    saved, clip_mod.no_tf32 = clip_mod.no_tf32, nullcontext
    tf32_saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = model.logits_per_image(x8, ids, am).cpu()
    finally:
        clip_mod.no_tf32 = saved
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_saved
    tf32_err = float((tf32 - ref).abs().max() / ref.abs().max())
    log(f"phase 13 clip logits: 8 images x 3 prompts, card vs CPU in fp32 max|diff|/max "
        f"{err:.3e} (tolerance {CLIP_REL}); with TF32 on, not held, {tf32_err:.3e}; logits range "
        f"[{float(ref.min()):.3f}, {float(ref.max()):.3f}]")
    if not (got.shape == (8, 3) and torch.isfinite(got).all() and err <= CLIP_REL):
        raise AssertionError("CLIP logits on the card disagree with the CPU")

    # encode_images at prepare_dataset's batch
    x64 = torch.from_numpy(pixels(64)).cuda()
    enc_ms = cuda_ms(lambda: model.encode_images(x64), iters=5)
    enc_dev = device_ms(torch, lambda: model.encode_images(x64))
    log(f"phase 13 clip encode_images: batch 64 of 224x224 in {enc_ms:.2f} ms by events "
        f"({64 / enc_ms * 1e3:.1f} images/s; device {enc_dev:.2f} ms)")

    # the classifying loop on 1,200 processed images, card vs CPU
    batches = [pixels(min(64, CLIP_IMAGES - i)) for i in range(0, CLIP_IMAGES, 64)]
    t0 = time.perf_counter()
    labels = zero_shot_labels(model, batches, ids, am)
    card_s = time.perf_counter() - t0
    cpu_labels = zero_shot_labels(cpu_model, batches, ids, am)
    flat = np.concatenate(batches)
    diff = np.flatnonzero(labels != cpu_labels)
    ties = []
    for i in diff:
        row = cpu_model.logits_per_image(flat[i:i + 1], ids, am)[0]
        ties.append(float((row[int(labels[i])] - row[int(cpu_labels[i])]).abs() / row.abs().max()))
    counts = np.bincount(labels, minlength=3).tolist()
    log(f"phase 13 clip labels: {CLIP_IMAGES} images in batches of 64 through zero_shot_labels in "
        f"{card_s:.2f} s on the card ({CLIP_IMAGES / card_s:.1f} images/s, host batches "
        f"included); per class {counts}; {len(diff)} differ from the CPU's"
        + (f", logit gaps / max|logit| {['%.2e' % g for g in ties]} (tolerance {CLIP_TIE})"
           if ties else ""))
    if len(labels) != CLIP_IMAGES or any(g > CLIP_TIE for g in ties):
        raise AssertionError("CLIP labels: a card label differs from the CPU's beyond a near-tie")
    out = dict(clip_rel_err=err, clip_tf32_rel_err=tf32_err, clip_encode_ms=enc_ms,
               clip_encode_device_ms=enc_dev, clip_imgs_per_s=64 / enc_ms * 1e3,
               clip_label_s=card_s, clip_label_diffs=len(diff))
    del model, cpu_model, batches, flat

    # the CLI: prepare_dataset --labels-mode clip with phase 7's checkpoint,
    # from a CLIP directory of these weights, both backends, on images of a
    # colour and a noise level each (uniform noise, phase 7's images, gives
    # every image one embedding at random weights)
    if find_spec("transformers") is None:
        log("phase 13 clip CLI: not run: transformers (the CLI's CLIPProcessor) is not "
            "installed on this host")
        return out
    clip_dir = os.path.join(tmp, "clip")
    _random_clip_dir(torch, clip_dir, state)
    del state
    images_path = os.path.join(tmp, "clip_images.npy")
    rng = np.random.default_rng(14)
    base = rng.uniform(0, 255, (CLIP_IMAGES, 1, 1, 3))
    noise = rng.standard_normal((CLIP_IMAGES, 128, 128, 3)) * rng.uniform(0, 80, (CLIP_IMAGES, 1, 1, 1))
    np.save(images_path, np.clip(base + noise, 0, 255).astype(np.uint8))
    del noise
    runs = {}
    for backend in ("port", "torch"):
        out_dir = os.path.join(tmp, f"clip_{backend}")
        attn.flash_attention.launches = 0
        t0 = time.perf_counter()
        prepare_dataset.main(["diffusion", "--diffusion-images", images_path,
                              "--vae-checkpoint", vae_train["ckpt"], "--clip", clip_dir,
                              "--clip-backend", backend, "--out", out_dir])
        runs[backend] = dict(seconds=time.perf_counter() - t0,
                             flash=attn.flash_attention.launches,
                             labels=np.load(os.path.join(out_dir, "diffusion_labels.npy")),
                             latents=np.load(os.path.join(out_dir, "diffusion_dataset.npy")))
    port, ref = runs["port"], runs["torch"]
    n = len(port["labels"])
    diff = np.flatnonzero(port["labels"] != ref["labels"])
    ties = []
    if len(diff):
        from transformers import CLIPProcessor

        proc = CLIPProcessor.from_pretrained(clip_dir)
        images = np.load(images_path, mmap_mode="r")
        text = proc(text=prepare_dataset.parse_args(["diffusion"]).classes.split(","),
                    return_tensors="np", padding=True)
        cli_model = clip_mod.CLIPZeroShot.from_state_dict(
            _random_clip_state(np), **{**kw, "eos_token_id": proc.tokenizer.eos_token_id},
            device="cpu")
        for i in diff:
            pixel = proc(images=[images[i]], return_tensors="np")["pixel_values"]
            row = cli_model.logits_per_image(pixel, text["input_ids"],
                                             text["attention_mask"])[0]
            ties.append(float((row[int(port["labels"][i])] - row[int(ref["labels"][i])]).abs()
                              / row.abs().max()))
    same_latents = np.array_equal(port["latents"], ref["latents"])
    log(f"phase 13 prepare_dataset --labels-mode clip: {n} images of 128x128, phase 7's VAE, "
        f"a random ViT-B/32-width CLIP directory; --clip-backend port {port['seconds']:.2f} s, torch "
        f"(transformers' CLIPModel on the card) {ref['seconds']:.2f} s (VAE encode, processor "
        f"and files included); per class {np.bincount(port['labels'], minlength=3).tolist()}; "
        f"{len(diff)} labels differ between the backends"
        + (f", logit gaps / max|logit| {['%.2e' % g for g in ties]} (tolerance {CLIP_TIE})"
           if ties else "")
        + f"; latents equal: {same_latents}; flash launches {port['flash']} and {ref['flash']}")
    if (n != CLIP_IMAGES or not same_latents
            or any(g > CLIP_TIE for g in ties) or port["flash"] != -(-n // B_ENCODE)):
        raise AssertionError("prepare_dataset --labels-mode clip: the backends disagree beyond "
                             "a near-tie, or wrong latents or launches")
    out.update(clip_cli_port_s=port["seconds"], clip_cli_torch_s=ref["seconds"],
               clip_cli_label_diffs=len(diff))
    return out


def _torchrun(nproc: int, case: str, work: str, timeout: float):
    """This script's `--rank-worker case work` on `nproc` local ranks under
    torchrun, in a session of its own that is killed whole at `timeout`
    -> (exit code, the launcher's and the ranks' output)."""
    import signal

    log_path = os.path.join(work, f"{case}.log")
    with open(log_path, "w") as out:
        p = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc-per-node", str(nproc), os.path.abspath(__file__),
                              "--rank-worker", case, work],
                             stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
                             env={**os.environ, "PYTHONFAULTHANDLER": "1"})
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = 124
        finally:
            try:
                os.killpg(p.pid, signal.SIGKILL)  # the launcher and every rank
            except ProcessLookupError:
                pass
            p.wait()
    with open(log_path) as f:
        return rc, f.read()


def _flat(tensors) -> "object":
    import torch

    from image_diffusion_torch.parallel.fsdp import full

    return torch.cat([full(t).detach().float().flatten().cpu() for t in tensors])


def _digest(tensors) -> str:
    import hashlib

    return hashlib.sha256(_flat(tensors).numpy().tobytes()).hexdigest()


def _compare_step(torch, got: dict, ref: dict, models) -> dict:
    """A rank's step (`got`) against the one-process step (`ref`), each a
    dict of metrics and, by model, the flat clipped gradients and Adam's
    flat second moments: the errors `phase_parallel` holds."""
    def rel(k):
        return abs(got["metrics"][k] - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-12)

    out = {"loss_rel": {k: rel(k) for k in ref["metrics"] if k.endswith("loss")},
           "norm_rel": {k: rel(k) for k in GRAD_NORMS if k in ref["metrics"]}}
    for model in models:
        for k in ("grad", "nu"):
            a, b = got[model][k], ref[model][k]
            out[f"{model}_{k}_rel_l2"] = float((a - b).norm() / b.norm())
    for k in ("disc_stats", "codebook"):
        if k in ref:
            out[f"{k}_rel_max"] = float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
    return out


def _worker_nccl1(torch, np, attn, work: str) -> dict:
    """Phase 14 (a), world 1 over NCCL under torchrun: one DP step of the
    shipped UNet at batch 48 against the plain step from a deep copy of one
    state, bit for bit; then `train_diffusion` through its `main`."""
    import copy

    from image_diffusion_torch.core.config import DiffusionConfig
    from image_diffusion_torch.models import build_unet
    from image_diffusion_torch.ops import schedule as S
    from image_diffusion_torch.parallel.mesh import initialize_distributed, make_mesh
    from image_diffusion_torch.scripts.train_diffusion import main as train_main
    from image_diffusion_torch.training.diffusion_trainer import (Optimizer, TrainState,
                                                                  make_train_step)

    device = initialize_distributed()
    backend = torch.distributed.get_backend()
    mesh = make_mesh()
    cfg = DiffusionConfig.from_yaml(CONFIG)
    tc = cfg.train
    unet = build_unet(cfg.arch, tc.compute_dtype, device, torch.Generator().manual_seed(0),
                      param_dtype=torch.float32, remat=tc.remat).train()
    plain_state = TrainState(unet, Optimizer(unet.parameters(), tc.learning_rate,
                                             tc.warmup_steps, tc.clip_grad))
    dp_state = copy.deepcopy(plain_state)
    sc = cfg.schedule
    sched = S.make_schedule(sc.num_steps, sc.beta_start, sc.beta_end, sc.noise_type, device=device)
    g = torch.Generator().manual_seed(14)
    x = torch.randn(B_TRAIN, 32, 32, 6, generator=g).half().to(device)
    c = torch.randint(0, 3, (B_TRAIN,), generator=g).to(device)
    kw = dict(reparametrize=True, grad_accum=tc.grad_accum)
    steps = {"plain": make_train_step(sched, tc.cond_drop_prob, **kw),
             "dp": make_train_step(sched, tc.cond_drop_prob, **kw, shard=mesh.data_shard())}
    metrics, launches = {}, {}
    for name, state in (("plain", plain_state), ("dp", dp_state)):
        attn.packed_attention.launches = attn.packed_attention_bwd.launches = 0
        metrics[name] = steps[name](state, x, c, torch.Generator(device=device).manual_seed(3))
        torch.cuda.synchronize()
        launches[name] = [attn.packed_attention.launches, attn.packed_attention_bwd.launches]
    (mu_a, nu_a), (mu_b, nu_b) = plain_state.optimizer.moments(), dp_state.optimizer.moments()
    equal = (all(torch.equal(metrics["plain"][k], metrics["dp"][k]) for k in metrics["plain"])
             and all(torch.equal(a, b) for a, b in zip(
                 plain_state.optimizer.params + mu_a + nu_a,
                 dp_state.optimizer.params + mu_b + nu_b)))
    del plain_state, dp_state, unet

    # train_diffusion through its main, under this launch (world 1, NCCL)
    rng = np.random.default_rng(14)
    n = 5 * B_TRAIN
    np.save(os.path.join(work, "latents.npy"),
            rng.standard_normal((n, 32, 32, 6), dtype=np.float32).astype(np.float16))
    np.save(os.path.join(work, "labels.npy"), rng.integers(0, 3, n).astype(np.uint8))
    config = _diffusion_config(work, "nccl1", os.path.join(work, "latents.npy"),
                               os.path.join(work, "labels.npy"))
    attn.packed_attention.launches = attn.packed_attention_bwd.launches = 0
    t0 = time.perf_counter()
    trainer = train_main(["--config", config, "--experiment-name", "nccl1", "--no-mlflow",
                          "--data-parallel", "1"])
    torch.cuda.synchronize()
    return dict(backend=backend, world=1, bit_equal=equal,
                loss=float(metrics["dp"]["unet/loss"]), grad=float(metrics["dp"]["unet/grad"]),
                step_launches=launches, cli_steps=trainer.state.step,
                cli_s=time.perf_counter() - t0,
                cli_launches=[attn.packed_attention.launches, attn.packed_attention_bwd.launches],
                cli_ckpt=os.path.exists(os.path.join(work, "ckpt", "nccl1", "unet-epoch-00.ckpt")))


def _worker_gloo2(torch, np, attn, work: str) -> dict:
    """Phase 14 (b), two ranks on one card over gloo (CUDA tensors): one
    step of the UNet replicated and one under FSDP (data 1 x model 2), and
    one stage-1 step of each bottleneck with the discriminator active, each
    rank on 24 of 48 rows; rank 0 also takes the one-process step from the
    same state and batch and compares."""
    import torch.distributed as dist

    from image_diffusion_torch.core.config import DiffusionConfig, VAEConfig
    from image_diffusion_torch.core.logging import BasicLogger
    from image_diffusion_torch.core.metrics import MetricHolder
    from image_diffusion_torch.models.lpips import LPIPS
    from image_diffusion_torch.parallel.fsdp import local
    from image_diffusion_torch.parallel.mesh import (all_reduce_mean_, initialize_distributed,
                                                     make_mesh)
    from image_diffusion_torch.training.data import ArrayDataset
    from image_diffusion_torch.training.diffusion_trainer import DiffusionTrainer
    from image_diffusion_torch.training.vae_trainer import VAETrainer

    device = initialize_distributed("cuda:0", backend="gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dirs = dict(checkpoints_dir=os.path.join(work, "ckpt"), logs_dir=os.path.join(work, "logs"),
                plot_set=os.path.join(work, "no-plot-set.npy"))
    logger = BasicLogger(os.path.join(work, "logs"), f"gloo{rank}", True, 5)
    rng = np.random.default_rng(15)
    latents = rng.standard_normal((B_TRAIN, 32, 32, 6), dtype=np.float32).astype(np.float16)
    labels = rng.integers(0, 3, B_TRAIN).astype(np.uint8)
    images = rng.integers(0, 256, (B_TRAIN, 128, 128, 3), dtype=np.uint8)
    out = dict(backend=dist.get_backend(), world=world, rank=rank)

    def run(kind: str, cfg, mesh, **kw) -> dict:
        """One step of a fresh trainer (seeded state) on this rank's rows:
        metrics, flat gradients and parameters by model, launches, ms."""
        if kind == "unet":
            tr = DiffusionTrainer(cfg, ArrayDataset(latents, labels), logger, MetricHolder(5),
                                  device=device, mesh=mesh, **kw)
            batch = (torch.from_numpy(latents).to(device), torch.from_numpy(labels).to(device))
            models = {"unet": tr.state.optimizer}
        else:
            tr = VAETrainer(cfg, ArrayDataset(images), None, logger, MetricHolder(5), device=device,
                            mesh=mesh, **kw)
            batch = (torch.from_numpy(images).to(device),)
            models = {"vae": tr.state.vae_opt, "disc": tr.state.disc_opt}
        if tr.shard is not None:
            rows = torch.from_numpy(tr.shard.rows(B_TRAIN, cfg.train.grad_accum)).to(device)
            batch = tuple(b[rows] for b in batch)
        gen = torch.Generator(device=device).manual_seed(3)
        extra = {} if kind == "unet" else {"disc_active": True}
        attn.packed_attention.launches = attn.packed_attention_bwd.launches = 0
        attn.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = tr.train_step(tr.state, *batch, gen, **extra)
        torch.cuda.synchronize()
        res = dict(ms=(time.perf_counter() - t0) * 1e3,
                   launches=[attn.packed_attention.launches, attn.packed_attention_bwd.launches,
                             attn.flash_attention.launches],
                   metrics={k: float(v) for k, v in metrics.items()})
        for name, opt in models.items():
            res[name] = dict(grad=_flat([p.grad for p in opt.params]), nu=_flat(opt.moments()[1]))
            res[f"{name}_digest"] = _digest(opt.params)
        if kind != "unet":
            res["disc_stats"] = torch.cat([b.float().flatten().cpu()
                                           for b in tr.state.disc.buffers()])
            if hasattr(tr.state.vae, "codebook"):
                res["codebook"] = torch.cat([b.float().flatten().cpu()
                                             for b in tr.state.vae.codebook.buffers()])
        if kind == "unet" and tr.shard is not None and not tr.fsdp:
            # the gloo all-reduce of the step's gradients alone, timed
            grads = [local(p.grad).clone() for p in tr.state.optimizer.params]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                all_reduce_mean_(grads, tr.shard.group)
            torch.cuda.synchronize()
            res["allreduce_ms"] = (time.perf_counter() - t0) * 1e3 / 3
            res["allreduce_mb"] = sum(g.numel() * g.element_size() for g in grads) / 2**20
        del tr
        torch.cuda.empty_cache()
        return res

    unet_cfg = DiffusionConfig.from_yaml(CONFIG, **dirs)
    lpips = LPIPS.from_torch_file(os.path.join(work, "lpips.pth"))
    cases = {"unet_dp": ("unet", unet_cfg, make_mesh(device_type="cuda"), {}),
             "unet_fsdp": ("unet", unet_cfg, make_mesh(data=1, model=2, device_type="cuda"),
                           {"param_sharding": "fsdp"})}
    for name, path in (("kl", VAE_CONFIG), ("vq", VQ_CONFIG)):
        cases[f"{name}_dp"] = ("vae", VAEConfig.from_yaml(path, **dirs),
                               make_mesh(device_type="cuda"), {"percept_fn": lpips})
    for name, (kind, cfg, mesh, kw) in cases.items():
        try:
            got = run(kind, cfg, mesh, **kw)
        except Exception as e:  # reported, and failed by the parent
            out[name] = {"error": f"{type(e).__name__}: {e}"}
            continue
        digests = [None] * world
        dist.all_gather_object(digests, {k: v for k, v in got.items() if k.endswith("_digest")})
        res = {k: v for k, v in got.items() if k in ("ms", "launches", "metrics", "allreduce_ms",
                                                    "allreduce_mb")}
        res["ranks_equal"] = all(d == digests[0] for d in digests)
        if rank == 0:  # the one-process step from the same state and batch
            ref = run(kind, cfg, None, **kw)
            res["one_process_ms"] = ref["ms"]
            res.update(_compare_step(torch, got, ref,
                                     ("unet",) if kind == "unet" else ("vae", "disc")))
        out[name] = res
        dist.barrier()
    return out


def _rank_worker(case: str, work: str) -> int:
    """One rank of phase 14's launches (`--rank-worker case work`): writes
    its results to `work/{case}-rank{RANK}.json`."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from image_diffusion_torch.ops import attention as attn
    from image_diffusion_torch.parallel.mesh import initialize_distributed

    if case == "nccl-shared":  # two NCCL ranks on one card must be refused
        try:
            initialize_distributed("cuda:0")
        except RuntimeError as e:
            print(f"REFUSED rank {os.environ['RANK']}: {e}", flush=True)
            return 3
        return 0
    out = {"nccl1": _worker_nccl1, "gloo2": _worker_gloo2}[case](torch, np, attn, work)
    with open(os.path.join(work, f"{case}-rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def phase_parallel(torch, np, attn, tmp, vae_state, unet_state, grid):
    """Phase 14: the multi-device layer on the one card (see the module
    doc).  `grid`: phase 5's ddpm-1000 images on the host and its dpm-20
    seconds, device busy and wall ms."""
    work = os.path.join(tmp, "phase14")
    os.makedirs(work)
    _random_lpips_file(torch, os.path.join(work, "lpips.pth"))
    a = _phase14_nccl(work)
    b, rank1 = _phase14_gloo(work)
    c = _phase14_sharding(torch, attn, work, vae_state, unet_state, grid)
    return dict(nccl1=a, gloo2=b, gloo2_rank1_launches=rank1, **c)


def _phase14_nccl(work: str) -> dict:
    """Phase 14 (a) and the refusal of two NCCL ranks on one card."""
    # (a) world 1 over NCCL
    t0 = time.perf_counter()
    rc, text = _torchrun(1, "nccl1", work, timeout=300)
    if rc != 0:
        raise AssertionError(f"phase 14 (a): the NCCL launch failed ({rc}):\n{text[-4000:]}")
    with open(os.path.join(work, "nccl1-rank0.json")) as f:
        a = json.load(f)
    log(f"phase 14 (a) world 1 over {a['backend']} under torchrun: the DP step of the shipped "
        f"UNet at batch {B_TRAIN} (loss {a['loss']:.5f}, grad norm {a['grad']:.4f}) against the "
        f"plain step from a deep copy of one state: bit-equal {a['bit_equal']} (loss, grad norm, "
        f"parameters, Adam's moments); packed launches forward/backward plain {a['step_launches']['plain']}, "
        f"DP {a['step_launches']['dp']}; train_diffusion --data-parallel 1: {a['cli_steps']} steps in "
        f"{a['cli_s']:.1f} s, launches {a['cli_launches']}, checkpoint {a['cli_ckpt']} "
        f"({time.perf_counter() - t0:.1f} s with the launch)")
    if not (a["backend"] == "nccl" and a["bit_equal"] and a["step_launches"]["dp"] == [14, 14]
            and a["cli_steps"] == 5 and a["cli_launches"] == [70, 70] and a["cli_ckpt"]):
        raise AssertionError("phase 14 (a): the world-1 NCCL step or train_diffusion is wrong")

    # two NCCL ranks on the one card: refused, naming the ranks
    rc, text = _torchrun(2, "nccl-shared", work, timeout=120)
    # the two ranks print to one stream, their lines may run together
    refused = re.findall(r"REFUSED rank (\d): (ranks \d and \d would share one card)", text)
    log(f"phase 14 two NCCL ranks on one card: exit {rc}; refused on ranks "
        f"{sorted(r for r, _ in refused)}: {refused[0][1] if refused else None}")
    if rc == 0 or sorted(r for r, _ in refused) != ["0", "1"]:
        raise AssertionError(f"phase 14: two NCCL ranks on one card were not refused:\n{text[-3000:]}")
    return a


def _phase14_gloo(work: str) -> tuple[dict, dict]:
    """Phase 14 (b) -> (rank 0's results, rank 1's launches)."""
    # (b) two ranks sharing the card over gloo
    t0 = time.perf_counter()
    rc, text = _torchrun(2, "gloo2", work, timeout=600)
    if rc != 0:
        raise AssertionError(f"phase 14 (b): the gloo launch failed ({rc}):\n{text[-4000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"gloo2-rank{r}.json")) as f:
            ranks.append(json.load(f))
    b = ranks[0]
    failed = []
    for name in ("unet_dp", "unet_fsdp", "kl_dp", "vq_dp"):
        res = b[name]
        if "error" in res:
            log(f"phase 14 (b) {name}: FAILED under gloo on CUDA tensors: {res['error']}")
            failed.append(name)
            continue
        models = ("unet",) if name.startswith("unet") else ("vae", "disc")
        want = [14, 14, 0] if name.startswith("unet") else [0, 0, 2]
        launches = [ranks[r][name]["launches"] for r in range(2)]
        errs = "; ".join(f"{m} clipped gradient rel L2 {res[f'{m}_grad_rel_l2']:.3e}, Adam's "
                         f"second moment rel L2 {res[f'{m}_nu_rel_l2']:.3e}" for m in models)
        norms = ", ".join(f"{k} {v:.3e}" for k, v in res["norm_rel"].items())
        extra = "".join(f"; {k} max|diff|/max {res[f'{k}_rel_max']:.3e}"
                        for k in ("disc_stats", "codebook") if f"{k}_rel_max" in res)
        if "allreduce_ms" in res:
            extra += (f"; the gloo all-reduce of the step's {res['allreduce_mb']:.0f} MiB of "
                      f"gradients between two processes on one card {res['allreduce_ms']:.1f} ms "
                      "(the cost of gloo through the host, not a scaling figure)")
        log(f"phase 14 (b) {name}: 2 ranks x {B_RANK} rows over gloo on cuda:0 against the "
            f"one-process step of {B_TRAIN}: losses rel {max(res['loss_rel'].values()):.3e}, "
            f"gradient norms before the clip rel {norms} (tolerance {DP_LOSS_REL}); {errs} "
            f"(tolerances {GRAD_REL_L2} and {DP_NU_REL_L2}){extra}; ranks "
            f"bit-equal {res['ranks_equal']}; launches per rank (packed fwd, bwd, flash) "
            f"{launches}; the first step of a fresh trainer {res['ms']:.1f} ms on rank 0, "
            f"one-process {res['one_process_ms']:.1f} ms")
        held = (res["ranks_equal"] and launches == [want, want]
                and max(res["loss_rel"].values()) <= DP_LOSS_REL
                and len(res["norm_rel"]) == len(models)
                and max(res["norm_rel"].values()) <= DP_LOSS_REL
                and all(res[f"{m}_grad_rel_l2"] <= GRAD_REL_L2
                        and res[f"{m}_nu_rel_l2"] <= DP_NU_REL_L2 for m in models)
                and res.get("disc_stats_rel_max", 0.0) <= DP_STATS_REL
                and res.get("codebook_rel_max", 0.0) <= DP_STATS_REL)
        if not held:
            failed.append(name)
    log(f"phase 14 (b) in {time.perf_counter() - t0:.1f} s with the launch")
    if failed:
        raise AssertionError(f"phase 14 (b): {failed} outside their bars or failed")
    return ({k: v for k, v in b.items() if isinstance(v, dict)},
            {k: v["launches"] for k, v in ranks[1].items() if isinstance(v, dict) and "launches" in v})


def _phase14_sharding(torch, attn, work, vae_state, unet_state, grid) -> dict:
    """Phase 14 (c): sampling sharded in one process over a repeated card."""
    from image_diffusion_torch.core.config import ScheduleConfig, UNetArch, VAEArch
    from image_diffusion_torch.pipelines import DiffusionPipeline
    from image_diffusion_torch.scripts import sample_grid

    # (c) sharding in one process over a repeated card
    pipe = DiffusionPipeline(VAEArch(), vae_state, UNetArch(), unet_state, ScheduleConfig(),
                             "a,b,c")
    scales, devices = list(range(1, 10)), ["cuda:0", "cuda:0"]
    runs = {}
    for sampler, n_steps, ref in (("dpm", 20, None), ("ddpm", 1000, grid["ddpm"])):
        kw = dict(seed=0, sampler=sampler, num_inference_steps=n_steps if sampler == "dpm" else None)
        if ref is None:
            ref = pipe.sample(scales, **kw).cpu()
        attn.packed_attention.launches = attn.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = pipe.sample(scales, devices=devices, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs[sampler] = dict(seconds=secs, rel_l2=rel_l2(imgs, ref),
                             launches=[attn.packed_attention.launches, attn.flash_attention.launches],
                             finite=bool(torch.isfinite(imgs).all()), shape=list(imgs.shape))
    # each shard against sample_batch of its own 14 rows, unsharded: bit-equal
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_init = torch.randn((27, *pipe.latent_shape), generator=gen, device="cuda")
    labels = torch.arange(3).repeat(9)
    row_scales = torch.tensor(scales, dtype=torch.float32).repeat_interleave(3)
    sharded = pipe.sample(scales, seed=0, sampler="dpm", num_inference_steps=20, devices=devices)
    shard_equal = []
    for rows in (list(range(14)), list(range(14, 27)) + [0]):
        own = pipe.sample_batch(labels[rows], row_scales[rows], x_init[rows], sampler="dpm",
                                num_inference_steps=20)
        n = min(len(rows), 27 - rows[0])
        shard_equal.append(bool(torch.equal(own[:n], sharded[rows[0]:rows[0] + n])))
    runs["dpm"]["shards_equal_own_rows"] = shard_equal
    log(f"phase 14 (c) dpm-20 over {devices}: each shard's rows against sample_batch of those "
        f"14 rows unsharded, bit-equal {shard_equal}")
    if not all(shard_equal):
        raise AssertionError("phase 14 (c): a shard's rows differ from sampling those rows alone")
    busy_prof, _, wall = device_profile(torch, lambda: pipe.sample(
        scales, seed=0, sampler="dpm", num_inference_steps=20, devices=devices), iters=1)
    busy = sum(busy_prof.values())
    runs["dpm"].update(busy_ms=busy, wall_ms=wall)
    for sampler, r in runs.items():
        n = 20 if sampler == "dpm" else 1000
        log(f"phase 14 (c) {sampler}-{n} grid over {devices} in one process: {r['shape']} "
            f"(28 padded rows, 14 a shard) in {r['seconds']:.2f} s against phase 5's "
            f"{grid[sampler + '_s']:.2f} s unsharded; rel L2 to the unsharded grid "
            f"{r['rel_l2']:.3e} (tolerance {SHARD_GRID_REL}); {r['launches'][0]} packed "
            f"launches ({r['launches'][0] / (2 * n):.0f} a step per shard), "
            f"{r['launches'][1]} flash (one decode a shard)")
        if not (r["finite"] and r["rel_l2"] <= SHARD_GRID_REL
                and r["launches"] == [2 * 14 * n, 2]):
            raise AssertionError(f"phase 14 (c): the sharded {sampler} grid is wrong")
    log(f"phase 14 (c) dpm-20 sharded profile: device busy {busy:.3f} ms of a {wall:.3f} ms grid "
        f"(idle share {idle_share(busy, wall)}; phase 5 unsharded: {grid['dpm_busy']:.3f} of "
        f"{grid['dpm_wall']:.3f} ms, idle share {idle_share(grid['dpm_busy'], grid['dpm_wall'])})")
    bundle = os.path.join(work, "bundle.ckpt")
    pipe.to_checkpoint(bundle)
    ref = pipe.sample(scales, seed=0, sampler="dpm", num_inference_steps=20).cpu()
    del pipe
    attn.packed_attention.launches = 0
    args = sample_grid.parse_args([bundle, "--sampler", "dpm", "--seed", "0",
                                   "--data-parallel", "1"])
    _, _, imgs, secs = sample_grid.sample(args)
    cli_launches = attn.packed_attention.launches
    cli_err = rel_l2(imgs, ref)
    log(f"phase 14 (c) sample_grid --data-parallel 1 --sampler dpm: {tuple(imgs.shape)} in "
        f"{secs:.2f} s, {cli_launches} packed launches; against pipe.sample unsharded rel L2 "
        f"{cli_err:.3e}, bit-equal {bool(torch.equal(imgs, ref))}")
    if not (cli_err <= SHARD_GRID_REL and cli_launches == 14 * 20):
        raise AssertionError("phase 14 (c): sample_grid --data-parallel 1 disagrees")
    return dict(sharded=runs, sample_grid_dp1=dict(seconds=secs, rel_l2=cli_err,
                                                  launches=cli_launches))


def phase_e2e(torch, np, attn, tmp) -> dict:
    """Phase 15: the end-to-end quality tool in this process, KL and VQ, at
    full width and reduced depth (`E2E_ARGS`): the report's keys, finite
    numbers, the real data's grade, the bundle against the trainers' last
    checkpoints, and every kernel's launches against the path's count."""
    import math
    import shutil

    from image_diffusion_torch.compat.from_jax import unet_state_dict
    from image_diffusion_torch.core import checkpoint as ckpt
    from image_diffusion_torch.models.io import read_vae
    from image_diffusion_torch.pipelines import DiffusionPipeline
    from image_diffusion_torch.tools import e2e_synthetic_run as e2e

    kernels = (attn.packed_attention, attn.packed_attention_bwd, attn.flash_attention)
    runs = {}
    for bottleneck in ("kl", "vq"):
        out = os.path.join(tmp, f"e2e_{bottleneck}")
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = e2e.run(E2E_ARGS + ["--out", out, "--bottleneck", bottleneck])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = [k.launches for k in kernels]

        # what the path launches: 14 + 14 packed a UNet step, 14 packed a
        # sampler step (ddpm-1000 grading, dpm-20 FID calls); 2 flash a VAE
        # roundtrip (training, the final recon of 8, each dev batch) and 1 an
        # encode (latents, VQ's code counts) or a decode
        fid_calls = math.ceil(report["fid_images"] / 30)
        dev_batches = math.ceil(report["recon_fid_images"] / B_TRAIN)
        latent_batches = 3 * int(E2E_ARGS[E2E_ARGS.index("--n-per-class") + 1]) // B_TRAIN
        code_batches = report.get("vq_dev_images", 0) // B_TRAIN
        want = [14 * report["unet_steps"] + 14 * 1000 + 14 * 20 * fid_calls,
                14 * report["unet_steps"],
                2 * report["vae_steps"] + 2 + 2 * dev_batches + code_batches + latent_batches
                + 1 + fid_calls]

        # the bundle against the trainers' last checkpoints, fp32 bit for bit
        pipe = DiffusionPipeline.from_checkpoint(os.path.join(out, "e2e_bundle.ckpt"))
        vae_state = read_vae(e2e.latest_ckpt(out, "e2e_vae", "vae"))[1]
        trees, _ = ckpt.load_checkpoint(e2e.latest_ckpt(out, "e2e_unet", "unet"))
        unet = unet_state_dict(trees["unet"])
        bundle_equal = (set(pipe.unet_state) == set(unet) and set(pipe.vae_state) == set(vae_state)
                        and all(torch.equal(pipe.unet_state[k], v) for k, v in unet.items())
                        and all(torch.equal(pipe.vae_state[k], v) for k, v in vae_state.items()))
        del pipe, vae_state, trees, unet
        keys = E2E_KEYS + (E2E_VQ_KEYS if bottleneck == "vq" else [])
        numbers = [v for v in report.values() if isinstance(v, (int, float))]
        numbers += list(report["cond_accuracy_per_class"].values())
        finite = bool(np.isfinite(numbers).all())
        disk_gb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out)
                      for f in fs) / 1e9
        runs[bottleneck] = dict(seconds=secs, report=report, launches=launches,
                                launches_expected=want, bundle_equal=bundle_equal,
                                disk_gb=disk_gb)
        log(f"phase 15 e2e_synthetic_run --bottleneck {bottleneck} {' '.join(E2E_ARGS)}: "
            f"{secs:.1f} s in this process (VAE {report['vae_steps']} steps in "
            f"{report['vae_train_s']} s, UNet {report['unet_steps']} steps in "
            f"{report['unet_train_s']} s, generative FID at {report['fid_img_per_sec']} img/s); "
            f"real data graded {report['real_classifier_acc']}; vae_final_recon "
            f"{report['vae_final_recon']:.5f}; recon FID {report['recon_fid']} over "
            f"{report['recon_fid_images']} dev images; generative FID {report['generative_fid']} "
            f"over {report['fid_images']} ({report['fid_sampler']})"
            + (f"; codebook utilization {report['vq_codebook_utilization']}, dev perplexity "
               f"{report['vq_dev_perplexity']} over {report['vq_dev_images']} images"
               if bottleneck == "vq" else "")
            + f"; cond_accuracy {report['cond_accuracy']:.3f} "
            f"{report['cond_accuracy_per_class']} (not held at this depth); keys are the JAX "
            f"tool's: {set(report) == set(keys)}; finite: {finite}; the bundle equals the last "
            f"checkpoints bit for bit: {bundle_equal}; {disk_gb:.2f} GB written")
        log(f"phase 15 {bottleneck} launches: packed forward {launches[0]} (expected {want[0]}: "
            f"14 a UNet step, 14 a sampler step), backward {launches[1]} (expected {want[1]}: 14 "
            f"a UNet step), flash {launches[2]} (expected {want[2]}: 2 a stage-1 step and a "
            f"reconstruction batch, 1 an encode batch and a decode)")
        if not (set(report) == set(keys) and finite and report["real_classifier_acc"] >= 0.95
                and bundle_equal):
            raise AssertionError(f"phase 15 {bottleneck}: the report's keys, a non-finite number, "
                                 "the real data's grade or the bundle is wrong")
        if launches != want or min(launches) == 0:
            raise AssertionError(f"phase 15 {bottleneck}: launches {launches}, expected {want}")
        shutil.rmtree(out)
        torch.cuda.empty_cache()
    log(f"phase 15 in {sum(r['seconds'] for r in runs.values()):.1f} s")
    return runs


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--rank-worker"]:  # one rank of phase 14's launches
        return _rank_worker(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from image_diffusion_torch.ops import attention as attn
    except ImportError as e:
        print(f"chip_smoke: the image_diffusion_torch package is not here: {e}", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from image_diffusion_torch import ops
    from image_diffusion_torch.core.config import ScheduleConfig, UNetArch, VAEArch
    from image_diffusion_torch.models import build_unet, build_vae
    from image_diffusion_torch.ops.build import BUILD_OUTPUT, build, nvcc
    from image_diffusion_torch.pipelines import DiffusionPipeline

    # phase 1: the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    try:
        triton_version = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton_version = "absent"
    clock_hz = sm_clock_hz()
    log(f"phase 1 card: {name}; {smi}; max SM clock {clock_hz / 1e6:.0f} MHz; python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, triton {triton_version}, devices {torch.cuda.device_count()}")
    host_packages = {}
    for package in ("matplotlib", "PIL", "tqdm"):  # the CLIs' figures, image resizing, bars
        try:
            host_packages[package] = __import__(package).__version__
        except ImportError:
            host_packages[package] = "absent"
    try:  # CLIP labels' processor (not imported: the port needs it only there)
        host_packages["transformers"] = metadata.version("transformers")
    except metadata.PackageNotFoundError:
        host_packages["transformers"] = "absent"
    log("phase 1 host packages: " + ", ".join(f"{k} {v}" for k, v in host_packages.items()))

    # phase 2: build every kernel of the path
    nvcc_version = subprocess.run([nvcc(), "--version"], capture_output=True, text=True,
                                  check=True, timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    build(KERNEL_SOURCES)
    log(f"phase 2 build: packed_attention.cu, packed_attention_bwd.cu and flash_attention.cu "
        f"(all with packed_common.cuh) in "
        f"{time.perf_counter() - t0:.1f} s ({nvcc_version})")
    for source in KERNEL_SOURCES:
        if source not in BUILD_OUTPUT:
            log(f"phase 2 ptxas {source}.cu: registers and spills not measured in this run (the "
                f"library of this source and these flags was there already; remove "
                f"build/torch_kernels/ to build it again)")
            continue
        entries, spilled = ptxas_summary(BUILD_OUTPUT[source])
        log(f"phase 2 ptxas {source}.cu: " + "; ".join(entries))
        if not entries or spilled:
            raise AssertionError(f"{source}.cu: " + (f"{spilled} bytes of register spills"
                                                     if entries else "no ptxas report to read"))

    # phase 3: kernels against their plain versions
    sites = phase_kernels(torch, F, attn, clock_hz, B_GRID)
    serve_sites = phase_kernels(torch, F, attn, clock_hz, 2 * SERVE_BATCH)
    shard_sites = phase_kernels(torch, F, attn, clock_hz, B_SHARD)
    fid_sites = phase_kernels(torch, F, attn, clock_hz, B_FID)
    bwd_sites = phase_bwd_kernels(torch, F, attn, clock_hz, B_TRAIN)
    rank_bwd_sites = phase_bwd_kernels(torch, F, attn, clock_hz, B_RANK)
    flash_batches = phase_flash_kernel(torch, F, attn, clock_hz)

    # phase 4: full-width UNet forward on the card, two rows against the CPU
    gen = torch.Generator().manual_seed(0)
    unet_state = build_unet(UNetArch(), torch.float32, "cpu", gen).state_dict()
    vae_state = build_vae(VAEArch(), torch.float32, "cpu", gen).state_dict()
    unet = build_unet(UNetArch(), torch.bfloat16, "cuda")
    unet.load_state_dict(unet_state)
    x = torch.randn(B_GRID, 32, 32, 3, generator=gen)
    t = torch.randint(0, 1000, (B_GRID,), generator=gen)
    ctx = torch.randint(0, 3, (B_GRID,), generator=gen)
    mask = torch.cat([torch.ones(B_GRID // 2, 1), torch.zeros(B_GRID - B_GRID // 2, 1)])
    args = [a.cuda() for a in (x, t, ctx, mask)]
    with torch.inference_mode():
        attn.packed_attention.launches = 0
        with ops.record_sites() as log_sites:
            out = unet(*args)
        torch.cuda.synchronize()
        launches = attn.packed_attention.launches
        fwd_ms = cuda_ms(lambda: unet(*args), iters=10)
        prof_ms, prof_kernels, prof_wall = device_profile(torch, lambda: unet(*args))
        rows = [0, B_GRID - 1]
        unet_cpu = build_unet(UNetArch(), torch.bfloat16, "cpu")
        unet_cpu.load_state_dict(unet_state)
        t1 = time.perf_counter()
        ref = unet_cpu(*(a[rows] for a in (x, t, ctx, mask)))
        cpu_s = time.perf_counter() - t1
    err = rel_l2(out[rows], ref)
    kernel_sites = sum(1 for s in log_sites if s[-1] == "kernel")
    log(f"phase 4 unet: out {tuple(out.shape)} {out.dtype}; {launches} kernel launches, "
        f"{kernel_sites}/{len(log_sites)} sites on the kernel route; {fwd_ms:.3f} ms/forward; "
        f"rows {rows} vs CPU rel L2 {err:.3e} (tolerance {UNET_REL_L2}, CPU {cpu_s:.1f} s)")
    if launches != 14 or kernel_sites != 14:
        raise AssertionError(f"expected 14 kernel launches per UNet forward, got {launches}")
    if not (torch.isfinite(out).all() and err <= UNET_REL_L2):
        raise AssertionError("full-width UNet on the card disagrees with the CPU")
    busy_ms = sum(prof_ms.values())
    attn_ms = sum(v for k, v in prof_ms.items() if "packed_attention" in k)
    top = sorted(prof_ms.items(), key=lambda kv: -kv[1])[:6]
    log(f"phase 4 profile: device busy {busy_ms:.3f} ms of a {prof_wall:.3f} ms forward "
        f"(idle share {idle_share(busy_ms, prof_wall)}); {prof_kernels:.0f} kernels per forward; "
        f"packed_attention {attn_ms:.3f} ms; top: "
        + "; ".join(f"{k[:70]} {v:.3f} ms" for k, v in top))
    del unet, unet_cpu, out

    # phase 5: the main path, from a bundle
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bundle.ckpt")
        DiffusionPipeline(VAEArch(), vae_state, UNetArch(), unet_state, ScheduleConfig(),
                          "a,b,c", device="cpu", dtype=torch.float32).to_checkpoint(path)
        t1 = time.perf_counter()
        pipe = DiffusionPipeline.from_checkpoint(path)
        load_s = time.perf_counter() - t1
    log(f"phase 5 bundle: written and loaded on {pipe.device} in {load_s:.1f} s")

    scales = list(range(1, 10))
    attn.packed_attention.launches = attn.flash_attention.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    imgs = pipe.sample(scales, seed=0, sampler="ddpm")
    torch.cuda.synchronize()
    ddpm_s = time.perf_counter() - t1
    main_launches = attn.packed_attention.launches
    grid_flash = attn.flash_attention.launches
    n_imgs = imgs.shape[0]
    log(f"phase 5 ddpm-1000 grid: {tuple(imgs.shape)} {imgs.dtype} in {ddpm_s:.2f} s "
        f"({n_imgs / ddpm_s:.3f} img/s); {main_launches} packed kernel launches, {grid_flash} "
        f"flash kernel launch (the decode); range [{float(imgs.min()):.3f}, {float(imgs.max()):.3f}]")
    if imgs.shape != (27, 128, 128, 3) or not torch.isfinite(imgs).all():
        raise AssertionError("ddpm grid: wrong shape or non-finite images")
    if main_launches != 14 * 1000 or grid_flash != 1:
        raise AssertionError(f"ddpm grid: {main_launches} packed and {grid_flash} flash launches, "
                             f"expected 14 x 1000 and 1")

    attn.packed_attention.launches = attn.flash_attention.launches = 0
    t1 = time.perf_counter()
    u8 = pipe.sample(scales, seed=0, sampler="dpm", num_inference_steps=20, output="uint8")
    torch.cuda.synchronize()
    dpm_s = time.perf_counter() - t1
    dpm_launches = attn.packed_attention.launches
    dpm_flash = attn.flash_attention.launches
    log(f"phase 5 dpm-20 grid: {tuple(u8.shape)} {u8.dtype} in {dpm_s:.3f} s "
        f"({n_imgs / dpm_s:.3f} img/s); {dpm_launches} packed kernel launches, {dpm_flash} flash "
        f"kernel launch; pixel mean {float(u8.float().mean()):.2f}")
    if (u8.shape != (27, 128, 128, 3) or u8.dtype != torch.uint8 or dpm_launches != 14 * 20
            or dpm_flash != 1):
        raise AssertionError("dpm grid: wrong shape, dtype or launch count")
    dpm_prof, dpm_kernels, dpm_wall = device_profile(torch, lambda: pipe.sample(
        scales, seed=0, sampler="dpm", num_inference_steps=20, output="uint8"), iters=1)
    dpm_busy = sum(dpm_prof.values())
    grid = dict(ddpm=imgs.cpu(), ddpm_s=ddpm_s, dpm_s=dpm_s, dpm_busy=dpm_busy, dpm_wall=dpm_wall)
    log(f"phase 5 dpm-20 profile: device busy {dpm_busy:.3f} ms of a {dpm_wall:.3f} ms grid "
        f"(idle share {idle_share(dpm_busy, dpm_wall)}); {dpm_kernels:.0f} kernels")

    # the same pipeline code on a tiny config, card vs CPU (plain versions)
    tiny_u = UNetArch(channels=(64, 128, 128), mid_channels=(128, 128), time_dim=64,
                      num_res_layers=1, num_heads=4, num_groups=8)
    tiny_v = VAEArch(channels=(32, 64), enc_num_res_blocks=1, dec_num_res_blocks=1,
                     init_resolution=64, num_groups=8)
    tg = torch.Generator().manual_seed(1)
    tu = build_unet(tiny_u, torch.float32, "cpu", tg).state_dict()
    tv = build_vae(tiny_v, torch.float32, "cpu", tg).state_dict()
    x_tiny = torch.randn(6, 32, 32, 3, generator=tg)
    outs = []
    for dev in ("cuda", "cpu"):
        tp = DiffusionPipeline(tiny_v, tv, tiny_u, tu, ScheduleConfig(), "a,b,c", device=dev)
        outs.append(tp.sample_batch([0, 1, 2, 0, 1, 2], [1, 1, 1, 3, 3, 3], x_tiny,
                                    sampler="dpm", num_inference_steps=4))
    tiny_err = rel_l2(outs[0], outs[1])
    log(f"phase 5 tiny pipeline card vs CPU: rel L2 {tiny_err:.3e} (tolerance {TINY_REL_L2})")
    if not tiny_err <= TINY_REL_L2:
        raise AssertionError("tiny pipeline on the card disagrees with the CPU")
    del pipe, imgs, u8

    # phase 6: training on the card
    train = phase_train(torch, np, attn, unet_state)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # phase 7: stage-1 training on the card
        vae_train = phase_vae_train(torch, np, attn, tmp)
        torch.cuda.empty_cache()

        # phase 8: the two stages joined through the CLIs
        clis = phase_clis(torch, np, attn, vae_train["ckpt"], vae_train["images"], tmp)
        torch.cuda.empty_cache()

        # phase 9: stage-1 VQ training on the card
        vq = phase_vq_train(torch, np, attn, tmp)
        torch.cuda.empty_cache()

        # phase 10: remat, the trainer's preview and --debug-nans
        rp = phase_remat_preview(torch, np, attn, tmp, vae_train["ckpt"], clis)

        # phase 11: FID
        fid = phase_fid(torch, np, attn, tmp, vae_train, clis)
        torch.cuda.empty_cache()

        # phase 12: serving
        served = phase_serve(torch, np, attn, tmp, vae_state, unet_state)
        torch.cuda.empty_cache()

        # phase 13: CLIP zero-shot labels
        clip = phase_clip(torch, np, attn, tmp, vae_train)
        torch.cuda.empty_cache()

        # phase 14: data parallelism, FSDP and sharded sampling on the one card
        par = phase_parallel(torch, np, attn, tmp, vae_state, unet_state, grid)
        torch.cuda.empty_cache()

        # phase 15: the end-to-end quality run
        e2e = phase_e2e(torch, np, attn, tmp)

    per_forward = {k: 2 * sum(s[k] for s in sites)
                   for k in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                             "bound_ms", "exp_ms")}
    bound_ops = 2 * sum(s["bound_ms"] for s in sites if s["bound_by"] == "operations")
    per_backward = {k: 2 * sum(s[k] for s in bwd_sites)
                    for k in ("ms", "device_ms", "dq_device_ms", "dkdv_device_ms", "alone_ms",
                              "plain_ms", "library_ms", "library_device_ms", "bound_ms", "exp_ms")}
    bwd_bound_ops = 2 * sum(s["bound_ms"] for s in bwd_sites if s["bound_by"] == "operations")
    record = {"kernels": [{
        "name": "packed_attention",
        "route": "cuda",
        "source": "image_diffusion_torch/ops/csrc/packed_attention.cu",
        "replaces": "image_diffusion_tpu/ops/pallas/attention.py:152",
        "launches": main_launches,
        "launches_by_path": {"phase 5 ddpm-1000 grid": main_launches,
                             "phase 5 dpm-20 grid": dpm_launches,
                             "phase 6 train_diffusion": train["launches"]["forward"],
                             "phase 8 train_diffusion": clis["train_launches"][0],
                             "phase 8 sample_grid ddpm": clis["grids"]["ddpm"]["launches"][0],
                             "phase 8 sample_grid dpm": clis["grids"]["dpm"]["launches"][0],
                             **{f"phase 10 remat {k} step": r["launches"][0]
                                for k, r in rp["remat"].items()},
                             "phase 10 train_diffusion --remat dots": rp["cli_launches"][0],
                             "phase 10 preview dpm-20": rp["preview_launches"][0],
                             "phase 11 eval_fid ddim-50": fid["eval_fid_launches"][0],
                             "phase 12 served dpm-20 batch": served["launches"][0],
                             "phase 12 served ddim-50 batch, eta 1": served["ddim_launches"][0],
                             "phase 14 world-1 NCCL step": par["nccl1"]["step_launches"]["dp"][0],
                             "phase 14 train_diffusion under torchrun, world 1":
                                 par["nccl1"]["cli_launches"][0],
                             **{f"phase 14 {k} step, per rank": v["launches"][0]
                                for k, v in par["gloo2"].items() if k.startswith("unet")},
                             "phase 14 ddpm-1000 grid over 2 shards":
                                 par["sharded"]["ddpm"]["launches"][0],
                             "phase 14 dpm-20 grid over 2 shards":
                                 par["sharded"]["dpm"]["launches"][0],
                             "phase 14 sample_grid --data-parallel 1 dpm":
                                 par["sample_grid_dp1"]["launches"],
                             **{f"phase 15 e2e_synthetic_run {k}": r["launches"][0]
                                for k, r in e2e.items()}},
        "max_abs_err": max(s["max_abs_err"] for s in sites + serve_sites + shard_sites
                           + fid_sites),
        **per_forward,
        "bound_by": "operations" if bound_ops > per_forward["bound_ms"] / 2 else "bytes",
        "per": "one UNet forward at batch 54: 14 sites, two of each shape in sites; "
               "serve_per_forward: one served UNet call at 16 rows (serve_sites); "
               "shard_per_forward: one UNet call of a phase 14 grid shard at 28 rows (shard_sites); "
               "fid_per_forward: one UNet call of phase 15's generative FID at 60 rows (fid_sites)",
        "sites": sites,
        "serve_sites": serve_sites,
        "shard_sites": shard_sites,
        "fid_sites": fid_sites,
        **{f"{name}_per_forward": {k: 2 * sum(s[k] for s in rows)
                                   for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                             "library_device_ms", "bound_ms", "exp_ms")}
           for name, rows in (("serve", serve_sites), ("shard", shard_sites),
                              ("fid", fid_sites))},
    }, {
        "name": "packed_attention_bwd",
        "route": "cuda",
        "source": "image_diffusion_torch/ops/csrc/packed_attention_bwd.cu",
        "replaces": "image_diffusion_tpu/ops/pallas/attention.py:288",
        "launches": train["launches"]["backward"],
        "launches_by_path": {"phase 6 train_diffusion": train["launches"]["backward"],
                             "phase 8 train_diffusion": clis["train_launches"][1],
                             **{f"phase 10 remat {k} step": r["launches"][1]
                                for k, r in rp["remat"].items()},
                             "phase 10 train_diffusion --remat dots": rp["cli_launches"][1],
                             "phase 14 world-1 NCCL step": par["nccl1"]["step_launches"]["dp"][1],
                             "phase 14 train_diffusion under torchrun, world 1":
                                 par["nccl1"]["cli_launches"][1],
                             **{f"phase 14 {k} step, per rank": v["launches"][1]
                                for k, v in par["gloo2"].items() if k.startswith("unet")},
                             **{f"phase 15 e2e_synthetic_run {k}": r["launches"][1]
                                for k, r in e2e.items()}},
        "max_abs_err": max(s["max_abs_err"] for s in bwd_sites + rank_bwd_sites),
        **per_backward,
        "bound_by": "operations" if bwd_bound_ops > per_backward["bound_ms"] / 2 else "bytes",
        "per": "one UNet backward at batch 48: 14 sites, two of each shape in sites; ms with "
               "the forward's saved output and row sums, as the operator's gradient calls it; alone_ms "
               "when the wrapper launches the forward first; rank_per_backward: one UNet backward "
               "of a phase 14 rank at 24 rows (rank_sites)",
        "sites": bwd_sites,
        "rank_sites": rank_bwd_sites,
        "rank_per_backward": {k: 2 * sum(s[k] for s in rank_bwd_sites)
                              for k in ("ms", "device_ms", "dq_device_ms", "dkdv_device_ms",
                                        "alone_ms", "plain_ms", "library_ms", "library_device_ms",
                                        "bound_ms", "exp_ms")},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "image_diffusion_torch/ops/csrc/flash_attention.cu",
        "replaces": "image_diffusion_tpu/ops/pallas/attention.py:40",
        "launches": vae_train["launches"],
        "launches_by_path": {"phase 5 ddpm-1000 grid": grid_flash, "phase 5 dpm-20 grid": dpm_flash,
                             "phase 7 train_vae": vae_train["launches"],
                             "phase 9 train_vae (vq)": vq["launches"],
                             "phase 9 vq step, grad_accum 1": vq["accum"]["accum_1"]["launches_inactive"],
                             "phase 9 vq step, grad_accum 2, discriminator inactive":
                                 vq["accum"]["accum_2"]["launches_inactive"],
                             "phase 9 vq step, grad_accum 2, discriminator active":
                                 vq["accum"]["accum_2"]["launches_active"],
                             "phase 8 prepare_dataset": clis["prep_flash"],
                             "phase 8 sample_grid ddpm": clis["grids"]["ddpm"]["launches"][1],
                             "phase 8 sample_grid dpm": clis["grids"]["dpm"]["launches"][1],
                             "phase 10 preview dpm-20": rp["preview_launches"][1],
                             "phase 11 train_vae --fid-weights": fid["vae_flash"],
                             "phase 11 eval_fid ddim-50": fid["eval_fid_launches"][1],
                             "phase 12 served dpm-20 batch": served["launches"][1],
                             "phase 12 served ddim-50 batch, eta 1": served["ddim_launches"][1],
                             **{f"phase 14 {k} stage-1 step, per rank": v["launches"][2]
                                for k, v in par["gloo2"].items() if not k.startswith("unet")},
                             "phase 14 ddpm-1000 grid over 2 shards":
                                 par["sharded"]["ddpm"]["launches"][1],
                             "phase 14 dpm-20 grid over 2 shards":
                                 par["sharded"]["dpm"]["launches"][1],
                             **{f"phase 15 e2e_synthetic_run {k}": r["launches"][2]
                                for k, r in e2e.items()}},
        "max_abs_err": max(b["max_abs_err"] for b in flash_batches),
        **{k: next(b for b in flash_batches if b["B"] == B_TRAIN)[k]
           for k in ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                     "bound_by", "exp_ms", "einsum_backward_device_ms")},
        "per": "one call at the VAE's attention site, B=48 (the training batch), H=1, N=1024, D=384; "
               "einsum_backward_device_ms: one FlashAttention backward (autograd of the einsum path)",
        "batches": flash_batches,
    }], "unet_forward_ms": fwd_ms, "unet_forward_device_busy_ms": busy_ms,
        "ddpm_grid_s": ddpm_s, "dpm20_grid_s": dpm_s, "dpm20_grid_device_busy_ms": dpm_busy,
        "dpm20_launches": dpm_launches, "train_step_ms": train["step_ms"],
        "train_step_device_busy_ms": train["busy_ms"], "train_step_profiled_ms": train["wall_ms"],
        "train_launches": train["launches"], "train_grad_rel_l2": train["grad_rel_l2"],
        "train_qkv_grad_rel_l2": train["qkv_grad_rel_l2"], "grid_flash_launches": grid_flash,
        "vae_train_step_ms": vae_train["step_ms"], "vae_train_step_device_busy_ms": vae_train["busy_ms"],
        "vae_train_step_profiled_ms": vae_train["wall_ms"], "vae_train_flash_launches": vae_train["launches"],
        "vae_train_flash_device_ms": vae_train["flash_device_ms"],
        "vae_train_grad_rel_l2": vae_train["grad_rel_l2"], "host_packages": host_packages,
        "stage1_steps_kl": vae_train["steps"], "stage1_steps_vq": vq["steps"],
        "prepare_dataset_s": clis["prep_s"], "prepare_dataset_encode_s": clis["encode_s"],
        "prepare_dataset_images": clis["images"], "prepare_dataset_rel_l2": clis["encode_rel_l2"],
        "sample_grid_ddpm_s": clis["grids"]["ddpm"]["seconds"],
        "sample_grid_dpm_s": clis["grids"]["dpm"]["seconds"],
        "phase8_pipe_sample_ddpm_s": clis["grids"]["ddpm"]["pipe_seconds"],
        "phase8_pipe_sample_dpm_s": clis["grids"]["dpm"]["pipe_seconds"],
        "vq_train_step_ms": vq["step_ms"], "vq_train_step_device_busy_ms": vq["busy_ms"],
        "vq_train_step_profiled_ms": vq["wall_ms"], "vq_train_flash_launches": vq["launches"],
        "vq_train_flash_device_ms": vq["flash_device_ms"], "vq_train_grad_rel_l2": vq["grad_rel_l2"],
        "vq_codebook_lookup_device_ms": vq["lookup_ms"],
        "vq_codebook_lookup_update_device_ms": vq["codebook_ms"], "vq_ema_rel_err": vq["ema_rel_err"],
        "vq_accum": vq["accum"], "vq_accum_grad_rel_l2": vq["accum_grad_rel_l2"],
        "vq_accum_codebook_rel_err": vq["accum_codebook_rel_err"],
        "vq_accum_code_flips": vq["accum_code_flips"],
        "vq_accum_codebook_rel_err_own_codes": vq["accum_codebook_rel_err_own_codes"],
        "remat": rp["remat"], "remat_grad_floor": rp["remat_grad_floor"],
        "remat_cli_step_ms": rp["cli_step_ms"], "preview_s": rp["preview_s"],
        "debug_nans": rp["debug_nans"], **{k: v for k, v in fid.items() if "launches" not in k},
        "serve": {k: v for k, v in served.items() if "launches" not in k}, **clip,
        "parallel": par, "e2e": {k: {n: v for n, v in r.items() if n != "launches"}
                                 for k, r in e2e.items()}}
    log(json.dumps(record))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
