#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one status line each; any failure exits non-zero:
  1. the card: name and power limit (nvidia-smi); python, torch, CUDA and
     triton versions; whether matplotlib, PIL and tqdm import;
  2. build every kernel of the sampling and both training paths from the
     sources in this checkout (nvcc, sm_90a, one process per source, all
     started together), with the build seconds, nvcc's release and ptxas'
     registers per kernel; a kernel that spills registers fails the phase;
  3. the forward kernel and the row sums it hands to the backward against
     their plain PyTorch version at the shapes the sampling grid gives it
     (batch 54, bf16), with times of the kernel, the plain version and one
     PyTorch library call, the card's bound and the time its
     special-function units need for the exponentials;
  3b. the backward kernels against their plain version at the same site
     shapes at the training batch (48, bf16, random dO), per operand, both
     called alone (the wrapper launches the forward first) and through
     `PackedAttention` with the forward's saved output and row sums, which
     is what training runs, with the same times (library: SDPA's backward
     through autograd);
  3c. the flash kernel against its plain version at the VAE's attention
     site (one head, N 1024, D 384) at batches 27 (the grid's decode), 24
     (training's micro-batch at grad_accum 2), 48 (training) and 64
     (prepare_dataset's batch), with the same times (library: SDPA, its backend named),
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
     version; 25 steps of `configs/vae-kl-32x32.yaml` (batch 48 of
     128x128x3 uint8, bf16 compute on fp32 parameters, random LPIPS
     weights from a file; only paths, epochs: 1, log_interval: 5 and
     disc_start: 10 overridden) through `image_diffusion_torch.scripts
     .train_vae` on synthetic images with a dev set whose last batch is
     padded, with losses and imgs/s at each flush, ms/step, and flash
     launches per step; a resume from its checkpoint; a torch.profiler
     trace of 3 train steps;
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
     CPU, with the share of tokens whose code differs between them; (b)
     the codebook lookup on the card's fp32 encoder output for batch 48
     against float64 distances; (c) one EMA update at batch 48 against its
     float64 statement, and the codebook's device time; (d) 25 steps
     through `train_vae` as in phase 7, the perplexity at each flush and
     on the dev set, a resume that restores the codebook, a profile; (e)
     one step at grad_accum 2 against grad_accum 1 from one state and
     batch: gradient, codebook, peak memory, ms/step and flash launches.
Then a JSON line of kernel records, the nvidia-smi line, and as the last
line `{"ok": true, "device": {...}}`.  Exits non-zero, printing no result,
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
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
# phase 8: a few rows of prepare_dataset's latents (bf16 on the card, stored
# as fp16) against the same rows encoded on the CPU at fp32: relative L2,
# of the same kind as UNET_REL_L2 through the encoder's ~40 layers
ENCODE_REL_L2 = 5e-2
# csrc/<name>.cu of every kernel the paths run
KERNEL_SOURCES = ["packed_attention", "packed_attention_bwd", "flash_attention"]


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_summary(text: str) -> tuple[list[str], int]:
    """(["kernel<template args> registers, spill stores/loads", ...] for each
    entry function in ptxas' verbose output, the spill bytes of all of them
    together)."""
    import re

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
    of calls it leaves out the gaps the host leaves between short kernels."""
    fn()
    return sum(device_profile(torch, fn, iters=5)[0].values())


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


def phase_kernels(torch, F, attn, clock_hz):
    """Phase 3: packed attention, and the row sums it hands to the
    backward, vs its plain version and SDPA per site."""
    sites = []
    for N, C, h in SITES:
        d = C // h
        g = torch.Generator(device="cuda").manual_seed(1000 * N + C)
        q, k, v = (torch.randn(B_GRID, N, C, generator=g, device="cuda").to(torch.bfloat16)
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
        heads = [t.view(B_GRID, N, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
        with torch.no_grad():
            ms = cuda_ms(lambda: attn.packed_attention(q, k, v, h), iters=20)
            dev_ms = device_ms(torch, lambda: attn.packed_attention(q, k, v, h))
        plain_ms = cuda_ms(lambda: attn.reference_packed_attention(q, k, v, h), iters=5)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads), iters=20)
        lib_dev_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(*heads))
        flops, nbytes = 4 * B_GRID * N * N * C, 4 * B_GRID * N * C * 2
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        site = dict(N=N, C=C, d=d, max_abs_err=max_abs, tol_ratio=ratio, row_sum_rel_err=sum_rel,
                    ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                    bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
                    exp_ms=exp_ms(B_GRID * h * N * N, clock_hz))  # one exp2 per score
        sites.append(site)
        log(f"phase 3 kernel  N={N:5d} C={C} d={d}: max|err|={max_abs:.3e} "
            f"(tolerance ratio {ratio:.3f}), row sums max rel err {sum_rel:.3e} (tolerance "
            f"{ROW_SUM_REL}); kernel {ms:.4f} ms ({dev_ms:.4f} ms on the device), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms on the device), "
            f"bound {bound_ms:.4f} ms ({site['bound_by']}), "
            f"exponentials {site['exp_ms']:.4f} ms")
        if not (ratio <= 1.0 and sum_rel <= ROW_SUM_REL):
            raise AssertionError(f"kernel disagrees with its plain version at N={N} C={C}")
    return sites


def phase_bwd_kernels(torch, F, attn, clock_hz):
    """Phase 3b: the backward kernels vs their plain version and SDPA's
    backward per site, at the training batch: called alone, and through
    `PackedAttention` with the forward's saved output and row sums."""
    sites = []
    for N, C, h in SITES:
        d = C // h
        g = torch.Generator(device="cuda").manual_seed(2000 * N + C)
        q, k, v, do = (torch.randn(B_TRAIN, N, C, generator=g, device="cuda").to(torch.bfloat16)
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
        heads = [t.view(B_TRAIN, N, h, d).transpose(1, 2).contiguous().requires_grad_()
                 for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*heads)
        do_heads = do.view(B_TRAIN, N, h, d).transpose(1, 2).contiguous()
        # what `PackedAttention.backward` calls: the kernels on the saved statistics
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
        flops, nbytes = 10 * B_TRAIN * N * N * C, 7 * B_TRAIN * N * C * 2
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
        site = dict(N=N, C=C, d=d, max_abs_err=max(errs.values()), max_abs_err_by_operand=errs,
                    tol_ratio_by_operand=ratios, rel_max_by_operand=rels, ms=ms, device_ms=dev_ms,
                    dq_device_ms=dev_ms - dkdv_dev_ms, dkdv_device_ms=dkdv_dev_ms,
                    alone_ms=alone_ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                    bound_by="operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES else "bytes",
                    # the dq and the dk/dv kernel each take one exp2 per score
                    exp_ms=exp_ms(2 * B_TRAIN * h * N * N, clock_hz))
        sites.append(site)
        log(f"phase 3b bwd kernel N={N:5d} C={C} d={d}: max|err| "
            + " ".join(f"{n} {errs[n]:.3e}" for n in errs) + "; tolerance ratio "
            + " ".join(f"{n} {ratios[n]:.3f}" for n in ratios) + "; max|err|/max|plain| "
            + " ".join(f"{n} {rels[n]:.3e}" for n in rels) + f" (tolerance {BWD_REL_MAX})"
            + f"; alone equals through PackedAttention bit for bit: {same}; kernel {ms:.4f} ms "
            f"with the forward's statistics ({dev_ms:.4f} ms on the device: dq "
            f"{dev_ms - dkdv_dev_ms:.4f}, dk/dv {dkdv_dev_ms:.4f}), {alone_ms:.4f} ms "
            f"alone, plain {plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms on the "
            f"device), bound {bound_ms:.4f} ms ({site['bound_by']}), "
            f"exponentials {site['exp_ms']:.4f} ms")
        if launched != (1, 1):
            raise AssertionError(f"PackedAttention launched {launched} forward and backward "
                                 f"kernels at N={N} C={C}, expected one each")
        if not (same and max(ratios.values()) <= 1.0 and max(rels.values()) < BWD_REL_MAX):
            raise AssertionError(f"backward kernel disagrees with its plain version at N={N} C={C}")
    return sites


def phase_flash_kernel(torch, F, attn, clock_hz):
    """Phase 3c: the flash kernel against its plain version at the VAE's
    attention site (one head, N = 32*32, D = 384) at the grid's decode batch,
    the training batch and its half and prepare_dataset's batch, with times, and the
    gradient through
    `FlashAttention` against autograd of the plain version."""
    from torch.nn.attention import SDPBackend

    N, D = 1024, 384
    scale = 1.0 / D ** 0.5
    batches = []
    for B in (B_GRID // 2, B_TRAIN // 2, B_TRAIN, B_ENCODE):
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
        with open(CONFIG) as f:
            text = _override(f.read(), {
                "train_set": os.path.join(tmp, "latents.npy"),
                "train_labels": os.path.join(tmp, "labels.npy"),
                "checkpoints_dir": os.path.join(tmp, "ckpt"), "logs_dir": os.path.join(tmp, "logs"),
                "epochs": 1, "log_interval": 5})
        config = os.path.join(tmp, "config.yaml")
        with open(config, "w") as f:
            f.write(text)
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

    # 2. the trainer through its entry point, 25 steps of the shipped config
    rng = np.random.default_rng(0)
    n_train, n_dev = VAE_TRAIN_STEPS * B_TRAIN, 2 * B_TRAIN + 4  # the dev tail: 4 of 48
    np.save(os.path.join(tmp, "train.npy"), rng.integers(0, 256, (n_train, 128, 128, 3), dtype=np.uint8))
    np.save(os.path.join(tmp, "dev.npy"), rng.integers(0, 256, (n_dev, 128, 128, 3), dtype=np.uint8))
    run = _stage1_cli_run(torch, np, attn, tmp, "phase 7", VAE_CONFIG, "smoke", lpips_path)
    del run["trainer"], run["x"]
    return dict(run, grad_rel_l2=errs, images=os.path.join(tmp, "train.npy"))


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
    with open(config_path) as f:
        text = _override(f.read(), {
            "train_set": os.path.join(tmp, "train.npy"), "dev_set": os.path.join(tmp, "dev.npy"),
            "plot_set": os.path.join(tmp, "plot.npy"),
            "checkpoints_dir": os.path.join(tmp, "ckpt"), "logs_dir": os.path.join(tmp, "logs"),
            "epochs": 1, "log_interval": 5, "disc_start": VAE_DISC_START})
    config = os.path.join(tmp, f"{run}.yaml")
    with open(config, "w") as f:
        f.write(text)
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
                accum_codebook_rel_err_own_codes=cb_err_flips)


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
    with open(CONFIG) as f:
        text = _override(f.read(), {
            "train_set": os.path.join(lat_dir, "diffusion_dataset.npy"),
            "train_labels": os.path.join(lat_dir, "diffusion_labels.npy"),
            "checkpoints_dir": os.path.join(tmp, "ckpt"), "logs_dir": os.path.join(tmp, "logs"),
            "epochs": 1, "log_interval": 5}) + "ema_decay: 0.999\n"
    config = os.path.join(tmp, "diffusion.yaml")
    with open(config, "w") as f:
        f.write(text)
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
                encode_rel_l2=enc_err, train_launches=train_launches, grids=out)


def main() -> int:
    import torch

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
    sites = phase_kernels(torch, F, attn, clock_hz)
    bwd_sites = phase_bwd_kernels(torch, F, attn, clock_hz)
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
                             "phase 8 sample_grid dpm": clis["grids"]["dpm"]["launches"][0]},
        "max_abs_err": max(s["max_abs_err"] for s in sites),
        **per_forward,
        "bound_by": "operations" if bound_ops > per_forward["bound_ms"] / 2 else "bytes",
        "per": "one UNet forward at batch 54: 14 sites, two of each shape in sites",
        "sites": sites,
    }, {
        "name": "packed_attention_bwd",
        "route": "cuda",
        "source": "image_diffusion_torch/ops/csrc/packed_attention_bwd.cu",
        "replaces": "image_diffusion_tpu/ops/pallas/attention.py:288",
        "launches": train["launches"]["backward"],
        "launches_by_path": {"phase 6 train_diffusion": train["launches"]["backward"],
                             "phase 8 train_diffusion": clis["train_launches"][1]},
        "max_abs_err": max(s["max_abs_err"] for s in bwd_sites),
        **per_backward,
        "bound_by": "operations" if bwd_bound_ops > per_backward["bound_ms"] / 2 else "bytes",
        "per": "one UNet backward at batch 48: 14 sites, two of each shape in sites; ms with "
               "the forward's saved output and row sums, as PackedAttention calls it; alone_ms "
               "when the wrapper launches the forward first",
        "sites": bwd_sites,
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
                             "phase 8 sample_grid dpm": clis["grids"]["dpm"]["launches"][1]},
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
        "vq_accum_codebook_rel_err_own_codes": vq["accum_codebook_rel_err_own_codes"]}
    log(json.dumps(record))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
