"""The benchmark's cells cut to widths and batches a CPU test run holds:
every key a cell reads, the architecture's shape (levels, layers, heads,
the attention sites) kept, the widths and the images small."""

from __future__ import annotations

import time

import harness

UNET = dict(channels=[32, 64, 96, 128], mid_channels=[128, 128], time_dim=64, num_heads=4,
            num_groups=8)
VAE = dict(channels=[32, 64, 96], num_groups=8)


def cell(name: str, dtype: str = "float32") -> harness.Cell:
    c = harness.Cell(name)
    precision = {"float32": "fp32", "bfloat16": "fp16"}[dtype]
    if c.entry["config"] == "ldm-kl-lin":
        c.config.update(UNET, compute_dtype=dtype, precision=precision)
        c.config["vae"] = dict(c.config["vae"], **VAE, init_resolution=64)
        if c.traffic["kind"] == "sample":
            c.traffic.update(images_per_class=2, steps=4, checked_per_call=4)
        else:
            c.traffic.update(batch_size=8, reference_block_rows=4)
    else:
        c.config.update(VAE, init_resolution=32, compute_dtype=dtype, precision=precision)
        c.traffic.update(batch_size=4)
    return c


def run(c: harness.Cell, seed: int = 5) -> dict:
    return harness.run(c, seed, 0.0, 0, "cpu", time.perf_counter())
