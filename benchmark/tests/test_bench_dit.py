"""The DiT cell: its frozen FLOP counts recounted over the reference on
the meta device, its attention sites against the reference's, and a whole
run of the cell cut to a small size on the CPU (the driver, the pipeline's
hooks and the check)."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import harness
import yardstick as Y
from reference import dit

BENCH = Path(__file__).resolve().parents[1]
CELL = "dit-xl2-256.sample-ddim50-b64"
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs" / "dit-xl2-256.json").read_text())
SMALL = dict(input_size=8, hidden_size=144, depth=2, num_heads=2, num_classes=10)


def test_frozen_flops_match_a_recount():
    assert dit.flop_counts(CONFIG) == CONFIG["flops"]


def test_attention_sites_are_the_references():
    arch = dit.dit_arch(CONFIG)
    P = {l.name: torch.empty(l.shape, device="meta") for l in dit.dit_leaves(arch)}
    P["pos_embed"] = torch.empty(1, dit.tokens(arch), arch["hidden_size"], device="meta")
    sites = []
    ids = torch.zeros(2, dtype=torch.long, device="meta")
    dit.dit(P, arch, torch.empty(2, 32, 32, 4, device="meta"), ids, ids, sites=sites)
    assert [(N, C, h) for _, N, C, h in sites] == [(256, 1152, 16)] * 28


def small_cell(dtype: str) -> harness.Cell:
    c = harness.Cell(CELL)
    c.config.update(SMALL, compute_dtype=dtype)
    c.config["vae"] = dict(c.config["vae"], channels=[32, 64, 64], num_groups=8, init_resolution=32)
    c.traffic.update(images=6, steps=4, checked_per_call=4)
    return c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_small_run_is_correct_and_the_control_is_not(dtype):
    c = small_cell(dtype)
    out = harness.run(c, 3000000007, 0.0, 0, "cpu", time.perf_counter())
    assert out["correct"] and out["attempted"] == 6
    assert set(out["compared"]) == {"start_gap", "step_gap", "decode_gap"}
    s = c.driver.Session(c.config, c.traffic, 5, "cpu")
    s.run_unit()
    got = s.check(control=True, fault="half_batch")
    assert all(got[k] <= lim for k, lim in c.limits.items()), got
    assert any(got[f"control.{k}"] > lim for k, lim in c.limits.items()), got
    assert any(got[f"fault.{k}"] > lim for k, lim in c.limits.items()), got
    assert s.unit_attention == [Y.attention_forward(12, 16, 144)] * 8


ISOLATED = """
import sys
sys.path[:0] = {paths!r}
import harness, test_bench_dit
out = harness.run(test_bench_dit.small_cell("bfloat16"), 3000000011, 0.0, 0, "cpu", 0.0)
print(out["correct"], harness.forbidden_modules(), "image_diffusion_torch" in sys.modules)
"""


def test_a_run_of_the_cell_loads_neither_jax_nor_the_jax_package():
    """The cell at the small size in a fresh interpreter: the port loads,
    JAX and the JAX package do not."""
    code = ISOLATED.format(paths=[str(BENCH.parent), str(BENCH), str(Path(__file__).parent)])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=BENCH.parent)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "True [] True"
