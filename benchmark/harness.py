"""The benchmark's run of one cell: set-up, a measured or a traced window,
the check against the reference, and the result line.

Everything that belongs to one cell is data found by name:
`BENCHMARK.json` names the cell's configuration (its file) and traffic
mix; `traffic/<traffic>.json` names the driver (`drivers/<kind>.py`) that
generates the mix and gives its parameters; `limits/<cell>.json` holds the
limit of each number the check compares; each per-layer metric is read by
`metrics/<metric>.py`.

A driver module defines `RATE` (the end-to-end rate's name and unit) and
`Session(config, traffic, seed, device)`, whose construction is the
set-up (weights from the seed, the program's objects, the shapes warmed)
and which has:
  * `run_unit()`: issue one unit of the traffic (a sampling call, a train
    step) without waiting for the card;
  * `min_units`: the units a window runs at the least (those it checks);
  * `unit_items`, `unit_steps`, `unit_flops`, `unit_attention`: per unit,
    the images or samples it completes, its sampler or train steps, its
    model FLOPs, and its attention work as (operations, bytes) items;
  * `check()`: after the window, frees the program's state, runs the
    reference and returns {name: reading}; the readings that
    `limits/<cell>.json` names are compared with their limits, and a run
    is correct when none is above its limit.  (`check(control=True)` adds
    the control's readings, for `calibrate.py` and the control test.)
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import tracereader
import yardstick

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "image_diffusion_tpu")


def load_file(path: Path):
    """Import the Python file at `path` as a module of its own."""
    name = f"bench_{path.parent.name}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """One entry of `BENCHMARK.json`'s workloads with its files."""

    def __init__(self, name: str):
        self.manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config = json.loads((ROOT / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads((BENCH / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
        self.driver = load_file(BENCH / "drivers" / f"{self.traffic['kind']}.py")

    def end_to_end(self) -> list[dict]:
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        return [m for m in self.manifest["per_layer"] if self.name in m["workloads"]]


class Reading:
    """What a per-layer metric's reader is given: the traced window's
    summary and events (CUDA activity alone), the frozen work of the units
    run in it, and `host_events()`: one more unit traced with host
    operations too (taken at the first call)."""

    def __init__(self, summary, events, units: int, session, host_trace):
        self.summary, self.events, self.units = summary, events, units
        self.steps = units * session.unit_steps
        self.flops = units * session.unit_flops
        self.attention = list(session.unit_attention) * units
        self._host_trace, self._host = host_trace, None

    def host_events(self) -> list[dict]:
        if self._host is None:
            self._host = self._host_trace()
        return self._host


def judge(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number the limits file holds."""
    return {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}


def window(sync, session, seconds: float) -> tuple[int, float]:
    """Units run back to back until `seconds` have passed on the host
    clock and `session.min_units` have run, the last unit whole -> (units,
    seconds up to the card's end); `sync` waits for the card."""
    sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        session.run_unit()
        n += 1
        if n >= session.min_units and time.perf_counter() - t0 >= seconds:
            break
    sync()
    return n, time.perf_counter() - t0


def traced_window(torch, session, units: int, host: bool) -> list[dict]:
    """`units` units under torch.profiler, CUDA activity alone or, with
    `host`, host operations too, inside the annotation the trace reader
    takes as its window -> the trace's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=activities) as prof:
        with record_function("bench.window"):
            torch.cuda.synchronize()
            for _ in range(units):
                session.run_unit()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        return tracereader.load(path)
    finally:
        os.unlink(path)


def build_kernels() -> None:
    """Build the program's CUDA kernels now, so that set-up shows the build
    apart: `nvcc` runs in a checkout's first run only, after which the
    libraries are found by the hash of their sources."""
    from image_diffusion_torch.ops import build

    t0 = time.perf_counter()
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    build.build(names)
    compiled = sorted(build.BUILD_OUTPUT)
    print(f"benchmark: kernels {'compiled ' + ' '.join(compiled) if compiled else 'found built'} "
          f"in {time.perf_counter() - t0:.3f} s", file=sys.stderr)


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str], t_start: float) -> int:
    args = parse(argv)
    cell = Cell(args.workload)
    import torch

    print(f"benchmark: torch imported at {time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = run(cell, args.seed, args.seconds, args.trace, "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules that must not load in a run were loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


def run(cell: Cell, seed: int, seconds: float, trace: int, device: str, t_start: float) -> dict:
    """One run of `cell` on `device` -> the result object.  The benchmark
    runs on the card; the tests drive the same run on the CPU at a small
    size (no trace there)."""
    import torch

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    yardstick.START = t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        yardstick.mark("card ready")
        build_kernels()
    session = cell.driver.Session(cell.config, cell.traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"benchmark: set-up {setup_s:.3f} s", file=sys.stderr)

    metrics: dict = {}
    out: dict = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.entry["chips"]}
    if trace:
        units = max(int(cell.traffic["trace_units"]), session.min_units)
        events = traced_window(torch, session, units, host=False)
        summary = tracereader.summarize(events)
        reading = Reading(summary, events, units, session,
                          lambda: traced_window(torch, session, 1, host=True))
        for m in cell.per_layer():
            value = load_file(BENCH / "metrics" / f"{m['name']}.py").read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del events, reading
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    else:
        units, window_s = window(sync, session, seconds)
        rate_name, _ = cell.driver.RATE
        values = {"setup_s": setup_s, rate_name: units * session.unit_items / window_s}
        print(f"benchmark: {units} units in {window_s:.3f} s", file=sys.stderr)
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    attempted = units * session.unit_items

    readings = session.check()
    del session
    gc.collect()
    compared = judge(readings, cell.limits)
    for k, v in readings.items():
        if k not in compared:
            print(f"benchmark: reading {k} {v!r} (not compared)", file=sys.stderr)
    failed = sum(1 for v in compared.values() if not v["value"] <= v["limit"])
    return {"correct": failed == 0, "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": dev, **out, "compared": compared}
