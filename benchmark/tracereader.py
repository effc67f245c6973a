"""Reading a torch.profiler Chrome trace of the benchmark's traced window.

The harness traces a synchronized run of units twice: with CUDA activity
alone, whose small cost leaves the host's pace as it is, for the window's
timing and kernels; and one unit with host operations too, for what only
they show (the autograd node a kernel was launched in).

The window is the host annotation `bench.window` where the trace has one,
else the span of all its events: a trace of CUDA activity alone records no
host annotation, and the profile holds the window alone.
Device operations are the events of category kernel, gpu_memcpy and
gpu_memset, clipped to the window.  The device is busy over the union of
their intervals (overlapping kernels count once); each gap of that union
is idle time, named by the innermost host event open when it began, on any
thread: a host operation, or a CUDA runtime call such as a launch or a
synchronize, else "host between CUDA calls".  A kernel is tied to the host
call that launched it by its correlation id, so it can be attributed to an
enclosing host operation by name.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
NO_CALL = "host between CUDA calls"


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list  # [name, seconds] by total device time, largest first
    idle_gaps: list  # [host event, seconds] by total idle time, largest first


def load(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _spans(events: list[dict]):
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def window(events: list[dict]) -> tuple[float, float]:
    """(start, end) of the traced window, in the trace's microseconds."""
    wins = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(wins) > 1:
        raise ValueError(f"expected at most one host annotation {WINDOW!r}, found {len(wins)}")
    if wins:
        return wins[0]["ts"], wins[0]["ts"] + wins[0]["dur"]
    spans = _spans(events)
    return min(e["ts"] for e in spans), max(e["ts"] + e.get("dur", 0) for e in spans)


def _device(events: list[dict], t0: float, t1: float) -> list[tuple[float, float, dict]]:
    out = []
    for e in _spans(events):
        if e.get("cat") in DEVICE_CATS:
            a, b = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)
            if b > a:
                out.append((a, b, e))
    return sorted(out, key=lambda x: x[0])


def _union(spans: list[tuple[float, float, dict]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b, _ in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(ops: list[tuple[float, float, str]], times: list[float]) -> list:
    """For each of the sorted `times`, (start, name) of the innermost of one
    thread's nested `ops` (sorted by start, longest first) open then, or
    None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append((stack[-1][0], stack[-1][2]) if stack else None)
    return out


def _host_labels(events: list[dict], times: list[float]) -> list[str]:
    """What the host was doing at each of the sorted `times`: the innermost
    host event open then on any thread (the latest started)."""
    threads: dict = defaultdict(list)
    for e in _spans(events):
        if (e.get("cat") in HOST_CATS + LAUNCH_CATS) and e.get("name") != WINDOW:
            threads[(e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e.get("dur", 0),
                                                          e["name"]))
    best: list = [None] * len(times)
    for ops in threads.values():
        ops.sort(key=lambda o: (o[0], -o[1]))
        for i, hit in enumerate(_innermost(ops, times)):
            if hit is not None and (best[i] is None or hit[0] > best[i][0]):
                best[i] = hit
    return [b[1] if b else NO_CALL for b in best]


def summarize(events: list[dict], top: int = 10) -> Summary:
    t0, t1 = window(events)
    spans = _device(events, t0, t1)
    union = _union(spans)
    by_name: dict[str, float] = defaultdict(float)
    for a, b, e in spans:
        by_name[e["name"]] += b - a
    edges = [t0] + [x for ab in union for x in ab] + [t1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps: dict[str, float] = defaultdict(float)
    for (a, b), name in zip(idle, _host_labels(events, [a for a, _ in idle])):
        gaps[name] += b - a

    def ranked(d):
        return [[k[:160], v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return Summary((t1 - t0) * 1e-6, sum(b - a for a, b in union) * 1e-6,
                   sum(1 for _, _, e in spans if e["cat"] == "kernel"), ranked(by_name),
                   ranked(gaps))


def device_seconds(events: list[dict], kernel_pattern: str | None = None,
                   host_pattern: str | None = None) -> float:
    """Device seconds inside the window of the kernels whose name matches
    `kernel_pattern`, or that were launched inside a host operation whose
    name matches `host_pattern`; each kernel counted once."""
    t0, t1 = window(events)
    launched_inside: set = set()
    if host_pattern is not None:
        hre = re.compile(host_pattern)
        inside: dict = defaultdict(list)
        for e in _spans(events):
            if e.get("cat") in HOST_CATS and hre.search(e["name"]):
                inside[(e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e.get("dur", 0)))
        for spans in inside.values():
            spans.sort()
        for e in _spans(events):
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                spans = inside.get((e.get("pid"), e.get("tid")))
                if spans:
                    i = bisect.bisect_right(spans, (e["ts"], float("inf"))) - 1
                    if i >= 0 and spans[i][0] <= e["ts"] <= spans[i][1]:
                        launched_inside.add(e["args"]["correlation"])
    kre = re.compile(kernel_pattern) if kernel_pattern else None
    total = 0.0
    for a, b, e in _device(events, t0, t1):
        if e["cat"] == "kernel" and ((kre and kre.search(e["name"]))
                                     or e.get("args", {}).get("correlation") in launched_inside):
            total += b - a
    return total * 1e-6
