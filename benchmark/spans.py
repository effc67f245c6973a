"""The program's spans in the traced window, and the one rule that credits
the window's device time and idle time to them.

The program records its spans in memory while a torch profiler runs
(`image_diffusion_torch.core.profiling`): the traced window's trace of CUDA
activity alone holds no host annotation.  `program(r)` takes them from the
program once a run (the readers of one run share them), places them on the
trace's clock by their anchors and clips them to the window; a program that
records no spans gives None, and so does every reader.

Credit (`credit`):
  1. each device operation of the window (kernel, copy, set) is tied to the
     runtime call that launched it by its correlation id;
  2. it goes to the innermost span open at that call's time on the
     launching thread;
  3. where that thread has none open, to the innermost span open then on
     any thread (the latest started): autograd's device thread runs the
     backward's kernels while `train.backward` or a phase span is open on
     the main thread.  An operation whose launch the trace lacks is placed
     by its own start.
Each idle gap of the union of device intervals (as `tracereader.summarize`
computes them) is split at the spans' edges, and each piece goes to the
innermost span open then on any thread.  What no span holds is "outside
the program": the benchmark's own loop between units.
"""

from __future__ import annotations

import bisect
import heapq
import sys
from collections import defaultdict
from typing import NamedTuple

import tracereader

OUTSIDE = "outside the program"
TOP_OPS = 12  # device operations whose spans the breakdown lists


class Credit(NamedTuple):
    window_s: float
    busy_s: float
    device: dict  # innermost span name (or OUTSIDE) -> device seconds
    idle: dict  # innermost span name (or OUTSIDE) -> idle seconds
    inclusive: dict  # span id -> device seconds of it and the spans inside it
    ops: dict  # device operation name -> {innermost span name: device seconds}


class _Timeline:
    """The innermost (latest started) of `spans` open at each time."""

    def __init__(self, spans):
        opening = sorted(spans, key=lambda s: s.start)
        heap, i = [], 0
        self.times, self.spans = [], []
        for t in sorted({x for s in spans for x in (s.start, s.end)}):
            while i < len(opening) and opening[i].start <= t:
                s = opening[i]
                heapq.heappush(heap, (-s.start, s.end, s.id, s))
                i += 1
            while heap and heap[0][1] <= t:
                heapq.heappop(heap)
            top = heap[0][3] if heap else None
            if not self.spans or self.spans[-1] is not top:
                self.times.append(t)
                self.spans.append(top)

    def at(self, t: float):
        i = bisect.bisect_right(self.times, t) - 1
        return self.spans[i] if i >= 0 else None

    def pieces(self, a: float, b: float):
        """(seconds, span) of each piece of [a, b) under one innermost span."""
        out, i = [], bisect.bisect_right(self.times, a)
        while a < b:
            end = min(b, self.times[i]) if i < len(self.times) else b
            out.append(((end - a) * 1e-6, self.spans[i - 1] if i else None))
            a, i = end, i + 1
        return out


def credit(events: list[dict], spans: list) -> Credit:
    """The window's device and idle seconds credited to `spans` (placed on
    the trace's clock) by the rule in the module's doc."""
    t0, t1 = tracereader.window(events)
    ops = tracereader._device(events, t0, t1)
    launches = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in tracereader.LAUNCH_CATS and corr is not None:
            launches[corr] = (e["ts"], e.get("tid"))
    by_id = {s.id: s for s in spans}
    anywhere = _Timeline(spans)
    threads = defaultdict(list)
    for s in spans:
        threads[s.tid].append(s)
    own = {tid: _Timeline(ss) for tid, ss in threads.items()}

    device, idle, inclusive = defaultdict(float), defaultdict(float), defaultdict(float)
    by_op = defaultdict(lambda: defaultdict(float))
    for a, b, e in ops:
        t, tid = launches.get(e.get("args", {}).get("correlation"), (a, None))
        s = own[tid].at(t) if tid in own else None
        if s is None:
            s = anywhere.at(t)
        device[s.name if s else OUTSIDE] += (b - a) * 1e-6
        by_op[e["name"]][s.name if s else OUTSIDE] += (b - a) * 1e-6
        while s is not None:
            inclusive[s.id] += (b - a) * 1e-6
            s = by_id.get(s.parent)
    union = tracereader._union(ops)
    edges = [t0] + [x for ab in union for x in ab] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            for seconds, s in anywhere.pieces(a, b):
                idle[s.name if s else OUTSIDE] += seconds
    return Credit((t1 - t0) * 1e-6, sum(b - a for a, b in union) * 1e-6, dict(device),
                  dict(idle), dict(inclusive), {k: dict(v) for k, v in by_op.items()})


def clipped(spans: list, t0: float, t1: float) -> list:
    """The spans that overlap [t0, t1], cut to it."""
    return [s._replace(start=max(s.start, t0), end=min(s.end, t1))
            for s in spans if s.end > t0 and s.start < t1]


def program(r):
    """(spans, credit) of the run's traced window `r`, taken from the
    program at the first call and kept on `r`; None where the program
    records no spans, or the trace holds none of their anchors.  The first
    call prints the breakdown on standard error."""
    if not hasattr(r, "_program_spans"):
        r._program_spans = _take(r)
    return r._program_spans


def _take(r):
    from image_diffusion_torch.core import profiling

    if not hasattr(profiling, "take_spans"):  # a program without spans
        return None
    recorded = profiling.take_spans()
    fit = profiling.clock_fit(recorded, r.events) if recorded else None
    if fit is None:
        print(f"spans: {len(recorded)} recorded, none placed on the trace's clock",
              file=sys.stderr)
        return None
    spans = clipped(fit.place(recorded), *tracereader.window(r.events))
    c = credit(r.events, spans)
    report(spans, c, fit)
    return spans, c


def report(spans: list, c: Credit, fit) -> None:
    """The breakdown on standard error: device and idle seconds by innermost
    span, the UNet's device time per 1,000 rows, and the spans the leading
    device operations ran under."""
    err = sys.stderr
    print(f"spans: {len(spans)} in the window, clock from {fit.pairs} anchors (worst "
          f"{fit.worst_us:.2f} us off the fit, slope {fit.b:.9f}); window "
          f"{c.window_s:.6f} s, busy {c.busy_s:.6f} s", file=err)
    names = sorted(set(c.device) | set(c.idle), key=lambda k: -c.device.get(k, 0.0))
    for name in names:
        print(f"spans: {name:<22} device {c.device.get(name, 0.0):.6f} s "
              f"({100 * c.device.get(name, 0.0) / max(c.busy_s, 1e-12):.2f}% of busy)  idle "
              f"{c.idle.get(name, 0.0):.6f} s", file=err)
    unet = [s for s in spans if s.name == "unet.forward"]
    rows = sum(s.attrs.get("rows", 0) for s in unet)
    if rows:
        ms = 1e3 * sum(c.inclusive.get(s.id, 0.0) for s in unet)
        print(f"spans: unet.forward {ms:.3f} device ms over {rows} rows: "
              f"{1e3 * ms / rows:.4f} ms per 1,000 rows", file=err)
    for op, where in sorted(c.ops.items(), key=lambda kv: -sum(kv[1].values()))[:TOP_OPS]:
        split = ", ".join(f"{k} {v:.6f}" for k, v in sorted(where.items(), key=lambda kv: -kv[1]))
        print(f"spans: {sum(where.values()):.6f} s of {op[:100]}: {split}", file=err)


def program_idle_share(r):
    """Percent of the window in which the card was idle while a span was
    open, or None."""
    got = program(r)
    if got is None:
        return None
    c = got[1]
    return 100.0 * sum(v for k, v in c.idle.items() if k != OUTSIDE) / c.window_s


def device_share(r, name: str):
    """Percent of the window's busy seconds credited to the span `name`, or
    None."""
    got = program(r)
    if got is None or got[1].busy_s <= 0:
        return None
    return 100.0 * got[1].device.get(name, 0.0) / got[1].busy_s
