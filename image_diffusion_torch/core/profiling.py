"""Step timing, profiler traces and the program's spans.

  * `StepTimer` measures the rate between flushes of the training loops.
    The card runs asynchronously, so a clock read alone can come before the
    work it is meant to close: given the step's device scalar, the timer
    first copies it to the host, which waits for every kernel queued before
    it.  (The trainers call it right after `MetricHolder.flush`, which has
    copied the metrics already.)
  * `trace(log_dir)` wraps `torch.profiler` and writes a Chrome trace into
    `log_dir` (or the directory in `IDTPU_PROFILE`), with the spans recorded
    inside it; the training CLIs run `train()` inside it.
  * `span(name, **attrs)` marks a stretch of the program (a sampling call,
    a train step, a module's forward) while a torch profiler runs, on any
    thread.  With no profiler it reads one flag and returns: it records
    nothing, calls no torch operator and makes no CUDA call.
    `take_spans()` hands the recorded spans over and empties the buffer;
    `clock_fit(spans, events)` places them on a trace's clock.

Spans are the program's own records, kept in memory, and not profiler
events: a trace of CUDA activity alone holds no host annotation, and a
`record_function` costs ~15 us a call even with no profiler running.  Each
span keeps its name, its edges, its thread's native id (a trace's "tid"),
its parent (the span open in its context when it opened: `contextvars`, so
a thread started with a copy of the caller's context sees the caller's
span), its group (the outermost span's id: one sampling call or one train
step) and its attributes.

The clock.  A span's edges are `time.perf_counter_ns()` readings.  A span
that starts a thread's stretch of work (no parent, or its parent on another
thread) is anchored: it makes two calls that launch nothing and that a
trace records, and keeps the clock's reading at each: `cudaStreamQuery` on
the current stream once CUDA is up (a trace of CUDA activity records the
runtime call), and, on a thread whose host activity the profiler records,
a host annotation `ANCHOR`.  `clock_fit` pairs the k-th anchor of a kind
with the trace's k-th event of that kind, in time order over all threads
(the anchors of a later trace follow those of the first in the buffer),
fits trace time = a + b * clock, and learns from the pairs the trace's
name for each thread.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import statistics
import threading
import time
from collections import Counter
from typing import NamedTuple

import torch

ANCHOR = "span.anchor"  # the host annotation of an anchor
ANCHOR_CALL = "cudaStreamQuery"  # the CUDA runtime call of an anchor
MAX_SPANS = 1 << 18  # the buffer keeps the first MAX_SPANS spans after a take
OUTLIER_US = 20.0  # an anchor further off the fitted clock is left out of the fit


class StepTimer:
    """Items per second between calls, synced on a per-step device scalar."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def items_per_sec(self, n_items: int, sync_scalar: torch.Tensor | None = None) -> float:
        """The rate of `n_items` since the last call (or construction)."""
        if sync_scalar is not None:
            sync_scalar.item()  # device -> host: the work before it is done
        now = time.perf_counter()
        rate = n_items / max(now - self._t0, 1e-9)
        self._t0 = now
        return rate


class Span(NamedTuple):
    """A recorded span.  Times in microseconds: on the recorder's clock as
    `take_spans` returns them, on a trace's after `ClockFit.place`."""

    name: str
    start: float
    end: float
    tid: int  # the thread's native id (the trace's id for it, once placed)
    id: int
    parent: int | None  # the enclosing span's id
    group: int  # the outermost span's id
    attrs: dict
    anchors: tuple  # ("cuda" | "host", clock reading) of each anchor it made


# torch.profiler sets this flag for the whole process while it runs;
# `torch.autograd._profiler_enabled()` is the profiling thread's alone
_flags = torch.autograd.profiler
_OFF = contextlib.nullcontext()
_current: contextvars.ContextVar = contextvars.ContextVar("span", default=None)
_ids = itertools.count(1)
_buffer: list[Span] = []


def span(name: str, **attrs):
    """A context manager that records the block as a span while a torch
    profiler runs, and does nothing otherwise."""
    if not _flags._is_profiler_enabled:
        return _OFF
    return _Open(name, attrs)


def take_spans() -> list[Span]:
    """The spans recorded since the last call, in the order they closed;
    the buffer is emptied."""
    global _buffer
    spans, _buffer = _buffer, []
    return spans


def _anchor() -> tuple:
    # the clock is read just before each call: the trace stamps the call's
    # entry, and a first call's set-up can take far longer than its entry
    out = []
    if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
        stream = torch.cuda.current_stream()
        out.append(("cuda", time.perf_counter_ns() / 1e3))
        stream.query()
    if torch.autograd._profiler_enabled():  # host events of this thread are recorded
        out.append(("host", time.perf_counter_ns() / 1e3))
        with torch.autograd.profiler.record_function(ANCHOR):
            pass
    return tuple(out)


class _Open:
    __slots__ = ("name", "attrs", "tid", "id", "parent", "group", "anchors", "start", "token")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        parent = _current.get()
        self.tid, self.id = threading.get_native_id(), next(_ids)
        if parent is None:
            self.parent, self.group = None, self.id
        else:
            self.parent, self.group = parent.id, parent.group
        self.anchors = _anchor() if parent is None or parent.tid != self.tid else ()
        self.token = _current.set(self)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _current.reset(self.token)
        if len(_buffer) < MAX_SPANS:
            _buffer.append(Span(self.name, self.start / 1e3, end / 1e3, self.tid, self.id,
                                self.parent, self.group, self.attrs, self.anchors))


class ClockFit(NamedTuple):
    """trace time = a + b * recorder time, from `pairs` anchors; `worst_us`
    is the largest distance of an anchor from the fitted line; `threads`
    maps a thread's native id to the trace's id of its runtime calls (a
    trace of CUDA activity alone names a thread by another number)."""

    a: float
    b: float
    pairs: int
    worst_us: float
    threads: dict

    def place(self, spans: list[Span]) -> list[Span]:
        return [s._replace(start=self.a + self.b * s.start, end=self.a + self.b * s.end,
                           tid=self.threads.get(s.tid, s.tid), anchors=()) for s in spans]


def clock_fit(spans: list[Span], events: list[dict]) -> ClockFit | None:
    """The fit of the recorder's clock to the clock of the Chrome trace
    whose events are `events`, from the anchors of `spans` the trace holds;
    None where it holds none.  The CUDA anchors are used where the trace
    holds any: the runtime call is stamped at its entry, while a profiler
    can stamp its first host annotation late."""
    mine: dict = {"cuda": [], "host": []}
    for s in spans:
        for kind, t in s.anchors:
            mine[kind].append((t, s.tid))
    marks: dict = {"cuda": [], "host": []}
    for e in events:
        name, cat = e.get("name", ""), e.get("cat")
        if cat == "cuda_runtime" and name.startswith(ANCHOR_CALL):
            marks["cuda"].append((e["ts"], e.get("tid")))
        elif cat == "user_annotation" and name == ANCHOR:
            marks["host"].append((e["ts"], e.get("tid")))
    kind = "cuda" if mine["cuda"] and marks["cuda"] else "host"
    pairs = list(zip(sorted(mine[kind]), sorted(marks[kind])))
    if not pairs:
        return None
    a, b = _line(pairs)
    # once more without the anchors far off the line (a call delayed
    # between the clock's reading and the trace's stamp)
    res = [abs(v - a - b * u) for (u, _), (v, _) in pairs]
    cut = max(OUTLIER_US, 5 * statistics.median(res))
    pairs = [p for p, r in zip(pairs, res) if r <= cut]
    a, b = _line(pairs)
    names: dict = {}
    for (_, tid), (_, name) in pairs:
        names.setdefault(tid, Counter())[name] += 1
    return ClockFit(a, b, len(pairs), max(abs(v - a - b * u) for (u, _), (v, _) in pairs),
                    {tid: c.most_common(1)[0][0] for tid, c in names.items()})


def _line(pairs: list) -> tuple[float, float]:
    """(a, b) of y = a + b x through the ((x, _), (y, _)) pairs: least
    squares where the x spread over a millisecond, else b = 1 and the median
    offset."""
    x, y = [u for (u, _), _ in pairs], [v for _, (v, _) in pairs]
    if max(x) - min(x) < 1e3:
        return statistics.median(v - u for u, v in zip(x, y)), 1.0
    mx, my = statistics.fmean(x), statistics.fmean(y)
    b = sum((u - mx) * (v - my) for u, v in zip(x, y)) / sum((u - mx) ** 2 for u in x)
    return my - b * mx, b


def _write_spans(path: str, spans: list[Span]) -> None:
    """Add `spans` to the Chrome trace at `path` as complete events of
    category "program_span", on its clock (none where it holds none of
    their anchors)."""
    with open(path) as f:
        data = json.load(f)
    fit = clock_fit(spans, data["traceEvents"])
    if fit is None:
        return
    pid = os.getpid()
    data["traceEvents"] += [
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.tid,
         "ts": s.start, "dur": s.end - s.start,
         "args": {"id": s.id, "parent": s.parent, "group": s.group, **s.attrs}}
        for s in fit.place(spans)]
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A torch.profiler trace of the block (CPU, and CUDA when there is a
    card), written as `trace_<pid>_<time>.json` into `log_dir` or the
    directory `IDTPU_PROFILE` names, with the spans recorded inside the
    block; does nothing when neither is set."""
    log_dir = log_dir or os.environ.get("IDTPU_PROFILE")
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = next(_ids)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json")
    prof.export_chrome_trace(path)
    _write_spans(path, [s for s in take_spans() if s.id > first])
