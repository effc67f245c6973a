"""Step timing and profiler traces.

  * `StepTimer` measures the rate between flushes of the training loops.
    The card runs asynchronously, so a clock read alone can come before the
    work it is meant to close: given the step's device scalar, the timer
    first copies it to the host, which waits for every kernel queued before
    it.  (The trainers call it right after `MetricHolder.flush`, which has
    copied the metrics already.)
  * `trace(log_dir)` wraps `torch.profiler` and writes a Chrome trace into
    `log_dir` (or the directory in `IDTPU_PROFILE`); the training CLIs run
    `train()` inside it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A torch.profiler trace of the block (CPU, and CUDA when there is a
    card), written as `trace_<pid>_<time>.json` into `log_dir` or the
    directory `IDTPU_PROFILE` names; does nothing when neither is set."""
    log_dir = log_dir or os.environ.get("IDTPU_PROFILE")
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json"))
