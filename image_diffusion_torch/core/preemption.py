"""Preemption-safe training.

Trainers poll a signal-latched flag each step and cut a resumable
checkpoint as soon as SIGTERM arrives, so at most one step of work is lost.
"""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Latches SIGTERM; `triggered` is polled by the training loops."""

    def __init__(self):
        self.triggered = False
        self._prev = None
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:  # not in the main thread
            pass

    def _handler(self, signum, frame):
        self.triggered = True
        if callable(self._prev):
            self._prev(signum, frame)
