"""Host-side metric buffering.

Per-metric ring buffers averaged and flushed every `log_interval` steps.
Device tensors are stored as they are (no sync when stored); a flush
averages every metric on its device and copies all the means to the host
in one transfer per device, so the training loop syncs once per flush.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import torch


class MetricHolder:
    """Ring-buffered metric averaging."""

    def __init__(self, buff_size: int):
        self.buff_size = buff_size
        self.metrics: dict[str, deque] = {}

    def store_variable(self, name: str, val: Any) -> None:
        """Buffer one value: a Python number or a 0-d tensor on any device."""
        if name not in self.metrics:
            self.metrics[name] = deque(maxlen=self.buff_size)
        self.metrics[name].append(val.detach() if isinstance(val, torch.Tensor) else val)

    def store_dict(self, values: dict[str, Any]) -> None:
        for name, val in values.items():
            self.store_variable(name, val)

    def flush(self) -> dict[str, float]:
        """Average and clear every metric; one host transfer per device."""
        means: dict[torch.device, list[tuple[str, torch.Tensor]]] = {}
        for name, vals in self.metrics.items():
            if vals:
                t = torch.stack([torch.as_tensor(v, dtype=torch.float64).reshape(())
                                 if not isinstance(v, torch.Tensor) else v.reshape(()).double()
                                 for v in vals]).mean()
                means.setdefault(t.device, []).append((name, t))
                vals.clear()
        out = {}
        for entries in means.values():
            host = torch.stack([t for _, t in entries]).tolist()
            out.update((name, float(v)) for (name, _), v in zip(entries, host))
        return out
