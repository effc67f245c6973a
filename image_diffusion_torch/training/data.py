"""Data feeding: in-RAM arrays -> device batches, prefetched.

  * one shuffle seed gives one permutation, `np.random.default_rng(seed)
    .permutation(n)`, the JAX package's, so both packages visit the same
    batches in the same order;
  * batches cross to the card in their storage dtype (fp16 latents, uint8
    labels) from pinned host memory with non-blocking copies, PREFETCH
    batches ahead of the one in use; the step casts them;
  * the trailing partial batch is dropped.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator

import numpy as np
import torch


class ArrayDataset:
    """One or more aligned in-RAM arrays (latents + labels)."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("arrays must be aligned")
        self.arrays = arrays

    def __len__(self) -> int:
        return len(self.arrays[0])


def steps_per_epoch(dataset: ArrayDataset, batch_size: int) -> int:
    return len(dataset) // batch_size


PREFETCH = 2  # batch copies in flight ahead of the batch in use


def epoch_batches(dataset: ArrayDataset, batch_size: int, shuffle_seed: int | None = None,
                  device: str | torch.device = "cpu") -> Iterator[tuple]:
    """Yield one epoch of batches (a tuple of tensors per batch) on
    `device`, PREFETCH copies in flight ahead of the batch yielded."""
    n = len(dataset)
    order = (np.random.default_rng(shuffle_seed).permutation(n) if shuffle_seed is not None
             else np.arange(n))
    num_batches = n // batch_size
    dev = torch.device(device)

    def put(i: int) -> tuple:
        idx = order[i * batch_size:(i + 1) * batch_size]
        host = [torch.from_numpy(np.ascontiguousarray(a[idx])) for a in dataset.arrays]
        if dev.type == "cpu":
            return tuple(host)
        # the caching host allocator keeps a pinned block until its copy ends
        return tuple(h.pin_memory().to(dev, non_blocking=True) for h in host)

    buf = deque(put(i) for i in range(min(PREFETCH, num_batches)))
    for i in range(num_batches):
        if i + PREFETCH < num_batches:
            buf.append(put(i + PREFETCH))
        yield buf.popleft()
