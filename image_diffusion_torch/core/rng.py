"""Seeds of a training run.

The JAX package threads `jax.random` keys (`root_key`, `epoch_key`,
`numpy_seed`); their streams cannot be reproduced in PyTorch, so the port
keeps their semantics with integer seeds: the run seed offset by the
configured epoch count (resumed sub-runs draw fresh data order and noise),
a per-epoch seed, and from it the numpy shuffle seed and the
`torch.Generator`s of the epoch's per-step draws and of its dev
evaluation.
"""

from __future__ import annotations

import numpy as np
import torch


def root_seed(seed: int | None, offset: int | None = None) -> int:
    """The run's seed: `seed` (fresh entropy when None) plus `offset`."""
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**31))
    if offset:
        seed = seed + offset
    return seed


def epoch_seed(root: int, epoch: int) -> int:
    """Seed of one epoch of the run."""
    return int(np.random.SeedSequence((root, epoch)).generate_state(1, np.uint64)[0] >> 1)


def numpy_seed(seed: int) -> int:
    """The numpy seed of an epoch's dataset permutation."""
    return int(np.random.SeedSequence((seed, 0)).generate_state(1)[0] % (2**31))


def step_generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """The generator, on `device`, of an epoch's per-step draws (KL noise,
    timesteps, diffusion noise, condition dropout)."""
    sub = int(np.random.SeedSequence((seed, 1)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(sub)


def eval_generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """The generator, on `device`, of an epoch's dev-evaluation draws."""
    sub = int(np.random.SeedSequence((seed, 2)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(sub)
