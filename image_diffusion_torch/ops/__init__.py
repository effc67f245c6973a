"""Attention-site routing, the site log, and the attention functions.

Route of a self-attention site:
  * "kernel": the packed-attention kernel (`attention.packed_attention`),
    for every site whose compute dtype is bf16, whose head dim is a
    multiple of 16 no larger than 64, and whose token count is a multiple
    of 16 -- all 14 UNet sites of the shipped config (d = 16/32/48/64);
  * "plain": the einsum path (`attention.reference_attention`) for
    everything else -- fp32 (verification) mode and the VAE's one-head
    d=384 mid-block site.

One route serves both directions.  With grad enabled (training), a
"kernel" site runs as `attention.PackedAttention`: the forward kernel, and
as its gradient the backward kernel of `csrc/packed_attention_bwd.cu`, at
the same 14 UNet sites.  The JAX package's training ceiling on C
(`packed_max_c`) was a TPU measurement and is not carried over: every
site's forward and backward times on the H100 are in PERF.md.  A "plain"
site is differentiated by autograd through the einsum path.

On CPU tensors the kernel route runs the kernels' plain versions.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch

from .attention import (
    HEAD_DIMS,
    PackedAttention,
    packed_attention,
    packed_attention_bwd,
    reference_attention,
    reference_packed_attention,
    reference_packed_attention_bwd,
)

__all__ = [
    "PackedAttention",
    "packed_attention",
    "packed_attention_bwd",
    "reference_attention",
    "reference_packed_attention",
    "reference_packed_attention_bwd",
    "log_site",
    "record_sites",
    "site_route",
]


def site_route(N: int, C: int, num_heads: int, dtype: torch.dtype) -> str:
    """"kernel" or "plain" for a self-attention site (see module doc)."""
    if (dtype == torch.bfloat16 and C % num_heads == 0
            and C // num_heads in HEAD_DIMS and N % 16 == 0):
        return "kernel"
    return "plain"


_SITE_LOG: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "idtorch_attention_site_log", default=None
)


@contextmanager
def record_sites():
    """Collect (B, N, C, num_heads, route) for every attention site run
    inside the block, one entry per call."""
    log: list[tuple[int, int, int, int, str]] = []
    tok = _SITE_LOG.set(log)
    try:
        yield log
    finally:
        _SITE_LOG.reset(tok)


def log_site(B: int, N: int, C: int, num_heads: int, route: str) -> None:
    """Called by SpatialSelfAttention; a no-op outside `record_sites`."""
    log = _SITE_LOG.get()
    if log is not None:
        log.append((int(B), int(N), int(C), int(num_heads), route))
