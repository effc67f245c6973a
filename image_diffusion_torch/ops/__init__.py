"""Attention-site routing, the site log, and the attention functions.

Route of a self-attention site, decided by its compute dtype, head dim d
and token count N:
  * "kernel": the packed-attention kernel pair (`attention.packed_attention`)
    for a bf16 site with d a multiple of 16 no larger than 64 and N a
    multiple of 16 -- all 14 UNet sites of the shipped config
    (d = 16/32/48/64).  With grad enabled it runs as the operator
    `attention.packed_attention_fwd`: the forward kernel, and as its
    gradient the backward kernels of `csrc/packed_attention_bwd.cu`;
  * "flash": the blockwise kernel (`attention.flash_attention`, heads split
    to the (B, H, N, D) layout) for a bf16 site whose d is in
    `FLASH_HEAD_DIMS` and N a multiple of its 64-row tile -- the VAE's two
    one-head d=384 mid-block sites (N = 1024 at 128x128 images).  With grad
    enabled it runs as `attention.FlashAttention`, whose gradient is
    autograd of the einsum path, as in the JAX package;
  * "plain": the einsum path (`attention.reference_attention`) for
    everything else, fp32 (verification) mode included, differentiated by
    autograd.

The JAX package's ceilings on C (`packed_max_c`) and its 128-lane grouping
exclusion were TPU measurements and are not carried over; every site's
times on the H100 are in PERF.md.  On CPU tensors the kernel routes run the
kernels' plain versions.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch

from .attention import (
    FLASH_HEAD_DIMS,
    FLASH_TILE,
    HEAD_DIMS,
    FlashAttention,
    flash_attention,
    merge_heads,
    packed_attention,
    packed_attention_bwd,
    packed_attention_bwd_op,
    packed_attention_fwd,
    reference_attention,
    reference_attention_heads,
    reference_flash_attention,
    reference_packed_attention,
    reference_packed_attention_bwd,
    split_heads,
)

__all__ = [
    "FlashAttention",
    "flash_attention",
    "merge_heads",
    "packed_attention",
    "packed_attention_bwd",
    "packed_attention_bwd_op",
    "packed_attention_fwd",
    "reference_attention",
    "reference_attention_heads",
    "reference_flash_attention",
    "reference_packed_attention",
    "reference_packed_attention_bwd",
    "split_heads",
    "log_site",
    "record_sites",
    "site_route",
]


def site_route(N: int, C: int, num_heads: int, dtype: torch.dtype) -> str:
    """"kernel", "flash" or "plain" for a self-attention site (see module
    doc)."""
    if dtype != torch.bfloat16 or C % num_heads:
        return "plain"
    d = C // num_heads
    if d in HEAD_DIMS and N % 16 == 0:
        return "kernel"
    if d in FLASH_HEAD_DIMS and N % FLASH_TILE == 0:
        return "flash"
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
    """Called by SpatialSelfAttention; a no-op outside `record_sites`.  It
    counts Python calls, which a block recomputed under remat makes again;
    kernel launches are counted where they happen, in the wrappers."""
    log = _SITE_LOG.get()
    if log is not None:
        log.append((int(B), int(N), int(C), int(num_heads), route))
