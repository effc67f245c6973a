"""The benchmark's frozen arithmetic: the card's published peaks, the work
of an attention site, seeds derived from `--seed`, and the comparisons
that decide `correct`.

Peaks: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
700 W limit.  Attention work is counted as the algorithm needs it, whatever
implements it: a forward reads q, k and v and writes the output once
(4 B N^2 C operations: q k^T and p v; 8 B N C bytes in bf16); a backward
recomputes the scores and takes dP, dV, dQ and dK (10 B N^2 C
operations), reading q, k, v and dO and writing dq, dk and dv once (14 B
N C bytes).  Least time = the larger of operations over the bf16 peak and
bytes over the HBM rate.
"""

from __future__ import annotations

import gc
import hashlib
import statistics
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
START = time.perf_counter()  # the process's start, once the harness sets it


def mark(label: str) -> None:
    """Say on standard error how far into the process a step of set-up
    ended, the card's work included."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    print(f"benchmark: {label} at {time.perf_counter() - START:.3f} s", file=sys.stderr)


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed from the run's `--seed` (any whole number) and tags."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") % 2**63


def attention_forward(B: int, N: int, C: int) -> tuple[float, float]:
    """(operations, bytes) of softmax(q k^T / sqrt(d)) v over B rows of N
    tokens and C channels (all heads)."""
    return 4.0 * B * N * N * C, 8.0 * B * N * C


def attention_backward(B: int, N: int, C: int) -> tuple[float, float]:
    return 10.0 * B * N * N * C, 14.0 * B * N * C


def least_seconds(work: list[tuple[float, float]]) -> float:
    """Summed least time of (operations, bytes) items on the card."""
    return sum(max(f / PEAK_BF16_FLOPS, b / PEAK_BYTES) for f, b in work)


def unet_attention_sites(arch: dict, latent_res: int) -> list[tuple[int, int]]:
    """(N tokens, C channels) of every self-attention site of one UNet
    forward, in order: num_res_layers a stage, at the stage's resolution."""
    ch, mid, L = arch["channels"], arch["mid_channels"], arch["num_res_layers"]
    sites, res = [], latent_res
    for c in ch[1:]:
        sites += [(res * res, c)] * L
        res //= 2
    for c in mid[1:]:
        sites += [(res * res, c)] * L
    for c in ch[::-1][1:]:
        res *= 2
        sites += [(res * res, c)] * L
    return sites


def vae_attention_sites(arch: dict) -> dict[str, list[tuple[int, int]]]:
    """(N, C) of the encoder's and the decoder's mid-block attention (the
    shipped configs set no other `attn_resolutions`)."""
    if arch.get("attn_resolutions"):
        raise ValueError("attention at other resolutions is not counted")
    r = arch["init_resolution"] // 2 ** (len(arch["channels"]) - 1)
    return {"encode": [(r * r, arch["channels"][-1])], "decode": [(r * r, arch["channels"][-1])]}


# ------------------------------------------------------------- correctness


def reference_mode() -> None:
    """Free what the program left on the card (the caller has dropped its
    references) and make fp32 products full fp32, without TF32, for the
    reference."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rel_l2_rows(got, ref) -> list[float]:
    """Per-row |got - ref| / |ref| of two (B, ...) tensors."""
    g, r = got.float().flatten(1), ref.float().flatten(1)
    return ((g - r).norm(dim=1) / r.norm(dim=1)).tolist()


def norm_gaps(got: dict[str, float], ref: dict[str, float], leaves: list[str]) -> list[float]:
    """Each leaf's |got norm - ref norm| over the larger of the leaf's ref
    norm and the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return [abs(got[k] - ref[k]) / max(ref[k], med) for k in leaves]


def train_gaps(got_losses: list[dict], ref_losses: list[dict], got_first: dict[str, float],
               ref_first: dict[str, float], got_change: dict[str, float],
               ref_change: dict[str, float], got_grads: dict | None = None,
               ref_grads: dict | None = None) -> dict[str, float]:
    """The numbers a training cell compares: the relative gap of each
    step's losses ("loss_gap.<loss>.<step>", or "loss_gap.<step>" where a
    step has one loss) and the worst of them (loss_gap, and per loss
    "loss_gap.<loss>"); the worst leaf's gap of the first gradient's norm,
    and of the norm of the parameters' change over the compared steps, and
    the median leaf's (".median"), and which leaf is the worst (".worst",
    text); given both sides' first gradients, the norm of their difference over the same
    denominator (first_grad_dist, and the median leaf's).  The change leaves
    out leaves whose reference gradient is nought to rounding (under a
    thousandth of the median leaf's)."""
    gaps = [{k: abs(g[k] - r[k]) / abs(r[k]) for k in r}
            for g, r in zip(got_losses, ref_losses, strict=True)]
    keys = list(ref_losses[0])
    leaves = sorted(ref_first)
    med = statistics.median(ref_first[k] for k in leaves)
    moved = [k for k in leaves if ref_first[k] >= 1e-3 * med]
    first = norm_gaps(got_first, ref_first, leaves)
    change = norm_gaps(got_change, ref_change, moved)
    out = {"loss_gap": max(max(g.values()) for g in gaps),
           "first_grad_gap": max(first), "first_grad_gap.median": statistics.median(first),
           "change_gap": max(change), "change_gap.median": statistics.median(change)}
    if got_grads is not None and ref_grads is not None:
        dist = [float((got_grads[k] - ref_grads[k]).norm()) / max(ref_first[k], med)
                for k in leaves]
        out.update({"first_grad_dist": max(dist), "first_grad_dist.median": statistics.median(dist)})
    for name, g, names, ref in (("first_grad_gap", first, leaves, ref_first),
                                ("change_gap", change, moved, ref_change)):
        worst = names[g.index(max(g))]
        out[f"{name}.worst"] = (f"{worst}: reference norm {ref[worst]:.3e}, median leaf's "
                                f"{statistics.median(ref[k] for k in names):.3e}")
    for k in keys:
        name = f"loss_gap.{k}" if len(keys) > 1 else "loss_gap"
        out[name] = max(g[k] for g in gaps)
        out.update({f"{name}.{i + 1}": g[k] for i, g in enumerate(gaps)})
    return out


def train_norms(losses: list[dict], first: dict, params: dict, start: dict):
    """(each step's losses as floats, each leaf's first gradient's norm,
    each leaf's change from `start`'s norm, the first gradients): what a
    training cell compares, of the program or of a reference trace."""
    with torch.no_grad():
        return ([{k: float(v) for k, v in d.items()} for d in losses],
                {k: float(v.norm()) for k, v in first.items()},
                {k: float((v - start[k]).norm()) for k, v in params.items()},
                {k: v.detach().float() for k, v in first.items()})


class WindowSteps:
    """The first `n` steps of a training cell's timed window, kept for the
    check.  Made at the start of set-up, it copies the initial parameters
    and buffers; `rewind()`, after set-up's warm-up steps, sets the same
    model and optimizers back to them and to no update taken, so that the
    window's first steps are the training state's first steps.  Of those it
    keeps each step's losses (the step's own 0-d device tensors), the
    gradients the optimizers took at the first (references: every step
    makes new ones, and the clip has scaled them), and the parameters after
    the last, copied into a buffer made here by one multi-tensor copy, the
    kind set-up's copies warm."""

    def __init__(self, params: dict, buffers: list, n: int):
        self.names, self.params, self.n = list(params), list(params.values()), n
        self.buffers = buffers
        with torch.no_grad():
            self.start = [p.detach().clone() for p in self.params]
            self.end = [torch.empty_like(p) for p in self.params]
            self.buffer_start = [b.clone() for b in buffers]
        self.losses: list[dict] = []
        self.first: list | None = None

    @torch.no_grad()
    def rewind(self, optimizers) -> None:
        torch._foreach_copy_(self.params, self.start)
        for b, b0 in zip(self.buffers, self.buffer_start, strict=True):
            b.copy_(b0)
        for opt in optimizers:
            zeros = [torch.zeros_like(p) for p in opt.params]
            opt.load(0, zeros, [z.clone() for z in zeros])

    def after_step(self, losses: dict) -> None:
        k = len(self.losses)
        if k >= self.n:
            return
        self.losses.append(losses)
        if k == 0:
            self.first = [p.grad for p in self.params]
        if k == self.n - 1:
            with torch.no_grad():
                torch._foreach_copy_(self.end, self.params)

    def norms(self):
        """The program's `train_norms` of the kept steps."""
        if len(self.losses) < self.n:
            raise RuntimeError(f"the window ran {len(self.losses)} of the {self.n} checked steps")
        named = lambda ts: dict(zip(self.names, ts, strict=True))  # noqa: E731
        return train_norms(self.losses, named(self.first), named(self.end), named(self.start))


def train_readings(got: tuple, run, start: dict, control: bool = False,
                   fault: str | None = None) -> dict:
    """The program's readings against the reference: `got` is the program's
    `train_norms`, `run(**opts)` runs the reference's steps from `start` ->
    its `steps.Trace`.  With `control`, also the fp8 reference's readings
    ("control.<name>"), with `fault` those of the reference with that fault
    planted ("fault.<name>")."""
    from reference import lowp

    def norms(trace):
        return train_norms(trace.losses, trace.first_grads, trace.params, start)

    def gaps(have, want):
        return train_gaps(have[0], want[0], have[1], want[1], have[2], want[2], have[3], want[3])

    want = norms(run())
    out = gaps(got, want)
    extra = {"control": dict(q=lowp.fp8)} if control else {}
    if fault:
        extra["fault"] = dict(fault=fault)
    for tag, opts in extra.items():
        out.update({f"{tag}.{k}": v for k, v in gaps(norms(run(**opts)), want).items()})
    return out
