"""Frechet Inception Distance, the port's copy of the JAX package's
`models/fid.py` (numpy statistics; torch features).

  * Running first and second moments per distribution (real and fake),
    float64 sums on the host;
  * the real features ingested once: `update_real_once` adds until the
    first `compute` latches them (torchmetrics' reset_real_features=False);
  * the Frechet distance |mu_r - mu_f|^2 + tr(S_r + S_f - 2 sqrt(S_r S_f)),
    the square root's trace from two symmetric eigendecompositions in
    float64.

The feature function is pluggable: InceptionV3's pool3 (2048-d,
`models/inception.py`) is the canonical one; any callable taking (N, H, W,
3) images in [0, 1] to (N, D) features works (the tests use a random
projection).  No gather across processes yet: one device computes all
features.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


class RunningStats:
    """Streaming mean and covariance over feature batches (float64)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.sum = np.zeros((self.dim,), np.float64)
        self.outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(0)
        self.outer += f.T @ f

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError("need >= 2 samples for covariance")
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + tr(C1 + C2 - 2 (C1 C2)^(1/2)), float64 on the
    host.  tr sqrt(C1 C2) = tr sqrt(C1^1/2 C2 C1^1/2), which is symmetric
    positive semi-definite.  A non-finite trace retries with eps * I added
    to both covariances, eps growing tenfold up to 1e-2; non-finite
    covariances raise."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    diff = mu1 - mu2

    s, u = np.linalg.eigh(cov1)
    s = np.clip(s, 0, None)
    sqrt_c1 = (u * np.sqrt(s)) @ u.T
    inner = sqrt_c1 @ cov2 @ sqrt_c1
    s2, _ = np.linalg.eigh(inner)
    tr_sqrt = np.sqrt(np.clip(s2, 0, None)).sum()

    if not np.isfinite(tr_sqrt):
        if not (np.isfinite(cov1).all() and np.isfinite(cov2).all()):
            # no diagonal offset repairs a NaN covariance
            raise ValueError("non-finite covariance in frechet_distance")
        if eps > 1e-2:
            raise ValueError("frechet_distance failed to stabilize (eps cap)")
        offset = np.eye(cov1.shape[0]) * eps
        return frechet_distance(mu1, cov1 + offset, mu2, cov2 + offset, eps=eps * 10)

    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)


class FID:
    """Fake statistics per evaluation, real ones once."""

    def __init__(self, feature_fn: Callable[[torch.Tensor], torch.Tensor], dim: int):
        self.feature_fn = feature_fn
        self.real = RunningStats(dim)
        self.fake = RunningStats(dim)
        self._real_done = False

    def _features(self, images01: torch.Tensor, n_valid: int | None) -> np.ndarray:
        with torch.no_grad():
            feats = self.feature_fn(images01)[:n_valid]
        return feats.double().cpu().numpy()

    def update_fake(self, images01: torch.Tensor, n_valid: int | None = None) -> None:
        """Add (N, H, W, 3) images in [0, 1]; `n_valid` drops trailing pad
        rows."""
        self.fake.update(self._features(images01, n_valid))

    def update_real_once(self, images01: torch.Tensor, n_valid: int | None = None) -> None:
        """Add real images until the first `compute` latches them."""
        if not self._real_done:
            self.real.update(self._features(images01, n_valid))

    def reset_fake(self) -> None:
        self.fake.reset()

    def compute(self) -> float:
        mu_f, cov_f = self.fake.finalize()
        mu_r, cov_r = self.real.finalize()
        self._real_done = True
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)
