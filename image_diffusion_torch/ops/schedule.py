"""DDPM noise-schedule math as plain functions over precomputed tables.

The schedule is an immutable tuple of fp32 coefficient tables computed on
the host in float64 and then cast; every step function takes the tables,
the current sample and integer timesteps (a 0-d or (B,) tensor).

Numerics kept from the JAX package:
  * "linear" is scaled-linear: betas = linspace(sqrt(b0), sqrt(b1), T)^2;
    "beta-linear" is linear in beta, betas = linspace(b0, b1, T) (DiT's
    `get_named_beta_schedule("linear")`).
  * cosine uses an 8e-3 offset and clips betas to [0, 0.999].
  * the ancestral step's posterior mean is computed from eps-hat, not from
    the clamped x0 estimate.
  * the x0 estimate is clamped to [-1, 1] unless a step is given
    `clip=False` (DiT samples unbounded latents with clip_denoised=False).
  * at t == 0 no noise is added (sigma = 0).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Schedule(NamedTuple):
    """Immutable DDPM coefficient tables, all shape (T,) fp32."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_cum_prod: torch.Tensor
    sqrt_alpha_cum_prod: torch.Tensor
    sqrt_one_minus_alpha_cum_prod: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]


def make_schedule(num_steps: int, beta_start: float = 1e-4, beta_end: float = 0.02,
                  noise_type: str = "linear", device="cpu") -> Schedule:
    """Build the coefficient tables on the host (float64 -> fp32)."""
    if noise_type == "linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_steps, dtype=np.float64) ** 2
    elif noise_type == "beta-linear":
        betas = np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    elif noise_type == "cosine":
        offset = 8e-3
        ts = np.arange(num_steps + 1, dtype=np.float64) / num_steps
        f = np.cos((ts + offset) / (1 + offset) * math.pi / 2) ** 2
        alphas_hat = f / f[0]
        betas = np.clip(1.0 - alphas_hat[1:] / alphas_hat[:-1], 0.0, 0.999)
    else:
        raise ValueError(f"Unknown noise_type {noise_type!r}; expected 'linear', "
                         "'beta-linear' or 'cosine'")

    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    tables = (betas, alphas, acp, np.sqrt(acp), np.sqrt(1.0 - acp))
    return Schedule(*(torch.tensor(t.astype(np.float32), device=device) for t in tables))


def make_timesteps(num_steps: int, n: int) -> torch.Tensor:
    """Descending evenly spaced subsequence of the training timesteps for
    ddim/dpm sampling (int64)."""
    ts = np.linspace(0, num_steps - 1, n).round().astype(np.int64)
    return torch.from_numpy(ts[::-1].copy())


def _bcast(coef: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a (B,)-gathered coefficient for broadcasting over (B, ...)."""
    return coef.reshape(coef.shape + (1,) * (ndim - coef.dim()))


def q_sample(sched: Schedule, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0): sqrt(acp_t) x0 + sqrt(1-acp_t) eps."""
    mu = _bcast(sched.sqrt_alpha_cum_prod[t], x0.dim())
    sigma = _bcast(sched.sqrt_one_minus_alpha_cum_prod[t], x0.dim())
    return mu * x0 + sigma * noise


def predict_x0(sched: Schedule, xt: torch.Tensor, eps_hat: torch.Tensor, t: torch.Tensor,
               clip: bool = True) -> torch.Tensor:
    """The x0 estimate from a noise prediction, clamped to [-1, 1] with
    `clip`."""
    sqrt_acp = _bcast(sched.sqrt_alpha_cum_prod[t], xt.dim())
    sqrt_omacp = _bcast(sched.sqrt_one_minus_alpha_cum_prod[t], xt.dim())
    x0 = (xt - sqrt_omacp * eps_hat) / sqrt_acp
    return torch.clamp(x0, -1.0, 1.0) if clip else x0


def posterior_mean(sched: Schedule, xt: torch.Tensor, eps_hat: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mean = (xt - beta_t * eps_hat / sqrt(1 - acp_t)) / sqrt(alpha_t)."""
    beta = _bcast(sched.betas[t], xt.dim())
    alpha = _bcast(sched.alphas[t], xt.dim())
    sqrt_omacp = _bcast(sched.sqrt_one_minus_alpha_cum_prod[t], xt.dim())
    return (xt - beta * eps_hat / sqrt_omacp) / torch.sqrt(alpha)


def posterior_sigma(sched: Schedule, t: torch.Tensor) -> torch.Tensor:
    """sqrt((1 - acp_{t-1}) / (1 - acp_t) * beta_t), and 0 at t == 0."""
    acp_t = sched.alpha_cum_prod[t]
    acp_prev = sched.alpha_cum_prod[torch.clamp(t - 1, min=0)]
    var = (1.0 - acp_prev) / (1.0 - acp_t) * sched.betas[t]
    return torch.where(t == 0, torch.zeros_like(var), torch.sqrt(var))


def ddpm_step(sched: Schedule, xt: torch.Tensor, eps_hat: torch.Tensor, t: torch.Tensor,
              noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One ancestral step x_t -> x_{t-1}; returns (x_prev, x0_estimate).
    `noise` is ignored at t == 0 through the sigma mask."""
    x0 = predict_x0(sched, xt, eps_hat, t)
    mean = posterior_mean(sched, xt, eps_hat, t)
    sigma = _bcast(posterior_sigma(sched, t), xt.dim())
    return mean + sigma * noise, x0


def _acp_prev(sched: Schedule, t_prev: torch.Tensor, nd: int) -> torch.Tensor:
    """acp at t_prev, and 1 where t_prev < 0 (the final step to x0)."""
    acp = _bcast(sched.alpha_cum_prod[torch.clamp(t_prev, min=0)], nd)
    return torch.where(_bcast(t_prev, nd) >= 0, acp, torch.ones_like(acp))


def ddim_step(sched: Schedule, xt: torch.Tensor, eps_hat: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor, noise: torch.Tensor, eta: float = 0.0, clip: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One DDIM step x_t -> x_{t_prev}; t_prev < 0 means the final step to x0."""
    acp_t = _bcast(sched.alpha_cum_prod[t], xt.dim())
    acp_prev = _acp_prev(sched, t_prev, xt.dim())
    x0 = (xt - torch.sqrt(1.0 - acp_t) * eps_hat) / torch.sqrt(acp_t)
    if clip:
        x0 = torch.clamp(x0, -1.0, 1.0)
    sigma = eta * torch.sqrt((1 - acp_prev) / (1 - acp_t)) * torch.sqrt(1 - acp_t / acp_prev)
    dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma**2, min=0.0)) * eps_hat
    return torch.sqrt(acp_prev) * x0 + dir_xt + sigma * noise, x0


def dpmpp_2m_step(sched: Schedule, xt: torch.Tensor, eps_hat: torch.Tensor, t: torch.Tensor,
                  t_prev: torch.Tensor, x0_prev: torch.Tensor, h_prev, clip: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) step x_t -> x_{t_prev}; returns (x_prev, x0, h).

    The caller carries (x0_prev, h_prev) between steps; h_prev <= 0 is the
    "no history" sentinel (the step is first order).  t_prev < 0 means the
    final step to x0, which is first order too.
    """
    nd = xt.dim()
    acp_t = _bcast(sched.alpha_cum_prod[t], nd)
    final = _bcast(t_prev, nd) < 0
    # keep the not-taken formula branch finite at acp_prev == 1
    acp_p = torch.clamp(_acp_prev(sched, t_prev, nd), max=1.0 - 1e-7)

    x0 = predict_x0(sched, xt, eps_hat, t, clip)

    def lam(a):
        return 0.5 * torch.log(a / (1.0 - a))

    h = lam(acp_p) - lam(acp_t)
    hp = torch.as_tensor(h_prev, dtype=h.dtype, device=h.device)
    if hp.dim():
        hp = _bcast(hp, nd)
    use_2nd = hp > 0
    r = hp / h
    coeff = torch.where(use_2nd, 1.0 / (2.0 * torch.where(use_2nd, r, torch.ones_like(r))),
                        torch.zeros_like(r))
    D = (1.0 + coeff) * x0 - coeff * x0_prev

    sigma_t = torch.sqrt(1.0 - acp_t)
    sigma_p = torch.sqrt(1.0 - acp_p)
    alpha_p = torch.sqrt(acp_p)
    x_formula = (sigma_p / sigma_t) * xt - alpha_p * torch.expm1(-h) * D
    return torch.where(final, x0, x_formula), x0, torch.mean(h)
