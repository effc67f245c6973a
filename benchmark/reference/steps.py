"""The reference's sampler and train steps, over the functions of `nets.py`.

  * `ddim_update` / `ddim_sample`: classifier-free guided DDIM (eta 0) on
    the scaled-linear DDPM schedule, then the KL decoder.  Guidance is one call on
    [x, x] with the class ids and mask 1, then class 0 and mask 0;
    eps = eps_u + s (eps_c - eps_u); the x0 estimate is clamped to
    [-1, 1]; the last step goes to x0 (alpha-bar 1).
  * `unet_train`: the denoiser's steps: KL reparametrization of stored
    (mean || log_var) latents, q-sample at the drawn timesteps, the class
    condition dropped where the drop draw is at most `cond_drop_prob`,
    the MSE to the drawn noise, clipping by global norm, Adam with the
    linear warm-up from lr/100.
  * `vae_gan_train`: the stage-1 steps with the discriminator active: one
    VAE forward (x_hat clamped to [-1, 1]) serves both phases; phase 1
    takes the discriminator's BCE loss on the detached x_hat then on x
    and its clipped Adam step; phase 2 the VAE's LPIPS + MSE + L1 + KL +
    adversarial loss through the updated discriminator, and its clipped
    Adam step.
Both train functions return what the benchmark compares: each step's
losses, each leaf's first gradient as the optimizer took it (after the
clip), and the parameters after the last step.  `fault="half_batch"`
plants a fault for the benchmark's own test: each step sees only the first
half of its rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import nets


def alpha_bars(cfg: dict) -> np.ndarray:
    """alpha-bar_t of the schedule, computed in float64 and kept in fp32."""
    T = cfg["num_steps"]
    if cfg["noise_type"] != "linear":
        raise ValueError(f"the reference states the scaled-linear schedule, not "
                         f"{cfg['noise_type']}")
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, T, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_timesteps(T: int, n: int) -> list[int]:
    return np.linspace(0, T - 1, n).round().astype(np.int64)[::-1].tolist()


@torch.no_grad()
def ddim_update(Pu, uarch: dict, acp: np.ndarray, x, t, t_prev, labels, scales, q=nets.ident):
    """One guided DDIM step (eta 0) of every row: x at timesteps `t` (B,)
    to `t_prev` (B,), -1 meaning the last step to x0."""
    B = x.shape[0]
    ctx = torch.cat([labels, torch.zeros_like(labels)])
    mask = torch.cat([torch.ones(B, 1), torch.zeros(B, 1)]).to(x.device)
    e = nets.unet(Pu, uarch, torch.cat([x, x]), torch.cat([t, t]), ctx, mask, q)
    eps = e[B:] + scales.reshape(B, 1, 1, 1).float() * (e[:B] - e[B:])
    table = torch.as_tensor(acp, device=x.device)
    a_t = table[t].reshape(B, 1, 1, 1)
    a_p = torch.where(t_prev >= 0, table[t_prev.clamp(min=0)], 1.0).reshape(B, 1, 1, 1)
    x0 = torch.clamp((x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t), -1.0, 1.0)
    return torch.sqrt(a_p) * x0 + torch.sqrt(torch.clamp(1.0 - a_p, min=0.0)) * eps


@torch.no_grad()
def ddim_sample(Pu, uarch: dict, Pv, varch: dict, sched: dict, x, labels, scales, steps: int,
                q=nets.ident) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Initial latents (B, h, w, z), class ids (B,), guidance scales (B,)
    -> (images (B, H, W, 3), the latents before every step and the final
    one: steps + 1 tensors)."""
    acp = alpha_bars(sched)
    ts = ddim_timesteps(sched["num_steps"], steps)
    states = [x]
    for t, t_prev in zip(ts, ts[1:] + [-1]):
        tv = torch.full((x.shape[0],), t, device=x.device)
        x = ddim_update(Pu, uarch, acp, x, tv, torch.full_like(tv, t_prev), labels, scales, q)
        states.append(x)
    return nets.vae_decode(Pv, varch, x, q), states


class Adam:
    """Clipping by global norm (g / |g| * clip when |g| >= clip), then Adam
    (0.9, 0.999, eps 1e-8 outside the square root) at the warm-up
    schedule's learning rate for the update count before the update."""

    def __init__(self, params: dict, lr: float, warmup: int, clip: float | None):
        self.params, self.lr, self.warmup, self.clip = params, lr, warmup, clip
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def rate(self, step: int) -> float:
        low = self.lr / 100.0
        warm = low + (self.lr - low) * min(step / max(self.warmup, 1), 1.0)
        return warm if step < self.warmup else self.lr

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Apply `grads` (by name, None for a leaf the loss does not reach)
        -> the clipped gradients."""
        g = {k: grads[k] if grads[k] is not None else torch.zeros_like(p)
             for k, p in self.params.items()}
        norm = torch.sqrt(sum(t.double().pow(2).sum() for t in g.values())).float()
        if self.clip is not None:
            scale = torch.where(norm >= self.clip, self.clip / norm, torch.ones_like(norm))
            g = {k: t * scale for k, t in g.items()}
        lr = self.rate(self.count)
        self.count += 1
        c1, c2 = 1.0 - 0.9**self.count, 1.0 - 0.999**self.count
        for k, p in self.params.items():
            self.m[k].mul_(0.9).add_(g[k], alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g[k], g[k], value=0.001)
            p.sub_(lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + 1e-8))
        return g


class Trace(NamedTuple):
    """What the reference's train steps give the comparison: per step a
    dict of 0-d loss tensors, the first step's clipped gradients by leaf,
    and every trained leaf after the last step."""

    losses: list[dict]
    first_grads: dict
    params: dict


def _leaves(P0: dict, trainable: set[str]):
    params = {k: v.detach().float().clone().requires_grad_(True) for k, v in P0.items()
              if k in trainable}
    fixed = {k: v.detach().float() for k, v in P0.items() if k not in trainable}
    return params, fixed


def _grads(loss, params: dict) -> dict:
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return dict(zip(params, got))


def _half(fault: str | None, *tensors):
    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    return tuple(t[: t.shape[0] // 2] if fault else t for t in tensors)


def unet_train(P0: dict, trainable: set[str], uarch: dict, sched: dict, train: dict,
               batches: list, draws: list, q=nets.ident, block_rows: int | None = None,
               fault: str | None = None) -> Trace:
    """Steps of the denoiser from `P0` on `batches` [(stored latents fp16
    (B, h, w, 2z), class ids (B,))] and `draws` [(z_noise, t, noise, drop)],
    the loss's gradient summed over blocks of `block_rows` rows."""
    params, fixed = _leaves(P0, trainable)
    opt = Adam(params, train["learning_rate"], train["warmup_steps"], train["clip_grad"])
    acp = torch.as_tensor(alpha_bars(sched))
    losses, first = [], None
    for (lat, c), (z_noise, t, noise, drop) in zip(batches, draws):
        lat, c, z_noise, t, noise, drop = _half(fault, lat, c, z_noise, t, noise, drop)
        mean, log_var = torch.chunk(lat.float(), 2, dim=-1)
        x = mean + z_noise * torch.exp(0.5 * torch.clamp(log_var, -30.0, 20.0))
        a = acp.to(x.device)[t].reshape(-1, 1, 1, 1)
        xt = torch.sqrt(a) * x + torch.sqrt(1.0 - a) * noise
        mask = (drop > train["cond_drop_prob"]).float()[:, None]
        B = x.shape[0]
        step = block_rows or B
        total, acc = 0.0, {k: None for k in params}
        for r in range(0, B, step):
            rows = slice(r, min(r + step, B))
            with torch.enable_grad():
                eps = nets.unet({**params, **fixed}, uarch, xt[rows], t[rows], c[rows],
                                mask[rows], q)
                loss = ((eps - noise[rows]) ** 2).mean() * (eps.shape[0] / B)
                for k, g in _grads(loss, params).items():
                    if g is not None:
                        acc[k] = g if acc[k] is None else acc[k] + g
            total = total + loss.detach()
        g = opt.step(acc)
        first = first or {k: v.clone() for k, v in g.items()}
        losses.append({"loss": total})
    return Trace(losses, first, {k: v.detach() for k, v in params.items()})


def vae_gan_train(Pv0: dict, v_trainable: set[str], varch: dict, Pd0: dict, d_trainable: set[str],
                  W: dict, train: dict, images: list, draws: list, q=nets.ident,
                  fault: str | None = None) -> Trace:
    """Stage-1 steps with the discriminator active from (`Pv0`, `Pd0`) on
    uint8 NHWC `images` [(B, H, W, 3)] and `draws` [(flip (B,), noise (B, h,
    w, z))]; LPIPS weights `W`.  Leaves are named "vae.<name>" and
    "disc.<name>" in the trace."""
    vp, vfix = _leaves(Pv0, v_trainable)
    dp, dfix = _leaves(Pd0, d_trainable)
    W = {k: v.float() for k, v in W.items()}
    n_convs = sum(1 for k in Pd0 if k.startswith("convs.") and k.endswith(".weight"))
    v_opt = Adam(vp, train["learning_rate"], train["warmup_steps"], train["clip_grad"])
    d_opt = Adam(dp, train["learning_rate"], 0, train["clip_grad"])
    losses, first = [], None
    for u8, (flip, noise) in zip(images, draws):
        u8, flip, noise = _half(fault, u8, flip, noise)
        x = (u8.float() / 255.0 - 0.5) / 0.5
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        with torch.enable_grad():
            z, prior = nets.kl_sample(nets.vae_encode({**vp, **vfix}, varch, x, q), noise)
            x_hat = torch.clamp(nets.vae_decode({**vp, **vfix}, varch, z, q), -1.0, 1.0)
            D = {**dp, **dfix}
            d_loss = 0.5 * (nets.bce_with_logits(nets.discriminator(D, n_convs, x, q), 1.0)
                            + nets.bce_with_logits(
                                nets.discriminator(D, n_convs, x_hat.detach(), q), 0.0))
            gd = d_opt.step(_grads(train["disc_weight"] * d_loss, dp))
            diff = x_hat - x
            rl = (diff**2).mean() + diff.abs().mean()
            pl = nets.lpips(W, x, x_hat, q)
            g_loss = nets.bce_with_logits(nets.discriminator(D, n_convs, x_hat, q), 1.0)
            loss = (pl * train["percept_weight"] + rl * train["recon_weight"]
                    + prior * train["prior_weight"] + g_loss * train["disc_weight"])
            gv = v_opt.step(_grads(loss, vp))
        if first is None:
            first = {**{f"vae.{k}": v.clone() for k, v in gv.items()},
                     **{f"disc.{k}": v.clone() for k, v in gd.items()}}
        losses.append({"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                       "recon_loss": rl.detach(), "percept_loss": pl.detach(),
                       "prior_loss": prior.detach()})
    params = {**{f"vae.{k}": v.detach() for k, v in vp.items()},
              **{f"disc.{k}": v.detach() for k, v in dp.items()}}
    return Trace(losses, first, params)
