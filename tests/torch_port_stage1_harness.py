"""The end-to-end run's stage 1 through both packages' real trainers.

Each package's `VAETrainer.train()` trains the e2e run's stage-1 config
(`image_diffusion_torch.tools.e2e_synthetic_run.stage1_config`: lr 1e-4
after 100 warmup steps, clip 1, no discriminator or LPIPS, codebook 1024 /
0.25 / 0.99, prior weight 1 for VQ and 5e-6 for KL) at reduced widths on
the run's own data (`make_dataset` at a lower image size), and every
`every` steps a trace row is taken: the step's recon and prior losses, the
latents' state over a dev probe (`stage1_probe.trace_numbers`), and, for a
pair of runs, the distance between the two states.  Two modes:

  (a) `run_pair`: one state, one stream.  The port starts from the JAX
      trainer's initial variables (`compat.from_jax`) and is fed JAX's
      epoch permutations, flip masks and reparametrization noise; both run
      in fp32.  A third run, the port from the same state with every
      parameter moved by about one fp32 ulp (`perturb`), measures how far
      fp32 rounding alone carries two runs apart over the same steps.
  (b) `run_jax` / `run_port` alone: each package with its own draws, at a
      run seed each; the port from its own initial draw, or with
      `jax_init` from JAX's initial state (`jax_initial`).

After the last step a run also records its end numbers over the dev probe:
the mean reconstruction loss of the posterior-mean (KL) or quantized (VQ)
reconstructions, and for VQ the codebook's utilization and perplexity as
the e2e run computes them.

    python tests/torch_port_stage1_harness.py --mode a --bottleneck vq --out a_vq.json
    python tests/torch_port_stage1_harness.py --mode b --bottleneck kl --seeds 0 1 2 3 \\
        --out b_kl.json
    python tests/torch_port_stage1_harness.py --mode b --bottleneck vq --packages torch \\
        --jax-init --out b_vq_jax_init.json
    python tests/torch_port_stage1_harness.py --write-init vq_init.ckpt --bottleneck vq

`--write-init` writes the JAX trainer's initial VAE at the shipped widths
(`VAEArch()` with the e2e run's bottleneck; `--wide`: at `WIDE`) as a
model file, for `python -m image_diffusion_torch.tools.stage1_probe
--init-vae`; `--init-key K` draws it with params key K (the port's own
draws are `stage1_probe --init-seed`).

The slow tests in `test_torch_port_stage1_parity.py` run the same functions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from unittest import mock

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_diffusion_tpu.core import config as jcfg  # noqa: E402
from image_diffusion_tpu.core.logging import BasicLogger as JLogger  # noqa: E402
from image_diffusion_tpu.core.metrics import MetricHolder as JHolder  # noqa: E402
from image_diffusion_tpu.core.rng import epoch_key, root_key  # noqa: E402
from image_diffusion_tpu.core.rng import numpy_seed as jax_numpy_seed  # noqa: E402
from image_diffusion_tpu.training import losses as jlosses  # noqa: E402
from image_diffusion_tpu.training.data import ArrayDataset as JDataset  # noqa: E402
from image_diffusion_tpu.training.vae_trainer import VAETrainer as JTrainer  # noqa: E402
from image_diffusion_tpu.training.vae_trainer import normalize_batch as jnormalize  # noqa: E402
from image_diffusion_torch.compat.from_jax import vae_flax_variables, vae_state_dict  # noqa: E402
from image_diffusion_torch.core import config as tcfg  # noqa: E402
from image_diffusion_torch.core.logging import BasicLogger  # noqa: E402
from image_diffusion_torch.core.metrics import MetricHolder  # noqa: E402
from image_diffusion_torch.tools import e2e_synthetic_run as e2e  # noqa: E402
from image_diffusion_torch.tools.stage1_probe import trace_numbers, traced  # noqa: E402
from image_diffusion_torch.training import losses as tlosses  # noqa: E402
from image_diffusion_torch.training import vae_trainer as tvt  # noqa: E402
from image_diffusion_torch.training.data import ArrayDataset  # noqa: E402
from image_diffusion_torch.training.vae_trainer import VAEDraws, VAETrainer, normalize_batch  # noqa: E402

# the reduced widths of the whole-run modes: 3 levels and the mid-block attention as shipped
WIDE = dict(channels=(32, 64, 96), init_resolution=32)
# tier-1's: 3 levels at 32x32, GroupNorm of 4 groups
TINY = dict(channels=(8, 16, 16), init_resolution=32, num_groups=4)


@dataclasses.dataclass
class Setup:
    """One stage-1 run's sizes: the architecture's overrides of `VAEArch()`,
    images per class and their size, the batch, steps, the run seed, the
    codebook's gamma (None: the shipped 0.99), trace interval and dev
    probe images per class."""

    bottleneck: str
    arch: dict = dataclasses.field(default_factory=lambda: dict(WIDE))
    n_per_class: int = 2000
    batch: int = 48
    steps: int = 500
    seed: int = 0
    gamma: float | None = None
    every: int = 25
    dev_per_class: int = 80
    precision: str = "fp32"

    @property
    def res(self) -> int:
        return self.arch["init_resolution"]


def configs(s: Setup, out: str):
    """-> (JAX VAEConfig, port VAEConfig): `stage1_config` at `s`'s sizes,
    mirrored field for field into the JAX package's classes."""
    spe = 3 * s.n_per_class // s.batch
    tc = e2e.stage1_config(tcfg.VAEArch(**s.arch), s.bottleneck, s.batch,
                           max(s.steps // spe, 1), out, seed=s.seed, precision=s.precision)
    if s.gamma is not None:
        tc = dataclasses.replace(tc, arch=dataclasses.replace(tc.arch, codebook_gamma=s.gamma))
    jc = jcfg.VAEConfig(jcfg.VAEArch(**dataclasses.asdict(tc.arch)),
                        jcfg.VAETrainConfig(**dataclasses.asdict(tc.train)))
    return jc, tc


def data(s: Setup):
    """-> (training images, dev probe images), uint8 NHWC."""
    imgs, _ = e2e.make_dataset(s.n_per_class, size=s.res)
    dev, _ = e2e.make_dataset(s.dev_per_class, size=s.res, seed=777)
    return imgs, dev


def flat(leaves) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in leaves])


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def vq_end(counts: np.ndarray, n_images: int) -> dict:
    nums = e2e.vq_numbers(counts, n_images)
    return {"utilization": nums["vq_codebook_utilization"],
            "dev_perplexity": nums["vq_dev_perplexity"]}


# ------------------------------------------------------------------- JAX

_flax_init = nn.Module.init


def jitted_init(module, *args, **kwargs):
    """`flax.linen.Module.init` as one jitted program: the same variables
    as the op-by-op init the JAX trainer runs, several times faster on the
    CPU."""
    return jax.jit(lambda: _flax_init(module, *args, **kwargs))()


class JaxRun:
    """The JAX trainer at `s`, its step wrapped to record trace rows and
    (with `keep`) the parameters and codebook at each flush."""

    def __init__(self, s: Setup, imgs, dev, out: str, keep: bool = False):
        self.s, self.dev, self.keep = s, dev, keep
        jc, _ = configs(s, out)
        with mock.patch.object(nn.Module, "init", jitted_init):
            self.jt = JTrainer(jc, JDataset(imgs), None, JLogger(out, "jax", True, 50),
                               JHolder(50), run_name="jax")
        vae = self.jt.vae
        self.initial = jax.tree.map(np.array, {"params": self.jt.state.vae_params,
                                               **({"codebook": self.jt.state.codebook}
                                                  if s.bottleneck == "vq" else {})})

        def variables(params, codebook):
            return {"params": params, **({"codebook": codebook} if codebook is not None else {})}

        self._raw = jax.jit(lambda p, cb, x: vae.apply(
            variables(p, cb), jnormalize(x), method=lambda m, y: m.encoder(y)))
        self._codes = jax.jit(lambda p, cb, x: vae.apply(
            variables(p, cb), jnormalize(x), method="encode_indices"))
        self._recon = jax.jit(lambda p, cb, x: jlosses.recon_loss_per_sample(
            jnormalize(x), jnp.clip(vae.apply(variables(p, cb), jnormalize(x), sample=False)[0]
                                    .astype(jnp.float32), -1.0, 1.0)))
        self.rows, self.snaps = [], {}
        if keep:
            self.snaps[0] = (self.initial["params"], self.initial.get("codebook", {}).get("codebook"))
        step_fn = self.jt.train_step

        def step(state, x, rng, disc_active):
            new, metrics = step_fn(state, x, rng, disc_active=disc_active)
            n = int(new.step)
            if n % s.every == 0:
                self._record(n, new, metrics)
            return new, metrics

        self.jt.train_step = step

    def _trace(self, params, codebook) -> dict:
        b = self.s.batch
        raws = [np.asarray(self._raw(params, codebook, self.dev[i:i + b]), np.float32)
                for i in range(0, len(self.dev), b)]
        if self.s.bottleneck == "kl":
            return trace_numbers(np.concatenate(raws), "kl")
        codes = [np.asarray(self._codes(params, codebook, self.dev[i:i + b]))
                 for i in range(0, len(self.dev), b)]
        inner = codebook["codebook"]
        return trace_numbers(np.concatenate(raws), "vq", np.concatenate(codes),
                             np.asarray(inner["ema_cluster_size"]), np.asarray(inner["embeddings"]))

    def _record(self, n, state, metrics):
        self.rows.append({"step": n, "recon": float(metrics["vae/recon_loss"]),
                          "prior": float(metrics["vae/prior_loss"]),
                          **self._trace(state.vae_params, state.codebook)})
        if self.keep:  # copies: the next step donates these buffers
            self.snaps[n] = (jax.tree.map(np.array, state.vae_params),
                             None if state.codebook is None else
                             jax.tree.map(np.array, state.codebook["codebook"]))

    def train(self) -> dict:
        t0 = time.time()
        self.jt.train()
        st, b = self.jt.state, self.s.batch
        whole = len(self.dev) // b * b
        end = {"recon_loss": float(np.mean(np.concatenate(
            [np.asarray(self._recon(st.vae_params, st.codebook, self.dev[i:i + b]))
             for i in range(0, whole, b)])))}
        if self.s.bottleneck == "vq":
            codes = np.concatenate([np.asarray(self._codes(st.vae_params, st.codebook,
                                                           self.dev[i:i + b])).ravel()
                                    for i in range(0, whole, b)])
            end.update(vq_end(np.bincount(codes, minlength=self.jt.cfg.arch.codebook_size)
                              .astype(np.float64), whole))
        return {"package": "jax", "seed": self.s.seed, "rows": self.rows, "end": end,
                "seconds": round(time.time() - t0, 1)}


def run_jax(s: Setup, out: str | None = None) -> dict:
    """Mode (b), JAX: its own draws at run seed `s.seed`."""
    imgs, dev = data(s)
    with tempfile.TemporaryDirectory() as tmp:
        return JaxRun(s, imgs, dev, out or tmp).train()


# ------------------------------------------------------------------ port


def jax_stream(s: Setup, cfg):
    """JAX's epoch permutation seeds and per-step draws for the port: ->
    (numpy_seed of epoch e, VAEDraws of global step n)."""
    key = root_key(cfg.train.seed, offset=cfg.train.epochs)
    h = cfg.arch.latent_resolution

    def perm_seed(epoch: int) -> int:
        return jax_numpy_seed(epoch_key(key, epoch))

    def draws(epoch: int, step: int) -> VAEDraws:
        rng = jax.random.fold_in(epoch_key(key, epoch), step)
        k_flip, k_sample = jax.random.split(rng)
        flip = jax.random.bernoulli(k_flip, 0.5, (s.batch,))
        noise = jax.random.normal(k_sample, (s.batch, h, h, cfg.arch.z_dim), jnp.float32)
        return VAEDraws(torch.from_numpy(np.array(flip)), torch.from_numpy(np.array(noise)))

    return perm_seed, draws


def perturb(vae, seed: int = 1) -> None:
    """Move every parameter of `vae` by one fp32 ulp up or down at random:
    rounding-sized noise for the control run of mode (a)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in vae.parameters():
            sign = torch.from_numpy(rng.choice([-1.0, 1.0], p.shape).astype(np.float32))
            p.copy_(torch.nextafter(p, sign * torch.inf))


class PortRun:
    """The port's trainer at `s` on the CPU, traced every `s.every` steps
    (`stage1_probe.traced`); with `initial` (JAX variables) it starts from
    that state and, unless `own_draws`, takes JAX's permutations and draws
    (mode (a)); `keep` keeps the VAE's state dict before each step
    (`states`)."""

    def __init__(self, s: Setup, imgs, dev, out: str, initial: dict | None = None,
                 control: bool = False, snaps: dict | None = None, name: str = "port",
                 keep: bool = False, own_draws: bool = False):
        self.s, self.dev, self.snaps, self.states = s, dev, snaps, {}
        _, tc = configs(s, out)
        self.vt = VAETrainer(tc, ArrayDataset(imgs), None, BasicLogger(out, name, True, 50),
                             MetricHolder(50), run_name=name, device="cpu")
        vae = self.vt.state.vae
        self.names = [n for n, _ in vae.named_parameters()]
        self.patches = []
        if initial is not None:
            vae.load_state_dict(vae_state_dict(initial))
            if control:
                perturb(vae)
            self.p0 = flat(jax.tree.leaves(initial["params"]))
        if initial is not None and not own_draws:
            perm_seed, draws = jax_stream(s, tc)
            spe = 3 * s.n_per_class // s.batch
            # the epoch's seed is its index; its permutation JAX's
            self.patches = [mock.patch.object(tvt, "epoch_seed", lambda root, epoch: epoch),
                            mock.patch.object(tvt, "numpy_seed", perm_seed)]
            step_fn = self.vt.train_step

            def step(state, x, gen, disc_active):
                n = state.step
                return step_fn(state, x, draws(n // spe, n), disc_active)

            self.vt.train_step = step
        if keep:  # the VAE's state before each step
            inner = self.vt.train_step

            def keeping(state, *args, **kwargs):
                self.states[state.step] = {k: v.clone() for k, v in state.vae.state_dict().items()}
                return inner(state, *args, **kwargs)

            self.vt.train_step = keeping
        self.rows = []
        traced(self.vt, s.every, dev, self._record)

    def params(self) -> np.ndarray:
        tree = vae_flax_variables(dict(zip(self.names, self.vt.state.vae_opt.params)))["params"]
        return flat(jax.tree.leaves(tree))

    def codebook(self) -> dict:
        cb = self.vt.state.vae.codebook
        return {"embeddings": cb.embeddings.weight.numpy().copy(), "ema_w": cb.ema_w.numpy().copy(),
                "ema_cluster_size": cb.ema_cluster_size.numpy().copy()}

    def _record(self, row: dict) -> None:
        if self.snaps is not None:  # mode (a): the distance to JAX's state at this step
            ref, ref_cb = self.snaps[row["step"]]
            ref, mine = flat(jax.tree.leaves(ref)), self.params()
            row["param_rel"] = rel_l2(mine, ref)
            row["update_rel"] = rel_l2(mine - self.p0, ref - self.p0)
            if ref_cb is not None:
                cb = self.codebook()
                for k in ("embeddings", "ema_w", "ema_cluster_size"):
                    row[f"{k}_rel"] = rel_l2(cb[k].astype(np.float64), np.asarray(ref_cb[k]))
        self.rows.append(row)

    def train(self) -> dict:
        t0 = time.time()
        for p in self.patches:
            p.start()
        try:
            self.vt.train()
        finally:
            for p in self.patches:
                p.stop()
        vae, b = self.vt.state.vae, self.s.batch
        whole = len(self.dev) // b * b
        losses = []
        with torch.no_grad():
            for i in range(0, whole, b):
                x = normalize_batch(torch.from_numpy(self.dev[i:i + b]))
                x_hat = torch.clamp(vae(x, sample=False)[0].float(), -1.0, 1.0)
                losses.append(tlosses.recon_loss_per_sample(x, x_hat))
        end = {"recon_loss": float(torch.cat(losses).mean())}
        if self.s.bottleneck == "vq":
            end.update(vq_end(*e2e.code_counts(vae, self.dev[:whole], b, "cpu")))
        return {"package": "torch", "seed": self.s.seed, "rows": self.rows, "end": end,
                "seconds": round(time.time() - t0, 1)}


def jax_initial(s: Setup, res: int | None = None, key: int = 0) -> dict:
    """The JAX `VAETrainer`'s initial VAE variables at `s`'s architecture
    (its init with params key `key`, 0 in the trainer, and sample key 1 on
    a zero image of `res`, default `s.res`, at the compute dtype bf16; the
    draws do not depend on the dtype)."""
    from image_diffusion_tpu.models import build_vae as jbuild_vae

    jc, _ = configs(s, "unused")
    res = res or s.res
    vae = jbuild_vae(jc.arch, dtype=jnp.bfloat16)
    x0 = jnp.zeros((1, res, res, jc.arch.in_channels), jnp.float32)
    return jax.tree.map(np.asarray, jax.jit(lambda: vae.init(
        {"params": jax.random.key(key), "sample": jax.random.key(1)}, x0))())


def run_port(s: Setup, out: str | None = None, jax_init: bool = False) -> dict:
    """Mode (b), the port: its own draws at run seed `s.seed`, from its own
    initial draw or (`jax_init`) from JAX's."""
    imgs, dev = data(s)
    initial = jax_initial(s) if jax_init else None
    with tempfile.TemporaryDirectory() as tmp:
        res = PortRun(s, imgs, dev, out or tmp, initial=initial, own_draws=True).train()
    res.update(jax_init=jax_init)
    return res


def run_pair(s: Setup, control: bool = True, flips: bool = False) -> dict:
    """Mode (a): JAX, then the port from JAX's initial state on JAX's
    stream, each row holding its distance to JAX's state at that step;
    with `control`, the port again from the state moved by one ulp.  With
    `flips` (VQ, `s.every` 1): `parting`, the first step after which the
    two codebooks' cluster sizes part beyond 1e-5 (relative L2), and
    `flips`, `code_flips` at that step from each package's own state."""
    imgs, dev = data(s)
    with tempfile.TemporaryDirectory() as tmp:
        jr = JaxRun(s, imgs, dev, tmp, keep=True)
        res = {"jax": jr.train()}
        pr = PortRun(s, imgs, dev, tmp, initial=jr.initial, snaps=jr.snaps, keep=flips)
        res["torch"] = pr.train()
        if control:
            res["control"] = PortRun(s, imgs, dev, tmp, initial=jr.initial, control=True,
                                     snaps=jr.snaps, name="control").train()
        if flips:
            res["parting"] = next((r["step"] for r in res["torch"]["rows"]
                                   if r["ema_cluster_size_rel"] > 1e-5), None)
            if res["parting"] is not None:
                res["flips"] = code_flips(s, jr, imgs, res["parting"],
                                          pr.states[res["parting"] - 1])
    return res


def code_flips(s: Setup, jr: JaxRun, imgs: np.ndarray, step: int,
               port_state: dict | None = None) -> dict:
    """The VQ lookup of training step `step` (1-based) in both packages from
    JAX's state before it (`jr` kept with `every` 1), or the port's from
    `port_state` (its VAE's state dict before the step): the step's batch and
    flips as JAX draws them, each package's fp32 encoder tokens and
    nearest codes (JAX's jitted encoder and `nearest_code`, the port's on
    the converted state), and for the tokens whose codes differ the float64
    squared distances from each package's own token to its codebook ->
    {tokens, differ, gap (per differing token, the larger of the two
    packages' float64 gaps between its two nearest codes), median_gap (of
    every token of JAX's lookup), own (whether each package's code is the
    float64 nearest of its own token), token_rel (the largest
    |token_torch - token_jax| / |token_jax|)}."""
    from image_diffusion_tpu.models.vae import nearest_code as jnearest
    from image_diffusion_torch.models import build_vae
    from image_diffusion_torch.models.vae import nearest_code

    params, cb = jr.snaps[step - 1]
    _, tc = configs(s, "unused")
    perm_seed, draws = jax_stream(s, tc)
    spe = 3 * s.n_per_class // s.batch
    epoch, i = divmod(step - 1, spe)
    order = np.random.default_rng(perm_seed(epoch)).permutation(len(imgs))
    x = imgs[order[i * s.batch:(i + 1) * s.batch]]
    flip = draws(epoch, step - 1).flip
    emb = np.asarray(cb["embeddings"])
    port = build_vae(tc.arch, torch.float32, "cpu")
    port.load_state_dict(port_state or vae_state_dict({"params": params,
                                                       "codebook": {"codebook": cb}}))
    emb_t = port.codebook.embeddings.weight
    vae = jr.jt.vae
    tok_j = np.asarray(jax.jit(lambda p, x: vae.apply({"params": p}, x, method=lambda m, y: m.encoder(
        y)))(params, jnormalize(x, jnp.asarray(flip.numpy())))).reshape(-1, emb.shape[1])
    codes_j = np.asarray(jax.jit(jnearest)(tok_j, emb))
    with torch.no_grad():
        tok_t = port._encoder(normalize_batch(torch.from_numpy(x), flip)).reshape(-1, emb.shape[1])
        codes_t = nearest_code(tok_t, emb_t).numpy()
    tok_t = tok_t.numpy()
    differ = np.flatnonzero(codes_j != codes_t)

    def dist(tok, e):
        return ((tok.astype(np.float64)[:, None, :] - np.asarray(e, np.float64)[None]) ** 2).sum(-1)

    def gaps(d):
        return np.diff(np.sort(d, axis=1)[:, :2], axis=1)[:, 0]

    dj, dt = dist(tok_j[differ], emb), dist(tok_t[differ], emb_t.numpy())
    gap = np.maximum(gaps(dj), gaps(dt))
    own = bool((dj.argmin(1) == codes_j[differ]).all() and (dt.argmin(1) == codes_t[differ]).all())
    token_rel = float(np.max(np.linalg.norm(tok_t - tok_j, axis=1)
                             / np.maximum(np.linalg.norm(tok_j, axis=1), 1e-30)))
    return {"tokens": int(len(codes_j)), "differ": int(len(differ)), "gap": gap.tolist(),
            "median_gap": float(np.median(gaps(dist(tok_j, emb)))), "own": own,
            "token_rel": token_rel}


def write_init(path: str, bottleneck: str, wide: bool = False, key: int = 0) -> None:
    """The JAX trainer's initial VAE for the e2e run's stage 1 (`jax_initial`
    with params key `key`, the trainer's being 0) as a native model file, at
    the shipped widths or (`wide`) at `WIDE`."""
    from image_diffusion_torch.models.io import save_vae

    s = Setup(bottleneck, arch=dict(WIDE) if wide else {})
    arch = configs(s, "unused")[1].arch
    save_vae(path, arch, vae_state_dict(jax_initial(s, res=arch.init_resolution, key=key)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--write-init", default=None, metavar="PATH")
    p.add_argument("--init-key", type=int, default=0, help="--write-init: the init's params key.")
    p.add_argument("--wide", action="store_true", help="--write-init at the widths WIDE.")
    p.add_argument("--mode", choices=["a", "b"])
    p.add_argument("--bottleneck", choices=["kl", "vq"], required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--packages", nargs="+", choices=["jax", "torch"], default=["jax", "torch"])
    p.add_argument("--jax-init", action="store_true",
                   help="Mode b: the port starts from JAX's initial state.")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if args.write_init:
        write_init(args.write_init, args.bottleneck, args.wide, args.init_key)
        return
    torch.manual_seed(0)
    if args.mode == "a":
        res = run_pair(Setup(args.bottleneck, steps=args.steps))
    else:
        res = [run_jax(Setup(args.bottleneck, steps=args.steps, seed=seed)) if pkg == "jax" else
               run_port(Setup(args.bottleneck, steps=args.steps, seed=seed),
                        jax_init=args.jax_init)
               for seed in args.seeds for pkg in args.packages]
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
