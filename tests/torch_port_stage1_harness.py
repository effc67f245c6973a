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
      in fp32.  Controls measure how far fp32 rounding alone carries two
      runs apart over the same steps: the port from the same state with
      every parameter moved by one fp32 ulp (`perturb`, `--controls N`:
      seeds 1..N) and JAX from its own state moved so (`perturb_jax`,
      `--jax-controls N`), each held, like the port, against the unmoved
      JAX run (`departures`).  For VQ the port's departure is outside
      rounding when it exceeds every control's on the live codes over
      steps 100-300, the end utilization or the end perplexity
      (`judged`, `RULE_KEYS`).  Pairs (`--jax-twins N`): JAX also from
      the states of port controls 1..N, so that the port and JAX start
      together from N + 1 shared states; per state the port's signed gain
      over JAX (`pairs`), and the paired rule (`paired`): a fault of the
      port moves every state's gain one way, rounding moves them both
      ways.  `--workers W` runs each run in a process of its own, W at a
      time on `--threads` cores each (default 2); XLA's results depend on
      its thread count, so hold runs against each other only within one
      such setting.
  (b) `run_jax` / `run_port` alone: each package with its own draws, at a
      run seed each; the port from its own initial draw, or with
      `jax_init` from JAX's initial state (`jax_initial`).

After the last step a run also records its end numbers over the dev probe:
the mean reconstruction loss of the posterior-mean (KL) or quantized (VQ)
reconstructions, and for VQ the codebook's utilization and perplexity as
the e2e run computes them.

    python tests/torch_port_stage1_harness.py --mode a --bottleneck vq --out a_vq.json
    python tests/torch_port_stage1_harness.py --mode a --bottleneck vq --controls 4 \\
        --jax-controls 2 --workers 4 --threads 2 --out a_vq_controls.json
    python tests/torch_port_stage1_harness.py --mode a --bottleneck vq --controls 7 \\
        --jax-twins 7 --workers 4 --out a_vq_pairs.json
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
import subprocess
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
    jc = jcfg.VAEConfig(jcfg._build(jcfg.VAEArch, tc.arch.to_dict()),
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


def distances(mine: np.ndarray, cb: dict | None, ref: np.ndarray, ref_cb: dict | None,
              p0: np.ndarray) -> dict:
    """A state's distance to a reference state at one step: of the flat
    parameters (`param_rel`), of their updates from the initial `p0`
    (`update_rel`) and of the codebook's arrays (relative L2)."""
    out = {"param_rel": rel_l2(mine, ref), "update_rel": rel_l2(mine - p0, ref - p0)}
    if ref_cb is not None:
        for k in ("embeddings", "ema_w", "ema_cluster_size"):
            out[f"{k}_rel"] = rel_l2(np.asarray(cb[k], np.float64),
                                     np.asarray(ref_cb[k], np.float64))
    return out


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


def perturb_jax(params, seed: int):
    """`params` (a tree of fp32 arrays) with every element moved by one fp32
    ulp up or down at random (`np.nextafter`): `perturb` for the JAX
    trainer's initial state."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        sign = rng.choice([-1.0, 1.0], x.shape).astype(np.float32)
        return jnp.asarray(np.nextafter(x, sign * np.float32(np.inf)))

    return jax.tree.map(move, params)


def port_moved(s: Setup, initial: dict, seed: int) -> dict:
    """JAX's initial `params` moved exactly as the port control of `seed`
    moves them (`perturb` on the port's VAE loaded from `initial`), back
    in JAX's layout: the state a JAX twin of that control starts from."""
    from image_diffusion_torch.models import build_vae

    vae = build_vae(configs(s, "unused")[1].arch, torch.float32, "cpu")
    vae.load_state_dict(vae_state_dict(initial))
    perturb(vae, seed)
    named = {n: p.detach() for n, p in vae.named_parameters()}
    return jax.tree.map(jnp.asarray, vae_flax_variables(named)["params"])


class JaxRun:
    """The JAX trainer at `s`, its step wrapped to record trace rows and
    (with `keep`) the parameters and codebook at each flush; with
    `perturb` (a seed, 0: none) its initial parameters moved by one ulp
    (`perturb_jax`), the JAX control of mode (a), or with `twin` as the
    port control of that seed moves them (`port_moved`)."""

    def __init__(self, s: Setup, imgs, dev, out: str, keep: bool = False, perturb: int = 0,
                 name: str = "jax", twin: bool = False):
        self.s, self.dev, self.keep, self.perturb, self.twin = s, dev, keep, perturb, twin
        jc, _ = configs(s, out)
        with mock.patch.object(nn.Module, "init", jitted_init):
            self.jt = JTrainer(jc, JDataset(imgs), None, JLogger(out, name, True, 50),
                               JHolder(50), run_name=name)
        if perturb:
            st = self.jt.state
            state = {"params": st.vae_params,
                     **({"codebook": st.codebook} if st.codebook is not None else {})}
            moved = (port_moved(s, jax.tree.map(np.array, state), perturb) if twin
                     else perturb_jax(st.vae_params, perturb))
            self.jt.state = st.replace(vae_params=moved)
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
        return {"package": "jax", "seed": self.s.seed, "perturb": self.perturb,
                "twin": self.twin, "rows": self.rows, "end": end,
                "seconds": round(time.time() - t0, 1)}

    def trail(self) -> dict:
        """The kept states as {step: (flat parameters, codebook or None)}."""
        return {n: (flat(jax.tree.leaves(p)), cb) for n, (p, cb) in self.snaps.items()}


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
    that state, moved by one ulp with `control` (`perturb`'s seed, 0:
    none), and, unless `own_draws`, takes JAX's permutations and draws
    (mode (a)); each row holds its distance to JAX's state `snaps` at that
    step; `trail` keeps the state at each row (`trail()`); `keep` keeps the
    VAE's state dict before each step (`states`)."""

    def __init__(self, s: Setup, imgs, dev, out: str, initial: dict | None = None,
                 control: int = 0, snaps: dict | None = None, name: str = "port",
                 keep: bool = False, own_draws: bool = False, trail: bool = False):
        self.s, self.dev, self.snaps, self.states = s, dev, snaps, {}
        self.control, self._trail = control, {} if trail else None
        _, tc = configs(s, out)
        self.vt = VAETrainer(tc, ArrayDataset(imgs), None, BasicLogger(out, name, True, 50),
                             MetricHolder(50), run_name=name, device="cpu")
        vae = self.vt.state.vae
        self.names = [n for n, _ in vae.named_parameters()]
        self.patches = []
        if initial is not None:
            vae.load_state_dict(vae_state_dict(initial))
            if control:
                perturb(vae, control)
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
        if self.snaps is not None or self._trail is not None:
            mine = self.params()
            cb = self.codebook() if self.s.bottleneck == "vq" else None
            if self.snaps is not None:  # mode (a): the distance to JAX's state at this step
                ref, ref_cb = self.snaps[row["step"]]
                row.update(distances(mine, cb, flat(jax.tree.leaves(ref)), ref_cb, self.p0))
            if self._trail is not None:
                self._trail[row["step"]] = (mine, cb)
        self.rows.append(row)

    def trail(self) -> dict:
        """The states kept at the rows as {step: (flat parameters in JAX's
        leaf order, codebook or None)}."""
        return self._trail

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
        return {"package": "torch", "seed": self.s.seed, "perturb": self.control,
                "rows": self.rows, "end": end,
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


def run_pair(s: Setup, controls: int = 1, jax_controls: int = 0, flips: bool = False,
             workers: int = 0, threads: int = 2, jax_twins: int = 0) -> dict:
    """Mode (a): JAX, then the port from JAX's initial state on JAX's
    stream, each row holding its distance to JAX's state at that step
    (`distances`), and the controls of rounding: `controls` port runs from
    the state moved by one ulp (`perturb` seeds 1, 2, ...) and
    `jax_controls` JAX runs from its own state moved by one ulp
    (`perturb_jax` seeds 1, 2, ...), each also held against the unmoved JAX
    run, and `jax_twins` JAX runs from the states of the first port
    controls (`port_moved`), each pair of one state held together.  ->
    {jax, torch, controls, jax_controls, jax_twins} with `judged`'s
    verdicts.  With `workers`, each run is a process of its own, `workers`
    at a time on `threads` cores each (`in_workers`); JAX controls and
    twins run only so.  In process (the port's controls alone), `flips`
    (VQ, `s.every` 1) adds `parting`, the first step after which the two
    codebooks' cluster sizes part beyond 1e-5 (relative L2), and `flips`,
    `code_flips` at that step from each package's own state."""
    if workers:
        assert not flips, "flips needs the runs in one process"
        return in_workers(s, controls, jax_controls, workers, threads, jax_twins)
    assert not (jax_controls or jax_twins), "JAX controls and twins run in workers"
    imgs, dev = data(s)
    with tempfile.TemporaryDirectory() as tmp:
        jr = JaxRun(s, imgs, dev, tmp, keep=True)
        res = {"jax": jr.train()}
        pr = PortRun(s, imgs, dev, tmp, initial=jr.initial, snaps=jr.snaps, keep=flips)
        res["torch"] = pr.train()
        res["controls"] = [PortRun(s, imgs, dev, tmp, initial=jr.initial, control=k,
                                   snaps=jr.snaps, name=f"control{k}").train()
                           for k in range(1, controls + 1)]
        res["jax_controls"] = []
        if flips:
            res["parting"] = next((r["step"] for r in res["torch"]["rows"]
                                   if r["ema_cluster_size_rel"] > 1e-5), None)
            if res["parting"] is not None:
                res["flips"] = code_flips(s, jr, imgs, res["parting"],
                                          pr.states[res["parting"] - 1])
    return judged(res, s.bottleneck)


def add_distances(run: dict, trail: dict, ref: dict, p0: np.ndarray) -> None:
    """Each row of `run` gains its `distances` to the reference trail `ref`
    at that step, from `run`'s own trail."""
    for row in run["rows"]:
        mine, cb = trail[row["step"]]
        row.update(distances(mine, cb, ref[row["step"]][0], ref[row["step"]][1], p0))


def save_trail(path: str, trail: dict) -> None:
    arrays = {}
    for n, (p, cb) in trail.items():
        arrays[f"p{n}"] = np.asarray(p, np.float32)  # the values are fp32
        for k, v in (cb or {}).items():
            arrays[f"{k}{n}"] = np.asarray(v, np.float32)
    np.savez(path, **arrays)


def load_trail(path: str) -> dict:
    with np.load(path) as z:
        steps = sorted(int(k[1:]) for k in z.files if k.startswith("p") and k[1:].isdigit())
        return {n: (z[f"p{n}"].astype(np.float64),
                    {k: z[f"{k}{n}"] for k in ("embeddings", "ema_w", "ema_cluster_size")}
                    if f"embeddings{n}" in z.files else None) for n in steps}


def one_run(s: Setup, package: str, perturb: int, trail_path: str) -> dict:
    """One run of mode (a) in a process of its own: JAX (`perturb` 0), a
    JAX control or (`package` "twin") a JAX twin of a port control, or the
    port from JAX's initial state (built by the JAX trainer, as in
    process) or a port control; its trail is written to `trail_path` for
    `in_workers` to hold against the JAX run's."""
    imgs, dev = data(s)
    with tempfile.TemporaryDirectory() as tmp:
        if package in ("jax", "twin"):
            run = JaxRun(s, imgs, dev, tmp, keep=True, perturb=perturb, twin=package == "twin")
            res = run.train()
        else:
            initial = JaxRun(s, imgs, dev, tmp).initial
            run = PortRun(s, imgs, dev, tmp, initial=initial, control=perturb, trail=True)
            res = run.train()
    save_trail(trail_path, run.trail())
    return res


def in_workers(s: Setup, controls: int, jax_controls: int, workers: int, threads: int,
               jax_twins: int = 0) -> dict:
    """`run_pair` with every run a process of this script (`--worker`),
    `workers` at a time, each given `threads` torch threads and, where the
    machine has the cores, its own `threads` cores (so that XLA's thread
    pools do not contend), the JAX runs first; the rows' distances are
    computed from the trails the runs write."""
    assert jax_twins <= controls, "a JAX twin needs its port control"
    jobs = ([("jax", 0)] + [("jax", k) for k in range(1, jax_controls + 1)]
            + [("twin", k) for k in range(1, jax_twins + 1)]
            + [("torch", 0)] + [("torch", k) for k in range(1, controls + 1)])
    done = run_workers(s, jobs, workers, threads)
    ref = done["jax", 0][1]
    p0 = ref[0][0]
    for key, (run, trail) in done.items():
        if key != ("jax", 0):
            add_distances(run, trail, ref, p0)
    return judged({"jax": done["jax", 0][0], "torch": done["torch", 0][0],
                   "controls": [done["torch", k][0] for k in range(1, controls + 1)],
                   "jax_controls": [done["jax", k][0] for k in range(1, jax_controls + 1)],
                   "jax_twins": [done["twin", k][0] for k in range(1, jax_twins + 1)]},
                  s.bottleneck)


def run_workers(s: Setup, jobs: list, workers: int, threads: int) -> dict:
    """Each job (package, perturb seed) a process of this script,
    `workers` at a time -> {job: (result, trail)}."""
    cores = sorted(os.sched_getaffinity(0))
    pin = len(cores) >= workers * threads
    here = os.path.abspath(__file__)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    with tempfile.TemporaryDirectory() as tmp:
        setup = os.path.join(tmp, "setup.json")
        with open(setup, "w") as f:
            json.dump(dataclasses.asdict(s), f)
        todo, running, done = list(jobs), {}, {}
        while todo or running:
            for slot in range(workers):
                if slot in running or not todo:
                    continue
                pkg, k = job = todo.pop(0)
                stem = os.path.join(tmp, f"{pkg}{k}")
                mine = set(cores[slot * threads:(slot + 1) * threads]) if pin else None
                log = open(stem + ".log", "w")
                proc = subprocess.Popen(
                    [sys.executable, here, "--worker", pkg, "--perturb", str(k), "--setup", setup,
                     "--bottleneck", s.bottleneck, "--threads", str(threads),
                     "--out", stem + ".json"],
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                    preexec_fn=(lambda c=mine: os.sched_setaffinity(0, c)) if pin else None)
                running[slot] = (job, stem, proc, log)
            time.sleep(2)
            for slot, (job, stem, proc, log) in list(running.items()):
                if proc.poll() is None:
                    continue
                log.close()
                del running[slot]
                if proc.returncode:
                    for _, _, other, _ in running.values():
                        other.kill()
                    with open(stem + ".log") as f:
                        raise RuntimeError(f"run {job} failed:\n{f.read()[-4000:]}")
                with open(stem + ".json") as f:
                    done[job] = (json.load(f), load_trail(stem + ".npz"))
    return done


def departures(run: dict, ref: dict, keys: list[str], end_keys: list[str],
               window: tuple[int, int] | None = None) -> dict:
    """The largest departure of `run` from `ref` over the trace rows (those
    of steps inside `window` if given), per key (relative to `ref`'s value,
    absolute for the code counts), and at the end (absolute for the
    utilization, relative otherwise)."""
    out = {}
    for k in keys:
        d = [abs(r[k] - f[k]) / (1.0 if k.endswith("codes") else abs(f[k]))
             for r, f in zip(run["rows"], ref["rows"])
             if window is None or window[0] <= f["step"] <= window[1]]
        out[k] = max(d)
    for k in end_keys:
        d = abs(run["end"][k] - ref["end"][k])
        out[f"end_{k}"] = d if k == "utilization" else d / abs(ref["end"][k])
    return out


def traced_keys(bottleneck: str) -> tuple[list[str], list[str]]:
    """-> (the trace rows' keys, the end numbers' keys) held in mode (a)."""
    keys = ["recon", "latent_rms"] + (["posterior_std"] if bottleneck == "kl" else
                                      ["live_codes", "probe_codes"])
    return keys, ["recon_loss"] + (["utilization", "dev_perplexity"] if bottleneck == "vq" else [])


# the rule that tells the port's departure from rounding (VQ): the live
# codes over steps 100-300, the end utilization and the end perplexity
RULE_WINDOW = (100, 300)
RULE_KEYS = ("live_codes_100_300", "end_utilization", "end_dev_perplexity")


# the paired rule's keys (VQ): the port's signed gain over JAX from one
# shared state, in the mean live codes over `RULE_WINDOW` and the end numbers
PAIR_KEYS = ("live_codes_gain_100_300", "end_utilization_gain", "end_dev_perplexity_gain",
             "end_recon_loss_gain")


def judged(res: dict, bottleneck: str) -> dict:
    """`res` of mode (a) with `departures`: each run's from the unmoved JAX
    run ({torch, control1.., jax_control1..} -> key -> departure, plus
    `live_codes_100_300` for VQ), and for VQ with controls `verdict`
    (`verdict`): per key of `RULE_KEYS`, the port's departure, the largest
    control's (port and JAX controls alike; JAX twins are not controls of
    the rule) and whether the port's lies outside it; `outside` if any
    does.  With JAX twins (VQ), `pairs`: state k's port run (the port,
    then control k) against the JAX run from that state, with the port's
    signed gains of `PAIR_KEYS`, and `paired` (`paired`)."""
    runs = {"torch": res["torch"]}
    runs.update({f"control{k}": r for k, r in enumerate(res["controls"], 1)})
    runs.update({f"jax_control{k}": r for k, r in enumerate(res["jax_controls"], 1)})
    runs.update({f"jax_twin{k}": r for k, r in enumerate(res.get("jax_twins") or [], 1)})
    deps = {name: run_departures(run, res["jax"], bottleneck) for name, run in runs.items()}
    res["departures"] = deps
    twins = res.get("jax_twins") or []
    if twins and bottleneck == "vq":  # each state's port run against JAX's from that state
        res["pairs"] = {}
        for k, (port, jax_run) in enumerate(zip([res["torch"]] + res["controls"],
                                                [res["jax"]] + twins)):
            res["pairs"][f"state{k}"] = pair = run_departures(port, jax_run, bottleneck)
            pair["live_codes_gain_100_300"] = float(np.mean(
                [r["live_codes"] - f["live_codes"] for r, f in zip(port["rows"], jax_run["rows"])
                 if RULE_WINDOW[0] <= f["step"] <= RULE_WINDOW[1]]))
            for k2 in ("utilization", "dev_perplexity", "recon_loss"):
                pair[f"end_{k2}_gain"] = port["end"][k2] - jax_run["end"][k2]
        res["paired"] = paired(res["pairs"])
    ctl = [n for n in deps if n.startswith(("control", "jax_control"))]
    if bottleneck == "vq" and ctl:
        res["verdict"] = verdict(deps["torch"], [deps[n] for n in ctl])
    return res


def run_departures(run: dict, jax_run: dict, bottleneck: str) -> dict:
    """`departures` of `run` from the unmoved JAX run on every traced key
    and end number, plus for VQ `live_codes_100_300` where the run has
    rows in `RULE_WINDOW`."""
    keys, ends = traced_keys(bottleneck)
    deps = departures(run, jax_run, keys, ends)
    if bottleneck == "vq" and any(RULE_WINDOW[0] <= r["step"] <= RULE_WINDOW[1]
                                  for r in jax_run["rows"]):
        deps["live_codes_100_300"] = departures(run, jax_run, ["live_codes"], [],
                                                RULE_WINDOW)["live_codes"]
    return deps


def verdict(port: dict, controls: list[dict]) -> dict:
    """The rule on the port's departures against the controls': per key of
    `RULE_KEYS` present, the port's, the largest control's and whether
    the port's exceeds it; `outside` if any does."""
    out = {k: {"port": port[k], "largest_control": max(c[k] for c in controls),
               "outside": port[k] > max(c[k] for c in controls)}
           for k in RULE_KEYS if k in port}
    out["outside"] = any(v["outside"] for v in out.values())
    return out


def paired(pairs: dict) -> dict:
    """The paired rule over the shared states of `pairs`: per key of
    `PAIR_KEYS`, the port's gains over JAX, their mean, and `consistent`,
    whether every state's gain has one sign.  Rounding moves a pair either
    way, so over N states it gives one sign on a key with chance 2 / 2**N
    (1 in 128 at 8 states); a fault of the port moves them all one way.
    `consistent` if any key is."""
    out = {}
    for k in PAIR_KEYS:
        gains = [p[k] for p in pairs.values()]
        out[k] = {"gains": gains, "mean": float(np.mean(gains)),
                  "consistent": all(g > 0 for g in gains) or all(g < 0 for g in gains)}
    out["consistent"] = any(v["consistent"] for v in out.values())
    return out


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


def table(res: dict) -> str:
    """Mode (a)'s departures from the unmoved JAX run as text, a run a
    line, then the verdict."""
    deps = res["departures"]
    keys = list(next(iter(deps.values())))
    lines = ["run " + " ".join(keys)]
    lines += [f"{name} " + " ".join(f"{d[k]:.4g}" for k in keys) for name, d in deps.items()]
    if "verdict" in res:
        lines.append("verdict: " + json.dumps(res["verdict"]))
    for name, pair in res.get("pairs", {}).items():
        lines.append(f"{name} port - jax: " + json.dumps(pair))
    if "paired" in res:
        lines.append("paired: " + json.dumps(res["paired"]))
    return "\n".join(lines)


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
    p.add_argument("--controls", type=int, default=1,
                   help="Mode a: port runs moved by one ulp (perturb seeds 1..N).")
    p.add_argument("--jax-controls", type=int, default=0,
                   help="Mode a: JAX runs moved by one ulp (perturb_jax seeds 1..N).")
    p.add_argument("--jax-twins", type=int, default=0,
                   help="Mode a with --workers: JAX runs from the states of port controls "
                        "1..N, each a pair with that control (the paired rule).")
    p.add_argument("--workers", type=int, default=0,
                   help="Mode a: run each run in a process of its own, this many at a time.")
    p.add_argument("--threads", type=int, default=None,
                   help="Torch threads (a worker's; default: torch's own, 2 for --workers).")
    p.add_argument("--worker", choices=["jax", "twin", "torch"], help=argparse.SUPPRESS)
    p.add_argument("--perturb", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--setup", help=argparse.SUPPRESS)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if args.write_init:
        write_init(args.write_init, args.bottleneck, args.wide, args.init_key)
        return
    if args.threads:
        torch.set_num_threads(args.threads)
    torch.manual_seed(0)
    if args.worker:
        with open(args.setup) as f:
            d = json.load(f)
        d["arch"] = {k: tuple(v) if isinstance(v, list) else v for k, v in d["arch"].items()}
        res = one_run(Setup(**d), args.worker, args.perturb, args.out[:-len(".json")] + ".npz")
    elif args.mode == "a":
        res = run_pair(Setup(args.bottleneck, steps=args.steps), controls=args.controls,
                       jax_controls=args.jax_controls, workers=args.workers,
                       threads=args.threads or 2, jax_twins=args.jax_twins)
        print(table(res))
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
