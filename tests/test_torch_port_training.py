"""The port's stage-2 training against the JAX package's, on the CPU: one
fp32 train step from the same parameters, batch and draws, the optimizer
pieces, accumulation, EMA, the fp32-parameter policy in bf16-compute mode,
trainer checkpoints across packages, data order, configs and the CLI."""

import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from image_diffusion_tpu.core import checkpoint as jckpt
from image_diffusion_tpu.core import config as jcfg
from image_diffusion_tpu.core.logging import BasicLogger as JLogger
from image_diffusion_tpu.core.metrics import MetricHolder as JHolder
from image_diffusion_tpu.models import build_unet as jbuild_unet
from image_diffusion_tpu.models.vae import VAE as JVAE
from image_diffusion_tpu.ops import schedule as JS
from image_diffusion_tpu.training import data as jdata
from image_diffusion_tpu.training.diffusion_trainer import DiffusionTrainer as JTrainer
from image_diffusion_tpu.training.diffusion_trainer import EMATrainState, make_optimizer
from image_diffusion_tpu.training.diffusion_trainer import make_train_step as jmake_train_step
from image_diffusion_torch.compat.from_jax import unet_flax_params, unet_state_dict
from image_diffusion_torch.core import config as tcfg
from image_diffusion_torch.core import rng as trng
from image_diffusion_torch.core.logging import BasicLogger
from image_diffusion_torch.core.metrics import MetricHolder
from image_diffusion_torch.models import build_unet
from image_diffusion_torch.models.vae import VAE
from image_diffusion_torch.ops import schedule as TS
from image_diffusion_torch.training import data as tdata
from image_diffusion_torch.training.diffusion_trainer import (
    DiffusionTrainer,
    Draws,
    Optimizer,
    TrainState,
    clip_by_global_norm_,
    global_norm,
    make_train_step,
    warmup_schedule,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16,
            num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, batch_size=4, epochs=1, clip_grad=1.0,
             precision="fp32", seed=0, log_interval=1)
T_STEPS = 50
STEPS = 3
RNG = jax.random.key(9)


def configs(tmp, **over):
    """The same tiny config (tests/test_trainers.py's) in both packages."""
    train = {**TRAIN, "checkpoints_dir": str(tmp), "logs_dir": str(tmp), **over}
    j = jcfg.DiffusionConfig(jcfg.UNetArch(**ARCH), jcfg.ScheduleConfig(num_steps=T_STEPS),
                             jcfg.DiffusionTrainConfig(**train))
    t = tcfg.DiffusionConfig(tcfg.UNetArch(**ARCH), tcfg.ScheduleConfig(num_steps=T_STEPS),
                             tcfg.DiffusionTrainConfig(**train))
    return j, t


def batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, 6)).astype(np.float32)  # (mean || log_var) NHWC
    c = np.arange(4, dtype=np.int32) % 3
    return x, c


def jax_draws(step, x_shape):
    """The draws of the JAX step body (`make_train_step._body`), in order."""
    k_rep, k_t, k_noise, k_drop = jax.random.split(jax.random.fold_in(RNG, step), 4)
    B = x_shape[0]
    z = x_shape[:-1] + (x_shape[-1] // 2,)
    draws = (jax.random.normal(k_rep, z, jnp.float32), jax.random.randint(k_t, (B,), 0, T_STEPS),
             jax.random.normal(k_noise, z, jnp.float32), jax.random.uniform(k_drop, (B,)))
    return Draws(*(torch.from_numpy(np.array(d)) for d in draws))


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def jax_run():
    """STEPS fp32 JAX train steps (one jit) from seed-1 parameters: the
    parameters, Adam moments and metrics after each step, and the state."""
    model = jbuild_unet(jcfg.UNetArch(**ARCH), dtype=jnp.float32)
    sched = JS.make_schedule(T_STEPS, 1e-4, 0.02, "linear")
    x, c = batch()
    variables = model.init(jax.random.key(1), x[..., :3], jnp.zeros((4,), jnp.int32), c)
    params0 = jax.tree.map(np.asarray, variables["params"])
    state = EMATrainState.create(apply_fn=model.apply, params=variables["params"],
                                 tx=make_optimizer(TRAIN["learning_rate"], TRAIN["warmup_steps"],
                                                   TRAIN["clip_grad"]), ema_params=None)
    step = jmake_train_step(model, sched, 0.15, reparametrize=True)
    history = []
    for _ in range(STEPS):
        state, metrics = step(state, x, c, RNG)
        adam = state.opt_state[1][0]
        history.append(dict(params=jax.tree.map(np.asarray, state.params),
                            mu=jax.tree.map(np.asarray, adam.mu),
                            loss=float(metrics["unet/loss"]), grad=float(metrics["unet/grad"])))
    return params0, history, state


def port_state(params, dtype=torch.float32, **opt):
    unet = build_unet(tcfg.UNetArch(**ARCH), dtype, "cpu", param_dtype=torch.float32)
    unet.load_state_dict(unet_state_dict(params))
    kw = {"learning_rate": TRAIN["learning_rate"], "warmup_steps": TRAIN["warmup_steps"],
          "clip_grad": TRAIN["clip_grad"], **opt}
    return TrainState(unet, Optimizer(unet.parameters(), **kw))


def flax_tree(state: TrainState, tensors):
    return unet_flax_params(dict(zip([n for n, _ in state.unet.named_parameters()], tensors)))


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_one_fp32_step_matches_jax(jax_run):
    params0, history, _ = jax_run
    state = port_state(params0)
    step = make_train_step(TS.make_schedule(T_STEPS), 0.15, reparametrize=True)
    x, c = (torch.from_numpy(a) for a in batch())
    for i, ref in enumerate(history):
        metrics = step(state, x, c, jax_draws(i, x.shape))
        assert float(metrics["unet/loss"]) == pytest.approx(ref["loss"], rel=1e-4)
        assert float(metrics["unet/grad"]) == pytest.approx(ref["grad"], rel=1e-4)
        if i == 0:
            # mu after one step is 0.1 x the clipped gradient: the fp32 bar
            # of tests/test_torch_parity.py, per tensor.  The 1e-9 floor is
            # for the to_k biases, whose gradient is zero but for fp noise
            # (~1e-11): softmax is invariant to a shift of every key's score
            mu = flax_tree(state, state.optimizer.moments()[0])
            for a, b in zip(leaves(mu), leaves(ref["mu"])):
                assert np.linalg.norm(a - b) < 2e-4 * np.linalg.norm(b) + 1e-9
    # after STEPS updates, compared on the update p - p0 over all
    # parameters: Adam divides by sqrt(nu), which magnifies the fp
    # differences of near-zero gradients to lr-sized differences per
    # element, so the per-tensor bar of the gradients does not apply
    p = leaves(flax_tree(state, state.optimizer.params))
    got = np.concatenate([(a - b).ravel() for a, b in zip(p, leaves(params0))])
    ref = np.concatenate([(a - b).ravel() for a, b in zip(leaves(history[-1]["params"]),
                                                         leaves(params0))])
    assert rel_l2(got, ref) < 1e-3
    assert state.step == STEPS


def test_grad_accum_matches_single_shot(jax_run):
    params0 = jax_run[0]
    x, c = (torch.from_numpy(a) for a in batch())
    draws = jax_draws(0, x.shape)
    out = []
    for accum in (1, 2):
        state = port_state(params0)
        metrics = make_train_step(TS.make_schedule(T_STEPS), 0.15, True, grad_accum=accum)(
            state, x, c, draws)
        out.append((metrics, torch.cat([m.flatten() for m in state.optimizer.moments()[0]])))
    (m1, mu1), (m2, mu2) = out
    assert float(m2["unet/loss"]) == pytest.approx(float(m1["unet/loss"]), rel=1e-6)
    assert float(m2["unet/grad"]) == pytest.approx(float(m1["unet/grad"]), rel=1e-5)
    torch.testing.assert_close(mu2, mu1, atol=1e-7, rtol=0)


def test_warmup_schedule_matches_reference_formula():
    lr, warm = 5e-5, 500
    f = warmup_schedule(lr, warm)
    for step in [0, 1, 250, 499, 500, 501, 10_000]:
        expect = lr / 100 + (lr - lr / 100) * (step / warm) if step < warm else lr
        assert f(step) == pytest.approx(expect, rel=1e-12)
    assert warmup_schedule(lr, 0)(0) == lr


@pytest.mark.parametrize("scale", [0.01, 10.0])  # below and above the clip
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32) * scale,
            "b": rng.normal(size=(5,)).astype(np.float32) * scale}
    tx = optax.clip_by_global_norm(1.0)
    ref, _ = tx.update(jax.tree.map(jnp.asarray, tree), tx.init(tree))
    grads = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
    norm = global_norm(grads)
    assert float(norm) == pytest.approx(float(optax.global_norm(tree)), rel=1e-6)
    clip_by_global_norm_(grads, norm, 1.0)
    for k, g in zip(("a", "b"), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[k]), rtol=1e-6, atol=0)


def test_ema_update(jax_run):
    state = port_state(jax_run[0])
    state.ema = [p.detach().clone() for p in state.optimizer.params]
    p0 = [p.detach().clone() for p in state.optimizer.params]
    x, c = (torch.from_numpy(a) for a in batch())
    make_train_step(TS.make_schedule(T_STEPS), 0.15, True, ema_decay=0.9)(
        state, x, c, jax_draws(0, x.shape))
    for e, a, b in zip(state.ema, p0, state.optimizer.params):
        torch.testing.assert_close(e, a * 0.9 + b.detach() * 0.1, atol=1e-7, rtol=1e-6)
        assert e.dtype == torch.float32


def test_parameters_move_in_bf16_compute_mode(jax_run):
    """fp32 parameters under bf16 compute: 3 Adam steps at lr 5e-5 move
    the weights by about lr each, far below one bf16 ulp of a weight near
    0.05 (2e-4), which bf16-held weights could not take."""
    lr = 5e-5
    state = port_state(jax_run[0], dtype=torch.bfloat16, learning_rate=lr)
    state.optimizer.schedule = warmup_schedule(lr, 0)
    p0 = [p.detach().clone() for p in state.optimizer.params]
    assert all(p.dtype == torch.float32 for p in p0)
    step = make_train_step(TS.make_schedule(T_STEPS), 0.15, True)
    x, c = (torch.from_numpy(a) for a in batch())
    for i in range(3):
        metrics = step(state, x, c, jax_draws(i, x.shape))
        assert np.isfinite(float(metrics["unet/loss"]))
    weights = [(n, p, q) for (n, p), q in zip(state.unet.named_parameters(), p0)
               if n.endswith("weight") and p.dim() > 1]
    moved = torch.cat([(p.detach() - q).abs().flatten() for _, p, q in weights])
    assert float((moved > 0).float().mean()) > 0.9
    assert 0.3 * lr < float(moved.mean()) < 3.5 * lr


def test_checkpoints_cross_packages(tmp_path, jax_run):
    """A JAX trainer checkpoint resumes in the port with equal parameters,
    Adam moments and step; the port's checkpoint restores into the JAX
    trainer's state, and resumes in the JAX trainer, with equal values."""
    params0, _, jstate = jax_run
    jc, tc = configs(tmp_path)
    x, c = batch()
    jtrainer = JTrainer(jc, jdata.ArrayDataset(x.astype(np.float16), c.astype(np.uint8)),
                        JLogger(str(tmp_path), "j", True, 1), JHolder(1), run_name="j")
    jtrainer.state = jstate
    path = jtrainer.save(0)

    dataset = tdata.ArrayDataset(x.astype(np.float16), c.astype(np.uint8))
    trainer = DiffusionTrainer(tc, dataset, BasicLogger(str(tmp_path), "t", True, 1),
                               MetricHolder(1), checkpoint=path, run_name="t", device="cpu")
    assert trainer.state.step == int(jstate.step) == STEPS and trainer.curr_epoch == 1
    mu, nu = trainer.state.optimizer.moments()
    adam = jstate.opt_state[1][0]
    for got, ref in ((trainer.state.optimizer.params, jstate.params), (mu, adam.mu), (nu, adam.nu)):
        for a, b in zip(leaves(flax_tree(trainer.state, got)), leaves(ref)):
            np.testing.assert_array_equal(a, b)

    # one more step in the port, then back to JAX
    trainer.train_step(trainer.state, torch.from_numpy(x), torch.from_numpy(c),
                       jax_draws(STEPS, x.shape))
    back = trainer.save(3)
    trees, meta = jckpt.load_checkpoint(back)
    assert meta["epoch"] == 3 and trees["step"]["step"] == STEPS + 1
    restored = jckpt.restore_into(jtrainer.state.opt_state, trees["optim"])
    mu, nu = trainer.state.optimizer.moments()
    for got, ref in ((jckpt.restore_into(jtrainer.state.params, trees["unet"]),
                      trainer.state.optimizer.params), (restored[1][0].mu, mu),
                     (restored[1][0].nu, nu)):
        for a, b in zip(leaves(got), leaves(flax_tree(trainer.state, ref))):
            np.testing.assert_array_equal(a, b)
    assert int(restored[1][0].count) == int(restored[1][1].count) == STEPS + 1
    resumed = JTrainer(jc, jtrainer.train_set, jtrainer.logger, JHolder(1), checkpoint=back,
                       run_name="j")
    assert int(resumed.state.step) == STEPS + 1 and resumed.curr_epoch == 4


def test_reparametrize_matches_jax():
    rng = np.random.default_rng(4)
    lat = (rng.normal(size=(2, 4, 4, 6)) * 20).astype(np.float16)  # log_var beyond the clip
    noise = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    ref = np.asarray(JVAE.reparametrize(jnp.asarray(lat), None, noise=jnp.asarray(noise)))
    got = VAE.reparametrize(torch.from_numpy(lat), torch.from_numpy(noise))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_epoch_batches_follow_jax_order():
    rng = np.random.default_rng(5)
    arrays = rng.normal(size=(11, 2, 2, 6)).astype(np.float16), rng.integers(0, 3, 11).astype(np.uint8)
    ref = list(jdata.epoch_batches(jdata.ArrayDataset(*arrays), 3, shuffle_seed=17))
    got = list(tdata.epoch_batches(tdata.ArrayDataset(*arrays), 3, shuffle_seed=17))
    assert len(got) == len(ref) == 3 == tdata.steps_per_epoch(tdata.ArrayDataset(*arrays), 3)
    for g, r in zip(got, ref):
        assert [t.dtype for t in g] == [torch.float16, torch.uint8]
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_run_seeds():
    assert trng.root_seed(2018, offset=130) == 2148
    assert trng.root_seed(2018) == 2018
    seeds = {trng.epoch_seed(2148, e) for e in range(4)}
    assert len(seeds) == 4 and trng.epoch_seed(2148, 0) == trng.epoch_seed(2148, 0)
    a, b = (trng.step_generator(7), trng.step_generator(7))
    assert torch.equal(torch.randn(5, generator=a), torch.randn(5, generator=b))
    assert 0 <= trng.numpy_seed(trng.epoch_seed(2148, 0)) < 2**31


def test_metric_holder_averages_and_clears():
    h = MetricHolder(3)
    for v in (1.0, 2.0, 3.0, 4.0):  # ring of 3: the first value drops out
        h.store_dict({"unet/loss": torch.tensor(v), "unet/lr": v / 10})
    assert h.flush() == pytest.approx({"unet/loss": 3.0, "unet/lr": 0.3})
    assert h.flush() == {}


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_config_reader_equals_yaml(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    for k, v in ref.items():
        if isinstance(v, str) and tcfg._SCI_NOTATION.match(v):
            ref[k] = float(v)
    assert tcfg.parse_config(path) == ref
    kind = "DiffusionConfig" if os.path.basename(path).startswith("diff") else "VAEConfig"
    j, t = getattr(jcfg, kind).from_yaml(path), getattr(tcfg, kind).from_yaml(path)
    ref = dataclasses.asdict(j)
    del ref["train"]["compile"]  # XLA's jit switch; the port runs eagerly
    got = dataclasses.asdict(t)
    # the port's own keys (core/config.py), which these files leave at their defaults
    port_only = {"layout": "jklimmek", "latent_scale": 1.0, "clip_denoised": True}
    for part in got.values():
        for k, default in port_only.items():
            if k in part:
                assert part.pop(k) == default
    assert ref == got
    assert j.arch.to_dict() == t.arch.to_dict()


@pytest.mark.parametrize("text", [
    'a: "x # y"  # c\nb: \'q\'\n', "a: [1, 2.5, x, null]\nb: []\n", "a: 5e-5\nb: 1.0e-4\nc: -3\n",
    "a: true\nb: false\nc: null\nd:\ne: 0\n", "# only\n\na: ./p/q.npy#frag\n",
    'a: fp16   \nb: "bce"   # loss\nc: 0.15  \n',
])
def test_config_reader_scalars_equal_yaml(tmp_path, text):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    ref = {k: float(v) if isinstance(v, str) and tcfg._SCI_NOTATION.match(v) else v
           for k, v in yaml.safe_load(text).items()}
    assert tcfg.parse_config(str(path)) == ref


@pytest.mark.parametrize("text", ["a:\n  b: 1\n", "- 1\n", "a: [[1]]\n", "a:b\n"])
def test_config_reader_refuses_what_is_not_flat(tmp_path, text):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        tcfg.parse_config(str(path))


def test_trainer_refuses_remat(tmp_path):
    """remat none/dots/full train (tests/test_torch_port_remat.py); any
    other policy is refused at construction."""
    _, tc = configs(tmp_path, remat="everything")
    with pytest.raises(ValueError, match="remat"):
        DiffusionTrainer(tc, tdata.ArrayDataset(*batch()), BasicLogger(str(tmp_path), "r", True, 1),
                         MetricHolder(1), device="cpu")


def test_cli_trains_a_tiny_config_on_the_cpu(tmp_path):
    rng = np.random.default_rng(6)
    np.save(tmp_path / "lat.npy", rng.normal(size=(8, 6, 8, 8)).astype(np.float16))  # NCHW
    np.save(tmp_path / "lab.npy", rng.integers(0, 3, 8).astype(np.uint8))
    lines = [f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in ARCH.items()]
    lines += [f"{k}: {v}" for k, v in {**TRAIN, "precision": "fp16", "batch_size": 4}.items()]
    lines += [f"num_steps: {T_STEPS}", f"train_set: {tmp_path / 'lat.npy'}",
              f"train_labels: {tmp_path / 'lab.npy'}", f"checkpoints_dir: {tmp_path / 'ck'}",
              f"logs_dir: {tmp_path / 'logs'}"]
    (tmp_path / "c.yaml").write_text("\n".join(lines) + "\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-m", "image_diffusion_torch.scripts.train_diffusion",
                          "--config", str(tmp_path / "c.yaml"), "--experiment-name", "cli",
                          "--no-mlflow", "--device", "cpu"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "ck" / "cli" / "unet-epoch-00.ckpt").exists()
    rows = (tmp_path / "logs" / "cli_metrics.csv").read_text().splitlines()
    losses = [float(r.split(",")[2]) for r in rows if ",unet/loss," in r]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_preemption_saves_a_resumable_checkpoint(tmp_path, monkeypatch):
    """SIGTERM latched during epoch 0: the trainer saves after the step with
    meta epoch -1 and returns; resuming replays epoch 0 from that step."""
    from image_diffusion_torch.training import diffusion_trainer as dt

    class Triggered:
        triggered = True

    monkeypatch.setattr(dt, "PreemptionGuard", Triggered)
    _, tc = configs(tmp_path)
    x, c = batch()
    data = tdata.ArrayDataset(np.concatenate([x, x]).astype(np.float16), np.concatenate([c, c]))
    trainer = DiffusionTrainer(tc, data, BasicLogger(str(tmp_path), "p", True, 1), MetricHolder(1),
                               run_name="p", device="cpu")
    trainer.train()
    path = tmp_path / "p" / "unet-epoch--1.ckpt"
    assert trainer.state.step == 1 and path.exists()
    resumed = DiffusionTrainer(tc, data, BasicLogger(str(tmp_path), "p", True, 1), MetricHolder(1),
                               checkpoint=str(path), run_name="p", device="cpu")
    assert resumed.curr_epoch == 0 and resumed.state.step == 1


def test_async_saver_reraises_on_wait(tmp_path):
    from image_diffusion_torch.core.checkpoint import AsyncSaver, load_checkpoint

    saver = AsyncSaver()
    saver.save(str(tmp_path / "ok.ckpt"), {"a": 1}, 0, tree={"w": np.ones(3, np.float32)})
    saver.wait()
    assert load_checkpoint(str(tmp_path / "ok.ckpt"))[1]["epoch"] == 0
    saver.save(str(tmp_path / "bad.ckpt"), None, 0, tree={"w": np.ones(3, np.float64)})
    with pytest.raises(TypeError, match="float64"):
        saver.wait()
    saver.wait()  # the error is raised once


def test_trainer_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tc = configs(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionTrainer(tc, tdata.ArrayDataset(*batch()), BasicLogger(str(tmp_path), "d", True, 1),
                         MetricHolder(1))
