"""The port's data parallelism on the CPU against the JAX package's and its
own one-process run: the mesh and FSDP rules, the row layout and the
global draws, then gloo groups of ranks in subprocesses
(tests/torch_port_mp_worker.py, which imports only torch and the port):
the diffusion and VAE-GAN steps, BatchNorm and codebook statistics, data
and writes on 2 ranks; FSDP on data 2 x model 2 against replicated DP and
its checkpoints; and both training CLIs under torchrun on 2 ranks.

Bars: 2e-4 against the JAX package (the port's fp32 bar, with the update
and moment rules of tests/test_torch_port_vae_training.py); 1e-5 against
the port's own one-process run (tests/test_sharding.py's bar): the ranks
see the same rows, draws and statistics, and differ only by the order of
the sums.  Metrics, Adam's moments (the clipped gradient) and statistics
are held at 1e-5; the parameter updates of one Adam step at 1e-3 against
either, the repo's rule for them: Adam divides by sqrt(nu), so a gradient
that is zero but for fp noise moves its element by up to the learning
rate whatever the order of the sums."""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core import checkpoint as jckpt
from image_diffusion_tpu.core import config as jcfg
from image_diffusion_tpu.core.logging import BasicLogger as JLogger
from image_diffusion_tpu.core.metrics import MetricHolder as JHolder
from image_diffusion_tpu.parallel.fsdp import fsdp_spec as jfsdp_spec
from image_diffusion_tpu.parallel.mesh import make_mesh as jmake_mesh
from image_diffusion_tpu.parallel.mesh import replicate, shard_batch
from image_diffusion_tpu.training import data as jdata
from image_diffusion_tpu.training.diffusion_trainer import DiffusionTrainer as JTrainer
from image_diffusion_tpu.training.diffusion_trainer import make_optimizer
from image_diffusion_tpu.training.vae_trainer import VAETrainState as JState
from image_diffusion_tpu.training.vae_trainer import make_vae_train_step as jmake_vae_step
from image_diffusion_torch.compat.from_jax import disc_state_dict, unet_state_dict, vae_state_dict
from image_diffusion_torch.core import checkpoint as tckpt
from image_diffusion_torch.core import config as tcfg
from image_diffusion_torch.core.logging import BasicLogger
from image_diffusion_torch.core.metrics import MetricHolder
from image_diffusion_torch.models import build_unet
from image_diffusion_torch.models.discriminator import BatchNorm
from image_diffusion_torch.models.vae import Codebook
from image_diffusion_torch.ops import schedule as TS
from image_diffusion_torch.parallel import mesh as tmesh
from image_diffusion_torch.parallel.fsdp import fsdp_spec
from image_diffusion_torch.training import data as tdata
from image_diffusion_torch.training.diffusion_trainer import (
    DiffusionTrainer,
    Draws,
    Optimizer,
    TrainState,
    make_train_step,
)
from test_torch_port_vae_training import RNG as VAE_RNG
from test_torch_port_vae_training import configs as vae_configs
from test_torch_port_vae_training import images, models, percept, port_step
from test_torch_port_vae_training import jax_draws as vae_jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_mp_worker.py")
SPAWN_TIMEOUT = 180  # seconds for all the ranks of one spawn together
ARCH = dict(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16,
            num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
TRAIN = dict(learning_rate=1e-3, warmup_steps=2, batch_size=4, epochs=1, clip_grad=1.0,
             precision="fp32", seed=0, log_interval=1)
RNG = jax.random.key(9)
JAX_REL = 2e-4    # metrics and Adam's moments against the JAX package
UPDATE_REL = 1e-3  # parameter updates of one Adam step (its sqrt(nu) magnifies fp noise)
PORT_REL = 1e-5   # metrics, moments and statistics against the port's one-process run


# ------------------------------------------------------------------ rules


@pytest.mark.parametrize("n,data,model", [
    (8, None, 1), (8, 4, 2), (8, 4, 1), (8, None, 2), (8, 2, 4), (4, None, 4), (1, None, 1),
    (8, 3, 3), (8, None, 3), (2, 4, 1), (8, 16, 1), (6, None, 4)])
def test_mesh_rules_match_jax(n, data, model):
    """`mesh_shape` and `make_mesh(devices=)` take and refuse what JAX's
    `make_mesh` does, with its messages."""
    try:
        ref = jmake_mesh(data=data, model=model, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(";")[0].split(" > ")[0]):
            tmesh.make_mesh(data, model, devices=["cpu"] * n)
        return
    got = tmesh.make_mesh(data, model, devices=["cpu"] * n)
    assert (got.data, got.model) == (ref.shape["data"], ref.shape["model"])
    assert len(got.devices) == ref.devices.size == got.size


@pytest.mark.parametrize("shape,model", [
    ((3, 3, 128, 256), 2), ((256,), 2), ((3,), 2), ((), 2), ((8, 8), 1), ((6, 4, 6), 2),
    ((12, 8, 3, 3), 4), ((5, 7), 2), ((2,), 4)])
def test_fsdp_spec_matches_jax(shape, model):
    spec = tuple(jfsdp_spec(shape, model))
    axis = fsdp_spec(shape, model)
    assert spec == (() if axis is None else tuple("model" if i == axis else None
                                                   for i in range(len(shape))))


def test_fsdp_spec_on_the_port_unet():
    """On the shipped UNet's torch-layout shapes at model 2, most
    parameters shard; the few with no even axis stay whole."""
    with torch.device("meta"):
        unet = build_unet(tcfg.UNetArch(), torch.float32, "meta")
    specs = [fsdp_spec(tuple(p.shape), 2) for p in unet.parameters()]
    whole = [tuple(p.shape) for p, s in zip(unet.parameters(), specs) if s is None]
    assert 0 < len(whole) < len(specs) / 10 and all(np.prod(s) < 100 for s in whole)


@pytest.mark.parametrize("batch,world,accum", [(8, 2, 1), (8, 2, 2), (12, 3, 2), (48, 4, 3),
                                               (4, 1, 4)])
def test_rank_rows_partition_each_micro_batch(batch, world, accum):
    """The shards' rows partition the batch, and chunk i of every shard's
    rows lies in global micro-batch i, as the one-device step splits it."""
    rows = [tmesh.rank_rows(batch, world, r, accum) for r in range(world)]
    assert sorted(np.concatenate(rows).tolist()) == list(range(batch))
    m = batch // accum
    for r in rows:
        for i, chunk in enumerate(np.split(r, accum)):
            assert ((chunk >= i * m) & (chunk < (i + 1) * m)).all()


def test_rank_rows_refuse_what_does_not_divide():
    with pytest.raises(ValueError, match=r"data axis \(2\) x grad_accum \(3\)"):
        tmesh.rank_rows(8, 2, 0, 3)
    data = tdata.ArrayDataset(np.zeros((8, 1)))
    with pytest.raises(ValueError, match=r"data axis \(2\) x grad_accum \(1\)"):
        next(tdata.epoch_batches(data, 3, rank=0, world=2))
    with pytest.raises(ValueError, match=r"data axis \(2\) x grad_accum \(1\)"):
        next(tdata.eval_batches(data, 3, rank=0, world=2))


def test_global_row_draw_equals_slicing_the_one_device_draw():
    """The draw at the global shape, cut to a shard's rows (padded by
    wrapping), equals the one-device draw's rows; a larger draw's prefix
    does not (why padding comes after the draw)."""
    def draw():
        g = torch.Generator().manual_seed(3)
        return Draws(torch.randn(6, 2, generator=g), torch.randint(0, 9, (6,), generator=g),
                     torch.randn(6, 2, generator=g), None)

    whole = draw()
    rows = np.array([4, 5, 0, 1])
    got = tmesh.global_row_draw(draw, rows)
    for a, b in zip(got[:3], whole[:3]):
        torch.testing.assert_close(a, b[torch.from_numpy(rows)], rtol=0, atol=0)
    assert got.drop is None
    big = torch.randn(8, 2, generator=torch.Generator().manual_seed(3))
    assert not torch.equal(big[:6], torch.randn(6, 2, generator=torch.Generator().manual_seed(3)))


def test_initialize_distributed_rules(monkeypatch):
    """A plain launch stays one process; a configured one asks for a card
    it does not have, or for NCCL on the CPU, and fails loudly."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        tmesh.initialize_distributed("cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.initialize_distributed()
    # a configured launch whose rendezvous is missing is fatal
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="configured multi-process launch"):
        tmesh.initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()


def test_trainer_mesh_without_a_launcher(tmp_path):
    assert tmesh.trainer_mesh(None, torch.device("cpu")) is None
    assert tmesh.trainer_mesh(1, torch.device("cpu")) is None
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        tmesh.trainer_mesh(2, torch.device("cpu"))
    with pytest.raises(ValueError, match="process-group mesh"):
        DiffusionTrainer(tcfg.DiffusionConfig(tcfg.UNetArch(**ARCH), tcfg.ScheduleConfig(50),
                                              tcfg.DiffusionTrainConfig(**TRAIN)),
                         tdata.ArrayDataset(*batch()), BasicLogger(str(tmp_path), "m", True, 1),
                         MetricHolder(1), device="cpu", mesh=tmesh.make_mesh(2, devices=["cpu"] * 2))


def test_all_reduce_mean_buckets(monkeypatch):
    """Tensors of two dtypes, one larger than a bucket, in a group of one:
    unchanged values, shapes and dtypes, and one all-reduce per bucket."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(tmesh, "BUCKET_BYTES", 64)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: calls.append(t.numel()) or t.mul_(2))
    ts = [torch.arange(4.0), torch.arange(40.0).reshape(5, 8), torch.tensor(3.0),
          torch.arange(6, dtype=torch.float64)]
    want = [t.clone() for t in ts]
    tmesh.all_reduce_mean_(ts, group=None)
    for a, b in zip(ts, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert calls == [4, 40, 1, 6]


# --------------------------------------------------------- spawned ranks


def spawn(case: str, world: int, work) -> list[dict]:
    """Run `case` on `world` gloo ranks of the worker; every rank's output.
    The ranks share one deadline; any still running then is killed."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    deadline, outs = time.monotonic() + SPAWN_TIMEOUT, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"DONE {r}" in out, f"rank {r}:\n{out[-4000:]}"
    return [dict(np.load(work / f"{case}-rank{r}.npz")) for r in range(world)]


def batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8, 8, 6)).astype(np.float32)  # (mean || log_var) NHWC
    c = np.arange(n, dtype=np.int32) % 3
    return x, c


def jax_draws(x_shape):
    """The draws of the JAX step body at step 0 (tests/test_torch_port_training.py's)."""
    k_rep, k_t, k_noise, k_drop = jax.random.split(jax.random.fold_in(RNG, 0), 4)
    B = x_shape[0]
    z = x_shape[:-1] + (x_shape[-1] // 2,)
    return Draws(*(torch.from_numpy(np.array(d)) for d in (
        jax.random.normal(k_rep, z, jnp.float32), jax.random.randint(k_t, (B,), 0, 50),
        jax.random.normal(k_noise, z, jnp.float32), jax.random.uniform(k_drop, (B,)))))


def named(prefix: str, state: dict) -> dict:
    return {f"{prefix}{k}": np.asarray(v) for k, v in state.items()}


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_moments(got: dict, ref: dict, bar: float) -> None:
    """Per tensor, relative to its norm, with a 1e-9 floor for gradients
    that are zero but for fp noise (the to_k biases)."""
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert np.linalg.norm(got[k] - ref[k]) < bar * np.linalg.norm(ref[k]) + 1e-9, k


def assert_updates(got: dict, ref: dict, p0: dict, bar: float) -> None:
    """The update p - p0 over all tensors, relative L2."""
    keys = sorted(ref)
    u = np.concatenate([(got[k] - p0[k]).ravel() for k in keys])
    v = np.concatenate([(ref[k] - p0[k]).ravel() for k in keys])
    assert rel_l2(u, v) < bar, rel_l2(u, v)


def assert_checkpoints_close(got_path, ref_path, updates: int) -> dict:
    """Two checkpoints of `updates` Adam steps at learning rates up to
    1e-3: the same meta and trees, each leaf within PORT_REL of the other by
    norm, with the 1e-9 floor of `assert_moments` -> the first's trees.
    The attention's to_k biases have a gradient that is zero in exact
    arithmetic (softmax ignores a shift of every key's score), so Adam
    moves them by the sign of fp noise: their parameters are held to the
    learning rate per update instead."""
    got, meta = tckpt.load_checkpoint(str(got_path))
    ref, ref_meta = tckpt.load_checkpoint(str(ref_path))
    assert meta == ref_meta
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_got) == len(flat_ref) > 20
    for path, leaf in flat_got:
        want, name = flat_ref[path], jax.tree_util.keystr(path)
        assert leaf.shape == want.shape and leaf.dtype == want.dtype, name
        err = leaf.astype(np.float64) - want
        if "['to_k']" in name and name.endswith("['bias']") and "optim" not in name:
            assert np.abs(err).max() <= 1e-3 * updates, name
        else:
            assert np.linalg.norm(err) <= PORT_REL * np.linalg.norm(want) + 1e-9, name
    return got


def sub(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def jax_dp_unet_step(accum: int, tmp):
    """JAX's DiffusionTrainer on make_mesh(data=2): its initial parameters
    and, after one step, the metrics, parameters and Adam's mu (port names)."""
    x, c = batch()
    train = {**TRAIN, "grad_accum": accum, "checkpoints_dir": str(tmp), "logs_dir": str(tmp)}
    jc = jcfg.DiffusionConfig(jcfg.UNetArch(**ARCH), jcfg.ScheduleConfig(num_steps=50),
                              jcfg.DiffusionTrainConfig(**train))
    mesh = jmake_mesh(data=2)
    tr = JTrainer(jc, jdata.ArrayDataset(x, c), JLogger(str(tmp), "j", True, 1), JHolder(1),
                  mesh=mesh)
    params0 = jax.tree.map(np.asarray, tr.state.params)
    xs, cs = shard_batch(mesh, (jnp.asarray(x), jnp.asarray(c)))
    state, metrics = tr.train_step(tr.state, xs, cs, RNG)
    adam = state.opt_state[1][0]
    return (params0, {k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in unet_state_dict(jax.tree.map(np.asarray, state.params)).items()},
            {k: v.numpy() for k, v in unet_state_dict(jax.tree.map(np.asarray, adam.mu)).items()})


def port_unet_step(params0: dict, x, c, draws, accum: int):
    """The port's one-process step -> (metrics, parameters, mu)."""
    unet = build_unet(tcfg.UNetArch(**ARCH), torch.float32, "cpu", param_dtype=torch.float32)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in params0.items()})
    state = TrainState(unet, Optimizer(unet.parameters(), 1e-3, 2, 1.0))
    metrics = make_train_step(TS.make_schedule(50), 0.15, True, grad_accum=accum)(
        state, torch.from_numpy(x), torch.from_numpy(c), draws)
    names = [n for n, _ in unet.named_parameters()]
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.detach().numpy() for n, p in zip(names, state.optimizer.params)},
            {n: m.numpy() for n, m in zip(names, state.optimizer.moments()[0])})


def jax_dp_vae_step(bottleneck: str, accum: int):
    """JAX's VAE-GAN step (discriminator active) on make_mesh(data=2), from
    tests/test_torch_port_vae_training.py's variables, images and key, as
    port state dicts and metrics."""
    vae, disc, lp, vae_vars, disc_vars = models(bottleneck)
    jc, _ = vae_configs("/nonexistent", bottleneck, grad_accum=accum)
    vae_tx = make_optimizer(jc.train.learning_rate, jc.train.warmup_steps, jc.train.clip_grad)
    disc_tx = make_optimizer(jc.train.learning_rate, 0, jc.train.clip_grad)
    state = JState(step=jnp.zeros((), jnp.int32), vae_params=vae_vars["params"],
                   vae_opt=vae_tx.init(vae_vars["params"]), codebook=vae_vars.get("codebook"),
                   disc_params=disc_vars["params"], disc_stats=disc_vars["batch_stats"],
                   disc_opt=disc_tx.init(disc_vars["params"]))
    mesh = jmake_mesh(data=2)
    step = jmake_vae_step(vae, disc, jc, percept(bottleneck, lp), vae_tx, disc_tx)
    new, metrics = step(replicate(mesh, state), shard_batch(mesh, jnp.asarray(images())), VAE_RNG,
                        disc_active=True)
    new = jax.tree.map(np.asarray, new)
    variables = {"params": new.vae_params}
    if new.codebook is not None:
        variables["codebook"] = new.codebook
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in vae_state_dict(variables).items()},
            {k: v.numpy() for k, v in disc_state_dict(new.disc_params, new.disc_stats).items()},
            {k: v.numpy() for k, v in vae_state_dict({"params": new.vae_opt[1][0].mu}).items()},
            {k: v.numpy() for k, v in disc_state_dict(new.disc_opt[1][0].mu).items()})


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The "dp" case on 2 ranks, its inputs and references: JAX's DP
    steps and the port's one-process steps of the same inputs."""
    work = tmp_path_factory.mktemp("dp")
    x, c = batch()
    draws = jax_draws(x.shape)
    inputs = {"x": x, "c": c, "images": images(),
              **{f"draw_{k}": v.numpy() for k, v in zip(("z", "t", "noise", "drop"), draws)}}
    ref = {"unet": {}, "vae": {}}
    for accum in (1, 2):
        params0, *jax_out = jax_dp_unet_step(accum, work / f"j{accum}")
        p0 = {k: v.numpy() for k, v in unet_state_dict(params0).items()}
        inputs.update(named("unet0/", p0))  # equal for both accums: key 0
        ref["unet"][accum] = dict(jax=jax_out, port=port_unet_step(p0, x, c, draws, accum), p0=p0)
    for bottleneck in ("kl", "vq"):
        _, _, _, vae_vars, disc_vars = models(bottleneck)
        inputs.update(named(f"{bottleneck}/vae/", {k: v.numpy()
                                                   for k, v in vae_state_dict(vae_vars).items()}))
        inputs.update(named(f"{bottleneck}/disc/", {k: v.numpy() for k, v in disc_state_dict(
            disc_vars["params"], disc_vars["batch_stats"]).items()}))
        vd = vae_jax_draws(0)
        inputs[f"{bottleneck}/flip"], inputs[f"{bottleneck}/noise"] = vd.flip.numpy(), vd.noise.numpy()
        for accum in (1, 2):
            st, metrics = port_step(bottleneck, True, accum)
            names = {"vae": [n for n, _ in st.vae.named_parameters()],
                     "disc": [n for n, _ in st.disc.named_parameters()]}
            ref["vae"][bottleneck, accum] = dict(
                jax=jax_dp_vae_step(bottleneck, accum),
                port=({k: float(v) for k, v in metrics.items()},
                      {k: v.detach().numpy() for k, v in st.vae.state_dict().items()},
                      {k: v.detach().numpy() for k, v in st.disc.state_dict().items()},
                      dict(zip(names["vae"], (m.numpy() for m in st.vae_opt.moments()[0]))),
                      dict(zip(names["disc"], (m.numpy() for m in st.disc_opt.moments()[0])))))
    rng = np.random.default_rng(5)
    inputs.update(bn_x=rng.normal(size=(6, 4, 3, 3)).astype(np.float32) * 2 + 1,
                  bn_w=rng.normal(size=(6, 4, 3, 3)).astype(np.float32),
                  cb_z=rng.normal(size=(8, 4, 4, 4)).astype(np.float32) * 0.01,
                  data=np.arange(12 * 3).reshape(12, 3).astype(np.float32),
                  dev=np.arange(10 * 2).reshape(10, 2).astype(np.float32))
    np.savez(work / "inputs.npz", **inputs)
    return spawn("dp", 2, work), inputs, ref, work


REPLICATED = ("unet1/", "unet2/", "kl1/", "kl2/", "vq1/", "vq2/", "cb/", "bn/running")


def test_dp_ranks_hold_one_state(dp_run):
    """After the steps every rank holds the same parameters, moments,
    statistics, codebook and metrics, bit for bit."""
    outs = dp_run[0]
    keys = [k for k in outs[0] if k.startswith(REPLICATED)]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_dp_diffusion_step(dp_run, accum, against):
    """Two ranks, one step from one state, each on its rows of the batch
    and of the draws: loss and gradient norm and Adam's mu against JAX's
    DiffusionTrainer on make_mesh(data=2) (2e-4) and against the port's
    one-process step (1e-5); the updates at 1e-3 (see the module doc)."""
    outs, _, ref, _ = dp_run
    metrics, params, mu = ref["unet"][accum][against]
    got = outs[0]
    bar = JAX_REL if against == "jax" else PORT_REL
    for name in ("unet/loss", "unet/grad"):
        assert float(got[f"unet{accum}/{name}"]) == pytest.approx(metrics[name], rel=bar), name
    p0 = ref["unet"][accum]["p0"]
    names = [k for k in params if k != "time_embedding.factor"]
    assert_moments(sub(got, f"unet{accum}/mu/"), {k: mu[k] for k in names}, bar)
    assert_updates(sub(got, f"unet{accum}/param/"), {k: params[k] for k in names}, p0, UPDATE_REL)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_dp_vae_step(dp_run, bottleneck, accum, against):
    """Two ranks, discriminator active, each holding its share of every
    micro-batch: every metric, both Adams' mu, the BatchNorm running
    statistics and the VQ codebook against JAX's step on make_mesh(data=2)
    (2e-4; statistics 1e-6, codebook 1e-5, the bars of
    tests/test_torch_port_vae_training.py) and against the port's
    one-process step (1e-5); both updates at 1e-3 (see the module doc)."""
    outs, inputs, ref, _ = dp_run
    metrics, vae_sd, disc_sd, vae_mu, disc_mu = ref["vae"][bottleneck, accum][against]
    got, key = outs[0], f"{bottleneck}{accum}/"
    bar = JAX_REL if against == "jax" else PORT_REL
    got_metrics = sub(got, key + "metric/")
    assert set(got_metrics) == set(metrics)
    for name, value in metrics.items():
        assert float(got_metrics[name]) == pytest.approx(value, rel=bar, abs=1e-7), name
    assert_moments(sub(got, key + "vae_mu/"), vae_mu, bar)
    assert_moments(sub(got, key + "disc_mu/"), disc_mu, bar)
    vae0, disc0 = sub(inputs, f"{bottleneck}/vae/"), sub(inputs, f"{bottleneck}/disc/")
    got_vae, got_disc = sub(got, key + "vae/"), sub(got, key + "disc/")
    assert_updates(got_vae, {k: vae_sd[k] for k in vae_mu}, vae0, UPDATE_REL)
    assert_updates(got_disc, {k: disc_sd[k] for k in disc_mu}, disc0, UPDATE_REL)
    stats = [k for k in disc_sd if "running" in k]
    assert stats
    for k in stats:
        tol = 1e-6 if against == "jax" else PORT_REL
        np.testing.assert_allclose(got_disc[k], disc_sd[k], rtol=tol, atol=tol, err_msg=k)
    codebook = [k for k in vae_sd if k.startswith("codebook.")]
    assert len(codebook) == (3 if bottleneck == "vq" else 0)
    for k in codebook:
        np.testing.assert_allclose(got_vae[k], vae_sd[k], rtol=1e-5, atol=1e-7, err_msg=k)
        assert not np.array_equal(got_vae[k], vae0[k]), k


def test_dp_batchnorm_statistics_and_gradient(dp_run):
    """BatchNorm on 2 ranks of 3 rows against one BatchNorm on all 6: the
    output rows, the running statistics and the input's gradient (summed
    over the ranks, whose rows are disjoint) at 1e-5."""
    outs, inputs, _, _ = dp_run
    x = torch.from_numpy(inputs["bn_x"]).requires_grad_(True)
    bn = BatchNorm(4)
    y = bn(x)
    (y * torch.from_numpy(inputs["bn_w"])).sum().backward()
    got_y = np.concatenate([o["bn/y"] for o in outs])
    np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=PORT_REL, atol=PORT_REL)
    np.testing.assert_allclose(outs[0]["bn/grad"] + outs[1]["bn/grad"], x.grad.numpy(),
                               rtol=PORT_REL, atol=PORT_REL)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(outs[0][f"bn/{name}"], getattr(bn, name).numpy(),
                                   rtol=PORT_REL, atol=PORT_REL)


def test_dp_codebook_ema_is_global(dp_run):
    """The codebook's EMA update and perplexity from two ranks' tokens
    equal one codebook's on all of them (1e-5, tests/test_sharding.py's
    test_vq_codebook_ema_global_under_sharding)."""
    outs, inputs, _, _ = dp_run
    cb = Codebook(16, 4, 0.99)
    cb.reset_state(torch.Generator().manual_seed(1))
    _, _, perplexity = cb(torch.from_numpy(inputs["cb_z"]), train=True)
    for k, v in cb.state_dict().items():
        np.testing.assert_allclose(outs[0][f"cb/{k}"], v.numpy(), atol=1e-5, err_msg=k)
    assert float(outs[0]["cb/perplexity"]) == pytest.approx(float(perplexity), rel=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_ranks_load_their_rows_of_every_batch(dp_run, accum):
    """Each rank's batches are its `rank_rows` of the one-process batches
    of the same permutation; together they are those batches."""
    outs, inputs, _, _ = dp_run
    ref = [b[0].numpy() for b in tdata.epoch_batches(tdata.ArrayDataset(inputs["data"]), 4, 123)]
    assert len(ref) == 3
    for r, out in enumerate(outs):
        rows = tmesh.rank_rows(4, 2, r, accum)
        np.testing.assert_array_equal(out[f"data/accum{accum}"], np.stack([b[rows] for b in ref]))


def test_dp_dev_tail_counted_once(dp_run):
    """10 dev rows in batches of 4 on 2 ranks: the ranks' valid rows of
    each batch, rank 0's first, are exactly the dev set, in order."""
    outs, inputs, _, _ = dp_run
    got = np.concatenate([out[f"dev/{i}"] for i in range(3) for out in outs])
    np.testing.assert_array_equal(got, inputs["dev"])
    assert len(outs[0]["dev/2"]) == 2 and len(outs[1]["dev/2"]) == 0


def test_dp_ranks_agree_on_a_stop_and_a_seed(dp_run):
    """`any_rank` (the trainers' SIGTERM agreement) is true on every rank
    when one rank's flag is; `broadcast_int` gives rank 0's seed."""
    for out in dp_run[0]:
        assert out["agree"].tolist() == [1, 0, 100]


def test_dp_only_rank_0_writes(dp_run):
    """Both ranks saved a checkpoint (directly and on the async thread),
    logged a metric and parameters: one file each, rank 0's, and one row."""
    work = dp_run[3]
    trees, _ = tckpt.load_checkpoint(str(work / "w.ckpt"))
    np.testing.assert_array_equal(trees["tree"]["w"], np.arange(3, dtype=np.float32))
    trees, _ = tckpt.load_checkpoint(str(work / "async.ckpt"))
    np.testing.assert_array_equal(trees["tree"]["w"], np.zeros(2, np.float32))
    rows = [r for r in (work / "mp_metrics.csv").read_text().splitlines() if "probe" in r]
    assert rows == ["0,probe,1.0"]
    assert not list(work.glob("*.tmp"))


# ------------------------------------------------------------------ FSDP


def fsdp_config(tmp):
    return tcfg.DiffusionConfig(
        tcfg.UNetArch(**ARCH), tcfg.ScheduleConfig(num_steps=50),
        tcfg.DiffusionTrainConfig(learning_rate=1e-3, warmup_steps=2, clip_grad=1.0, batch_size=8,
                                  epochs=1, precision="fp32", seed=0, log_interval=1,
                                  ema_decay=0.9, checkpoints_dir=str(tmp), logs_dir=str(tmp)))


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    """The "fsdp" case on 4 ranks and the one-process trainer's checkpoint
    of the same epoch."""
    work = tmp_path_factory.mktemp("fsdp")
    x, c = batch(8, seed=3)
    g = torch.Generator().manual_seed(4)
    draws = Draws(torch.randn(8, 8, 8, 3, generator=g), torch.randint(0, 50, (8,), generator=g),
                  torch.randn(8, 8, 8, 3, generator=g), torch.rand(8, generator=g))
    unet = build_unet(tcfg.UNetArch(**ARCH), torch.float32, "cpu", torch.Generator().manual_seed(1))
    p0 = {k: v.numpy() for k, v in unet.state_dict().items()}
    rng = np.random.default_rng(6)
    inputs = {"x": x, "c": c, **named("unet0/", p0),
              **{f"draw_{k}": v.numpy() for k, v in zip(("z", "t", "noise", "drop"), draws)},
              "latents": rng.normal(size=(8, 8, 8, 6)).astype(np.float16),
              "labels": rng.integers(0, 3, 8).astype(np.uint8)}
    np.savez(work / "inputs.npz", **inputs)
    one = DiffusionTrainer(fsdp_config(work / "one"),
                           tdata.ArrayDataset(inputs["latents"], inputs["labels"]),
                           BasicLogger(str(work), "o", True, 1), MetricHolder(1), run_name="one",
                           device="cpu")
    one.train()
    return spawn("fsdp", 4, work), port_unet_step(p0, x, c, draws, 1), work


def test_fsdp_step_matches_replicated(fsdp_run):
    """Data 2 x model 2 against replicated DP on 4 ranks and the
    one-process step, one step from one state and batch: loss, gradient
    norm (of the whole gradient), Adam's mu and the parameters at 1e-5;
    the parameters sharded but for the few with no even axis."""
    outs, (metrics, params, mu), _ = fsdp_run
    fsdp, dp = sub(outs[0], "fsdp/"), sub(outs[0], "dp/")
    for name in ("unet/loss", "unet/grad"):
        assert float(fsdp[name]) == pytest.approx(float(dp[name]), rel=PORT_REL), name
        assert float(fsdp[name]) == pytest.approx(metrics[name], rel=PORT_REL), name
    for ref in (sub(dp, "mu/"), mu):
        assert_moments(sub(fsdp, "mu/"), ref, PORT_REL)
    for ref in (sub(dp, "param/"), params):
        for k, v in ref.items():
            np.testing.assert_allclose(fsdp[f"param/{k}"], v, rtol=PORT_REL, atol=PORT_REL,
                                       err_msg=k)
    sharded, total = fsdp["sharded"]
    whole = [p for p in build_unet(tcfg.UNetArch(**ARCH), torch.float32, "cpu").parameters()
             if fsdp_spec(tuple(p.shape), 2) is None]
    assert len(params) == total and 0 < len(whole) == total - sharded
    for out in outs[1:]:
        for k in fsdp:
            np.testing.assert_array_equal(out["fsdp/" + k], fsdp[k], err_msg=k)


def test_fsdp_checkpoint_equals_one_process_and_loads_in_jax(fsdp_run):
    """An epoch under FSDP (EMA sharded too) writes the checkpoint the
    one-process trainer writes, leaf by leaf at 1e-5 (by norm); a trainer that
    resumes from it under FSDP writes it again bit for bit; JAX's
    load_checkpoint reads it."""
    outs, _, work = fsdp_run
    assert int(outs[0]["resumed_epoch"]) == 1
    path = work / "run" / "unet-epoch-00.ckpt"
    got = assert_checkpoints_close(path, work / "one" / "one" / "unet-epoch-00.ckpt", 1)
    assert set(got) == {"unet", "unet_ema", "optim", "step"}
    meta = tckpt.load_checkpoint(str(path))[1]
    again, _ = tckpt.load_checkpoint(str(work / "again" / "unet-epoch-00.ckpt"))
    jax.tree.map(np.testing.assert_array_equal, again, got)
    jtrees, jmeta = jckpt.load_checkpoint(str(path))
    assert jmeta["trees"] == meta["trees"]
    jax.tree.map(np.testing.assert_array_equal, jtrees, got)
    rows = (work / "f_metrics.csv").read_text().splitlines()
    assert [r.split(",")[:2] for r in rows if ",unet/loss," in r] == [["0", "unet/loss"]]


def test_fsdp_resume_seeds_the_ema_from_a_checkpoint_without_one(fsdp_run):
    """An FSDP epoch with `ema_decay: null` writes a checkpoint without
    `unet_ema`; a trainer with `ema_decay: 0.9` resumes from it under FSDP
    and seeds its sharded EMA from the restored parameters: max|EMA -
    parameters| is 0 on every rank (the JAX trainer copies the restored
    parameters under any sharding)."""
    outs, _, work = fsdp_run
    trees, _ = tckpt.load_checkpoint(str(work / "no_ema" / "unet-epoch-00.ckpt"))
    assert "unet_ema" not in trees
    for out in outs:
        assert float(out["ema_seed_max_abs_diff"]) == 0.0
        assert int(out["ema_seed_sharded"]) > 0


# --------------------------------------------------------------- the CLIs


def _write_diffusion_config(tmp):
    rng = np.random.default_rng(6)
    np.save(tmp / "lat.npy", rng.normal(size=(8, 6, 8, 8)).astype(np.float16))  # NCHW
    np.save(tmp / "lab.npy", rng.integers(0, 3, 8).astype(np.uint8))
    lines = [f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in ARCH.items()]
    lines += [f"{k}: {v}" for k, v in {**TRAIN, "epochs": 2, "grad_accum": 2}.items()]
    lines += ["num_steps: 50", f"train_set: {tmp / 'lat.npy'}", f"train_labels: {tmp / 'lab.npy'}",
              f"checkpoints_dir: {tmp / 'ck'}", f"logs_dir: {tmp / 'logs'}"]
    (tmp / "c.yaml").write_text("\n".join(lines) + "\n")
    return str(tmp / "c.yaml")


def _write_vae_config(tmp):
    from test_torch_port_vae_training import ARCH as VARCH
    from test_torch_port_vae_training import TRAIN as VTRAIN
    from test_torch_port_vae_training import VQ

    lines = [f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in {**VARCH, **VQ}.items()]
    train = {**VTRAIN, "epochs": 1, "grad_accum": 2, "train_set": tmp / "train.npy",
             "dev_set": tmp / "dev.npy", "checkpoints_dir": tmp / "ck", "logs_dir": tmp / "logs"}
    lines += [f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in train.items()]
    (tmp / "c.yaml").write_text("\n".join(lines) + "\n")
    np.save(tmp / "train.npy", images(n=8, seed=7))
    np.save(tmp / "dev.npy", images(n=5, seed=8))
    return str(tmp / "c.yaml")


def torchrun(tmp, module: str, *args) -> str:
    """`module` under torchrun on 2 CPU ranks (gloo), in `tmp`."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", module, *args],
                         cwd=tmp, env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout + out.stderr




def test_train_diffusion_under_torchrun(tmp_path):
    """`train_diffusion --device cpu --data-parallel 2` on 2 gloo ranks:
    2 epochs of 2 steps at grad_accum 2; the checkpoints equal the
    one-process run's at 1e-5, one metrics file with one row a metric and
    step."""
    from image_diffusion_torch.scripts.train_diffusion import main

    config = _write_diffusion_config(tmp_path)
    args = ["--config", config, "--no-mlflow", "--device", "cpu"]
    torchrun(tmp_path, "image_diffusion_torch.scripts.train_diffusion", *args,
             "--experiment-name", "dp", "--data-parallel", "2")
    main([*args, "--experiment-name", "one"])
    for epoch in (0, 1):
        assert_checkpoints_close(tmp_path / "ck" / "dp" / f"unet-epoch-{epoch:02}.ckpt",
                                 tmp_path / "ck" / "one" / f"unet-epoch-{epoch:02}.ckpt",
                                 2 * (epoch + 1))
    rows = [r.split(",") for r in (tmp_path / "logs" / "dp_metrics.csv").read_text().splitlines()]
    ref = [r.split(",") for r in (tmp_path / "logs" / "one_metrics.csv").read_text().splitlines()]
    assert [r[:2] for r in rows] == [r[:2] for r in ref]
    for got, want in zip(rows[1:], ref[1:]):
        if got[1] in ("unet/loss", "unet/grad", "unet/epoch_loss"):
            assert float(got[2]) == pytest.approx(float(want[2]), rel=PORT_REL), got


def test_train_vae_under_torchrun(tmp_path):
    """`train_vae --device cpu` (VQ, grad_accum 2, the discriminator from
    step 1, a padded dev tail) on 2 gloo ranks: its checkpoint equals the
    one-process run's at 1e-5, and so do the dev losses and perplexity."""
    from image_diffusion_torch.scripts.train_vae import main

    config = _write_vae_config(tmp_path)
    args = ["--config", config, "--no-mlflow", "--device", "cpu", "--allow-no-lpips"]
    torchrun(tmp_path, "image_diffusion_torch.scripts.train_vae", *args, "--experiment-name", "dp")
    with pytest.warns(UserWarning, match="ZERO"):
        main([*args, "--experiment-name", "one"])
    assert_checkpoints_close(tmp_path / "ck" / "dp" / "vae-epoch-00.ckpt",
                             tmp_path / "ck" / "one" / "vae-epoch-00.ckpt", 2)

    def dev(name):
        rows = [r.split(",") for r in (tmp_path / "logs" / f"{name}_metrics.csv").read_text()
                .splitlines()[1:]]
        return {n: float(v) for _, n, v in rows if n.startswith("dev/")}

    got, ref = dev("dp"), dev("one")
    assert set(got) == set(ref) == {"dev/recon_loss", "dev/percept_loss", "dev/perplexity"}
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=PORT_REL), k
