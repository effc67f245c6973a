"""The port's activation remat (`models/unet.py`) against its own plain UNet
and the JAX package's remat policies, on the CPU: the state dict under
every policy, fp32 loss and gradients of the tiny UNet of
tests/test_remat.py, the packed attention operator's forward run once a
site per step (its output saved, never recomputed), and the trainer and
CLI plumbing of `remat`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core.config import UNetArch as JUNetArch
from image_diffusion_tpu.models import build_unet as jbuild_unet
from image_diffusion_torch import ops
from image_diffusion_torch.compat.from_jax import unet_flax_params
from image_diffusion_torch.core import config as tcfg
from image_diffusion_torch.core.config import UNetArch
from image_diffusion_torch.core.logging import BasicLogger
from image_diffusion_torch.core.metrics import MetricHolder
from image_diffusion_torch.models import build_unet
from image_diffusion_torch.ops import attention
from image_diffusion_torch.training.data import ArrayDataset
from image_diffusion_torch.training.diffusion_trainer import DiffusionTrainer

# tests/test_remat.py's tiny UNet
TINY = dict(z_dim=3, channels=(8, 16, 24), mid_channels=(24, 24), time_dim=16,
            num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
# the same shape with head dims 16 and 32 and token counts 64 and 16, so its
# 3 sites take the packed kernel's route in bf16 (its plain version here)
KERNEL_ROUTE = dict(TINY, channels=(32, 64), mid_channels=(64, 64))
POLICIES = ["none", "dots", "full"]


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 1000, (4,)).astype(np.int64),
            rng.integers(0, 3, (4,)).astype(np.int64),
            (rng.uniform(size=(4, 1)) > 0.15).astype(np.float32),
            rng.normal(size=(4, 8, 8, 3)).astype(np.float32))


def port_loss_and_grads(arch, state, remat, dtype=torch.float32):
    unet = build_unet(UNetArch(**arch), dtype, "cpu", param_dtype=torch.float32, remat=remat)
    unet.load_state_dict(state)
    x, t, c, mask, noise = (torch.from_numpy(a) for a in batch())
    loss = torch.mean((unet(x, t, c, mask).float() - noise) ** 2)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in unet.named_parameters()}


@pytest.fixture(scope="module")
def tiny_state():
    return build_unet(UNetArch(**TINY), torch.float32, "cpu",
                      torch.Generator().manual_seed(0)).state_dict()


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_state_dict_is_the_plain_modules(mode, tiny_state):
    """The same keys, and the same draws from the same generator, under
    every policy: a checkpoint trained with one loads under any other."""
    rem = build_unet(UNetArch(**TINY), torch.float32, "cpu", torch.Generator().manual_seed(0),
                     remat=mode)
    assert rem.remat == mode
    state = rem.state_dict()
    assert list(state) == list(tiny_state)
    for k in state:
        assert torch.equal(state[k], tiny_state[k]), k


def test_remat_none_builds_the_plain_module_and_unknown_policies_raise():
    assert build_unet(UNetArch(**TINY), torch.float32, "cpu").remat is None
    assert build_unet(UNetArch(**TINY), torch.float32, "cpu", remat="none").remat is None
    with pytest.raises(ValueError, match="remat"):
        build_unet(UNetArch(**TINY), torch.float32, "cpu", remat="everything")


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_loss_and_grads_match_none_and_jax(mode, tiny_state):
    """fp32: loss and gradients under `mode` against the plain module at
    JAX's own remat bar (rtol 2e-5, atol 1e-6), and against the JAX
    package's `mode` UNet on the same weights and batch at rtol 2e-4 (atol
    2e-4 of the largest gradient)."""
    loss0, g0 = port_loss_and_grads(TINY, tiny_state, None)
    loss, grads = port_loss_and_grads(TINY, tiny_state, mode)
    assert loss == pytest.approx(loss0, rel=1e-6)
    for name in g0:
        np.testing.assert_allclose(grads[name].numpy(), g0[name].numpy(), rtol=2e-5, atol=1e-6,
                                   err_msg=name)

    model = jbuild_unet(JUNetArch(**TINY), dtype=jnp.float32, remat=mode)
    params = jax.tree.map(jnp.asarray, unet_flax_params(tiny_state))
    x, t, c, mask, noise = (jnp.asarray(a) for a in batch())

    def jloss(p):
        eps = model.apply({"params": p}, x, t.astype(np.int32), c.astype(np.int32), mask)
        return jnp.mean((eps.astype(jnp.float32) - noise) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    assert loss == pytest.approx(float(jl), rel=2e-4)
    ours = jax.tree_util.tree_leaves_with_path(unet_flax_params(grads))
    ref = {path: np.asarray(g) for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    assert len(ours) == len(ref)
    # atol at the bar times the largest gradient: some leaves (the key
    # projections' biases, which softmax ignores) are zero up to rounding
    scale = max(float(np.abs(g).max()) for g in ref.values())
    for path, g in ours:
        np.testing.assert_allclose(g, ref[path], rtol=2e-4, atol=2e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode", POLICIES)
def test_packed_forward_runs_once_per_site_per_step(mode, monkeypatch):
    """bf16 on the CPU, where the sites take the packed operators' plain
    versions: under every policy the forward operator's body runs once per
    site in a step (its output and row sums are saved, never recomputed,
    which on the card means no second launch of the kernel) and the
    backward once per site; the gradients equal the plain module's."""
    calls = {"forward": 0, "backward": 0}

    def counting(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    # the operators' bodies on CPU tensors: the forward, and the plain backward
    monkeypatch.setattr(attention, "_packed_forward",
                        counting("forward", attention._packed_forward))
    monkeypatch.setattr(attention, "reference_packed_attention_bwd",
                        counting("backward", attention.reference_packed_attention_bwd))
    state = build_unet(UNetArch(**KERNEL_ROUTE), torch.float32, "cpu",
                       torch.Generator().manual_seed(1)).state_dict()
    with ops.record_sites() as sites:
        _, grads = port_loss_and_grads(KERNEL_ROUTE, state, mode, torch.bfloat16)
    n_sites = 3  # down block, mid block, up block: one layer each
    assert sum(1 for s in sites if s[-1] == "kernel") == n_sites * (1 if mode == "none" else 2)
    assert calls == {"forward": n_sites, "backward": n_sites}
    monkeypatch.undo()
    _, plain = port_loss_and_grads(KERNEL_ROUTE, state, None, torch.bfloat16)
    for name in plain:
        assert torch.equal(grads[name], plain[name]), name


def _config(tmp_path, remat):
    return tcfg.DiffusionConfig(
        tcfg.UNetArch(**TINY), tcfg.ScheduleConfig(num_steps=50),
        tcfg.DiffusionTrainConfig(learning_rate=1e-3, warmup_steps=1, batch_size=4, epochs=1,
                                  precision="fp32", seed=0, log_interval=1, remat=remat,
                                  checkpoints_dir=str(tmp_path), logs_dir=str(tmp_path)))


def _latents(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8, 8, 6)).astype(np.float16),
            rng.integers(0, 3, (n,)).astype(np.uint8))


def test_trainer_takes_remat_and_the_cli_overrides_the_yaml(tmp_path):
    """A config's `remat` reaches the UNet and trains (2 steps, losses as
    the plain module's to fp32 reassociation); `--remat` replaces the
    YAML's value."""
    losses = {}
    for mode in ("none", "dots"):
        logged = []

        class Recorder(BasicLogger):
            def log_metrics(self, metrics, step):
                logged.append(metrics["unet/loss"])

        trainer = DiffusionTrainer(_config(tmp_path / mode, mode), ArrayDataset(*_latents()),
                                   Recorder(str(tmp_path), mode, True, 1), MetricHolder(1),
                                   run_name=mode, device="cpu")
        assert trainer.unet.remat == (None if mode == "none" else mode)
        trainer.train()
        assert trainer.state.step == 2
        losses[mode] = logged
    np.testing.assert_allclose(losses["dots"], losses["none"], rtol=1e-6)

    from image_diffusion_torch.scripts import train_diffusion

    lat, lab = _latents()
    np.save(tmp_path / "lat.npy", lat)
    np.save(tmp_path / "lab.npy", lab)
    lines = [f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in TINY.items()]
    lines += ["num_steps: 50", "batch_size: 4", "epochs: 1", "precision: fp32", "remat: dots",
              f"train_set: {tmp_path / 'lat.npy'}", f"train_labels: {tmp_path / 'lab.npy'}",
              f"checkpoints_dir: {tmp_path / 'ck'}", f"logs_dir: {tmp_path / 'logs'}"]
    (tmp_path / "c.yaml").write_text("\n".join(lines) + "\n")
    args = ["--config", str(tmp_path / "c.yaml"), "--no-mlflow", "--device", "cpu"]
    assert train_diffusion.main(args).unet.remat == "dots"
    assert train_diffusion.main(args + ["--remat", "full"]).unet.remat == "full"
    assert train_diffusion.main(args + ["--remat", "none"]).unet.remat is None
