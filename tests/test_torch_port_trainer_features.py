"""The port's trainer features beyond the train step, on the CPU: step timing
and profiler traces (`core/profiling.py`), the diffusion trainer's
in-training preview, and `--debug-nans` in both trainers."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from image_diffusion_torch.core import config as tcfg
from image_diffusion_torch.core.config import UNetArch, VAEArch
from image_diffusion_torch.core.logging import BasicLogger
from image_diffusion_torch.core.metrics import MetricHolder
from image_diffusion_torch.core.profiling import StepTimer, trace
from image_diffusion_torch.models import build_vae
from image_diffusion_torch.models.io import save_vae
from image_diffusion_torch.pipelines import DiffusionPipeline
from image_diffusion_torch.training.data import ArrayDataset
from image_diffusion_torch.training.diffusion_trainer import DiffusionTrainer, Preview

UNET_ARCH = dict(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16,
                 num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
# 16x16 images, 8x8x3 latents: the UNet's
VAE_ARCH = dict(in_channels=3, channels=(8, 16), z_dim=3, enc_num_res_blocks=1,
                dec_num_res_blocks=1, attn_resolutions=(), num_heads=1, init_resolution=16,
                num_groups=4)
PREVIEW_STEPS = 3


def config(tmp_path, **over):
    train = {**dict(learning_rate=1e-3, warmup_steps=1, batch_size=4, epochs=2,
                    precision="fp32", seed=0, log_interval=1,
                    checkpoints_dir=str(tmp_path / "ck"), logs_dir=str(tmp_path / "logs")),
             **over}
    return tcfg.DiffusionConfig(tcfg.UNetArch(**UNET_ARCH), tcfg.ScheduleConfig(num_steps=50),
                                tcfg.DiffusionTrainConfig(**train))


def latents(n=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8, 8, 6)).astype(np.float16),
            rng.integers(0, 3, (n,)).astype(np.uint8))


@pytest.fixture(scope="module")
def vae_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vae") / "vae.ckpt")
    arch = VAEArch(**VAE_ARCH)
    save_vae(path, arch, build_vae(arch, torch.float32, "cpu",
                                   torch.Generator().manual_seed(3)).state_dict())
    return path


class Recorder(BasicLogger):
    """Keeps every logged metric row (and writes nothing but figures)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))

    def log_metric(self, name, val, step):
        self.rows.append((step, {name: val}))


def losses(logger):
    return [m["unet/loss"] for _, m in logger.rows if "unet/loss" in m]


# ------------------------------------------------------------ profiling


def test_step_timer_syncs_on_the_scalar_before_reading_the_clock():
    seen = []

    class Scalar:
        def item(self):
            seen.append(time.perf_counter())
            time.sleep(0.02)

    timer = StepTimer()
    time.sleep(0.01)
    rate = timer.items_per_sec(10, Scalar())
    assert len(seen) == 1
    assert 10 / rate >= 0.03  # the clock was read after the sync returned
    t0 = time.perf_counter()
    rate = timer.items_per_sec(48)  # a window starts where the last one ended
    assert 48 / rate <= time.perf_counter() - t0 + 1e-3


@pytest.mark.parametrize("source", ["argument", "IDTPU_PROFILE"])
def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch, source):
    monkeypatch.delenv("IDTPU_PROFILE", raising=False)
    with trace() as prof:
        torch.ones(4) @ torch.ones(4)
    assert prof is None and not os.listdir(tmp_path)
    if source == "IDTPU_PROFILE":
        monkeypatch.setenv("IDTPU_PROFILE", str(tmp_path / "traces"))
        ctx = trace()
    else:
        ctx = trace(str(tmp_path / "traces"))
    with ctx as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "traces")
    assert name.startswith("trace_") and name.endswith(".json")
    events = json.loads((tmp_path / "traces" / name).read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# -------------------------------------------------------------- preview


def trainer(tmp_path, run, logger=None, **kw):
    logger = logger or Recorder(str(tmp_path / "logs"), run, True, 1)
    return DiffusionTrainer(config(tmp_path, **kw.pop("train", {})), ArrayDataset(*latents()),
                            logger, MetricHolder(1), run_name=run, device="cpu", **kw)


def test_preview_figure_is_written_every_preview_freq_epochs(tmp_path, vae_file):
    tr = trainer(tmp_path, "p", preview_vae=vae_file, preview_freq=2,
                 preview_steps=PREVIEW_STEPS)
    tr.train()
    previews = tmp_path / "logs" / "p" / "previews"
    assert sorted(os.listdir(previews)) == ["epoch_001.png"]
    assert (previews / "epoch_001.png").stat().st_size > 0


def test_preview_images_equal_pipe_sample(tmp_path, vae_file):
    """The trainer's preview of its EMA weights after 2 steps: the images of
    a pipeline built from the same VAE and weights, sampled with the same
    scale, seed, sampler and steps, bit for bit; the EMA's, not the raw
    weights'."""
    from image_diffusion_torch.models.io import read_vae

    tr = trainer(tmp_path, "e", preview_vae=vae_file, preview_freq=1,
                 preview_steps=PREVIEW_STEPS, train=dict(ema_decay=0.5, epochs=1))
    tr.train()
    ema = tr._named(tr.state.ema)
    got = tr.preview.images(ema, seed=7)
    vae_arch, vae_state = read_vae(vae_file)
    pipe = DiffusionPipeline(vae_arch, vae_state, UNetArch(**UNET_ARCH),
                             {**tr.unet.state_dict(), **ema},
                             tcfg.ScheduleConfig(num_steps=50), ["0", "1", "2"],
                             dtype=torch.float32, device="cpu")
    ref = pipe.sample([3.0], seed=7, sampler="dpm", num_inference_steps=PREVIEW_STEPS)
    assert got.shape == (3, 16, 16, 3) and torch.equal(got, ref)
    raw = tr.preview.images(tr._named(tr.state.optimizer.params), seed=7)
    assert not torch.equal(raw, ref)


def test_previews_leave_the_losses_as_they_are(tmp_path, vae_file):
    plain, previewed = trainer(tmp_path, "a"), trainer(tmp_path, "b", preview_vae=vae_file,
                                                       preview_freq=1,
                                                       preview_steps=PREVIEW_STEPS)
    plain.train()
    previewed.train()
    assert len(losses(plain.logger)) == 4
    assert losses(previewed.logger) == losses(plain.logger)
    for a, b in zip(plain.state.optimizer.params, previewed.state.optimizer.params):
        assert torch.equal(a, b)


def test_preview_needs_matplotlib_at_construction(tmp_path, vae_file, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        trainer(tmp_path, "m", preview_vae=vae_file, preview_freq=1)
    trainer(tmp_path, "m", preview_vae=vae_file, preview_freq=0)  # previews off: no figure
    # the sampling half needs no matplotlib
    Preview(vae_file, config(tmp_path), trainer(tmp_path, "m").unet.state_dict(),
            steps=PREVIEW_STEPS, device="cpu")


# ----------------------------------------------------------- debug-nans


def test_debug_nans_raises_at_the_first_non_finite_value(tmp_path):
    """A NaN in one latent: without `debug_nans` the run goes on and logs
    NaN losses from the step whose batch holds it; with it the loss check
    raises FloatingPointError naming that step, before its update.  The
    CLI's flag does the same."""
    lat, lab = latents()
    bad = lat.copy()
    bad[5, 0, 0, 0] = np.nan
    runs = {debug: DiffusionTrainer(config(tmp_path, epochs=1), ArrayDataset(bad, lab),
                                    Recorder(str(tmp_path / "logs"), f"d{debug}", True, 1),
                                    MetricHolder(1), run_name=f"d{debug}", device="cpu",
                                    debug_nans=debug)
            for debug in (False, True)}
    runs[False].train()
    got = losses(runs[False].logger)
    assert len(got) == 2 and np.isnan(got).any()
    first_nan = int(np.argmax(np.isnan(got)))
    with pytest.raises(FloatingPointError,
                       match=rf"step {first_nan} \(epoch 0\): non-finite unet/loss"):
        runs[True].train()
    assert runs[True].state.step == first_nan

    from image_diffusion_torch.scripts import train_diffusion

    np.save(tmp_path / "lat.npy", bad)
    np.save(tmp_path / "lab.npy", lab)
    lines = [f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in UNET_ARCH.items()]
    lines += ["num_steps: 50", "batch_size: 4", "epochs: 1", "precision: fp32",
              f"train_set: {tmp_path / 'lat.npy'}", f"train_labels: {tmp_path / 'lab.npy'}",
              f"checkpoints_dir: {tmp_path / 'ck'}", f"logs_dir: {tmp_path / 'logs'}"]
    (tmp_path / "c.yaml").write_text("\n".join(lines) + "\n")
    with pytest.raises(FloatingPointError, match=r"step \d+ \(epoch 0\)"):
        train_diffusion.main(["--config", str(tmp_path / "c.yaml"), "--no-mlflow", "--device",
                              "cpu", "--debug-nans"])


def test_vae_debug_nans_raises_naming_the_step(tmp_path):
    """A NaN in a VAE weight: the debug run raises FloatingPointError at
    step 0 on the VAE objective, before its backward; a normal run trains
    on with non-finite metrics."""
    from image_diffusion_torch.training.vae_trainer import VAETrainer

    arch = VAEArch(**VAE_ARCH)
    train = tcfg.VAETrainConfig(learning_rate=1e-3, batch_size=4, epochs=1, clip_grad=1.0,
                                precision="fp32", seed=0, log_interval=1, disc_start=0,
                                checkpoints_dir=str(tmp_path / "ck"), logs_dir=str(tmp_path))
    images = np.random.default_rng(2).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    for debug in (False, True):
        tr = VAETrainer(tcfg.VAEConfig(arch, train), ArrayDataset(images), None,
                        Recorder(str(tmp_path), f"v{debug}", True, 1), MetricHolder(1),
                        run_name=f"v{debug}", device="cpu", debug_nans=debug)
        with torch.no_grad():
            tr.state.vae.decoder.up[-1].weight[0, 0, 0, 0] = float("nan")
        if debug:
            with pytest.raises(FloatingPointError, match=r"step 0 \(epoch 0\): non-finite"):
                tr.train()
        else:
            tr.train()
            assert any(not np.isfinite(v) for _, m in tr.logger.rows for v in m.values())
