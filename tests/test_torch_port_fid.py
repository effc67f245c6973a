"""The port's FID evaluation against the JAX package's, on the CPU: the
InceptionV3 features on the same random torchvision-layout weights
(tests/torch_oracles.py), the weight-file loader, the running statistics
and the Frechet distance in float64, the FID accumulator, and the VAE
trainer's per-epoch dev/FID.  The eval_fid CLI's tests are in
tests/test_torch_port_eval_fid.py."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core.logging import BasicLogger as JLogger
from image_diffusion_tpu.models import fid as jfid
from image_diffusion_tpu.models.inception import InceptionV3Features as JInception
from image_diffusion_tpu.models.inception import import_inception
from image_diffusion_torch.core.logging import BasicLogger
from image_diffusion_torch.models import fid as tfid
from image_diffusion_torch.models.inception import load_inception
from torch_oracles import random_inception

def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    """random_inception(0)'s state dict written as a torch file, read by the
    port's loader, and imported by the JAX package's."""
    state = random_inception(0).state_dict()
    path = str(tmp_path_factory.mktemp("inception") / "inception.pth")
    torch.save(state, path)
    jvars = import_inception({k: v.numpy() for k, v in state.items()})
    return dict(path=path, state=state, model=load_inception(path, "cpu"),
                jax=jax.jit(lambda x: JInception().apply(jvars, x)))


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 320, 320, 3)],
                         ids=["upsampled", "downsampled"])
def test_inception_features_match_jax(inception, shape):
    """(N, 2048) pool3 features at 1e-5 of the largest, from images below
    and above 299 pixels (bilinear without antialiasing both ways)."""
    x = np.random.default_rng(shape[1]).uniform(size=shape).astype(np.float32)
    got = inception["model"](torch.from_numpy(x))
    ref = np.asarray(inception["jax"](x))
    assert got.shape == (shape[0], 2048) and got.dtype == torch.float32
    assert rel_max(got.numpy(), ref) < 1e-5


def test_inception_loader_takes_the_published_layout_and_refuses_others(inception, tmp_path):
    """The pt_inception-2015-12-05 file holds torchvision's keys with `fc`
    (and no BatchNorm batch counters); `fc` and `AuxLogits` entries are
    ignored, a missing or unknown key raises, as does a file that is no
    state dict."""
    state = {k: v for k, v in inception["state"].items() if not k.endswith("num_batches_tracked")}
    published = {**state, "fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
                 "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1)}
    torch.save(published, tmp_path / "pub.pth")
    loaded = load_inception(str(tmp_path / "pub.pth"), "cpu").state_dict()
    for k, v in state.items():
        assert torch.equal(loaded[k], v), k
    missing = dict(state)
    del missing["Mixed_7c.branch_pool.bn.running_var"]
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_inception(str(tmp_path / "missing.pth"), "cpu")
    torch.save({**state, "Mixed_8a.conv.weight": torch.zeros(1)}, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_inception(str(tmp_path / "extra.pth"), "cpu")
    torch.save(torch.nn.Linear(1, 1), tmp_path / "model.pth")  # a pickled module
    with pytest.raises(pickle.UnpicklingError, match="Weights only load failed"):
        load_inception(str(tmp_path / "model.pth"), "cpu")


def _features(seed, n, d=6):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) + rng.normal(size=d)


def test_running_stats_and_frechet_distance_match_jax():
    """float64 on the same features: mean and covariance of streamed batches
    and the distance at 1e-10; fewer than 2 samples raise."""
    stats = {}
    for name, mod in (("port", tfid), ("jax", jfid)):
        real, fake = mod.RunningStats(6), mod.RunningStats(6)
        for chunk in np.array_split(_features(0, 50), 3):
            real.update(chunk)
        fake.update(_features(1, 30))
        stats[name] = real.finalize() + fake.finalize()
        stats[name] += (mod.frechet_distance(*stats[name]),)
        with pytest.raises(ValueError, match="2 samples"):
            mod.RunningStats(6).finalize()
    for a, b in zip(stats["port"], stats["jax"]):
        assert rel_max(a, b) < 1e-10
    ref = stats["jax"]
    np.testing.assert_allclose(ref[0], _features(0, 50).mean(0), rtol=1e-12)
    np.testing.assert_allclose(ref[1], np.cov(_features(0, 50), rowvar=False), rtol=1e-10)


def test_frechet_distance_retries_with_eps_and_raises_like_jax(monkeypatch):
    """A first eigendecomposition that returns NaN: both retry with 1e-6 I
    added to the covariances and agree at 1e-10 (which moves the value);
    NaN that persists to the eps cap, and non-finite covariances, raise."""
    mu1, mu2 = _features(2, 20).mean(0), _features(3, 20).mean(0)
    c1, c2 = np.cov(_features(2, 20), rowvar=False), np.cov(_features(3, 20), rowvar=False)
    eigh = np.linalg.eigh
    calls = {"n": 0, "fail": 2}

    def flaky(a):
        calls["n"] += 1
        if calls["n"] <= calls["fail"]:
            return np.full(len(a), np.nan), np.eye(len(a))
        return eigh(a)

    monkeypatch.setattr(np.linalg, "eigh", flaky)
    got = {}
    for name, mod in (("port", tfid), ("jax", jfid)):
        calls.update(n=0, fail=2)
        got[name] = mod.frechet_distance(mu1, c1, mu2, c2)
        assert calls["n"] == 4
    eye = np.eye(6) * 1e-6
    monkeypatch.setattr(np.linalg, "eigh", eigh)
    plain = tfid.frechet_distance(mu1, c1, mu2, c2)
    assert abs(got["port"] / got["jax"] - 1) < 1e-10
    assert got["port"] == tfid.frechet_distance(mu1, c1 + eye, mu2, c2 + eye) != plain
    monkeypatch.setattr(np.linalg, "eigh", flaky)
    for mod in (tfid, jfid):
        calls.update(n=0, fail=100)
        with pytest.raises(ValueError, match="eps cap"):
            mod.frechet_distance(mu1, c1, mu2, c2)
        with pytest.raises(ValueError, match="non-finite covariance"):
            mod.frechet_distance(mu1, c1 * np.nan, mu2, c2)


PROJECTION = np.random.default_rng(5).normal(size=(16 * 16 * 3, 6)).astype(np.float32) / 16


def port_features(x01):
    return x01.reshape(len(x01), -1).float() @ torch.from_numpy(PROJECTION)


def jax_features(x01):
    return jnp.asarray(x01, jnp.float32).reshape(x01.shape[0], -1) @ jnp.asarray(PROJECTION)


def test_fid_accumulator_matches_jax():
    """Padded fake batches counted by n_valid, real images latched at the
    first compute, reset_fake between evaluations: the same FIDs as JAX's
    accumulator at 1e-5 (fp32 features of two matmul implementations)."""
    rng = np.random.default_rng(6)
    real = rng.uniform(size=(12, 16, 16, 3)).astype(np.float32)
    fakes = [rng.uniform(size=(10, 16, 16, 3)).astype(np.float32) ** p for p in (1, 2)]
    scores = {}
    for name, fid, wrap in (("port", tfid.FID(port_features, 6), torch.from_numpy),
                            ("jax", jfid.FID(jax_features, 6), np.asarray)):
        out = []
        fid.update_real_once(wrap(real[:8]))
        fid.update_real_once(wrap(np.concatenate([real[8:], np.zeros_like(real[:4])])), 4)
        for fake in fakes:
            fid.reset_fake()
            fid.update_fake(wrap(fake[:6]))
            fid.update_fake(wrap(np.concatenate([fake[6:], np.zeros_like(fake[:2])])), 4)
            out.append(fid.compute())
            fid.update_real_once(wrap(np.ones_like(real[:4])))  # latched: ignored
        assert fid.real.n == 12 and fid.fake.n == 10
        scores[name] = out
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=1e-5)
    assert scores["port"][0] != scores["port"][1]


def test_vae_trainer_dev_fid_matches_jax(tmp_path):
    """8 dev images at batch 3 (a padded tail), VQ, the same weights and
    codebook in both trainers, the same small feature function: the logged
    dev/FID at 2e-4 in two evaluations, the second with the real statistics
    latched (8 images, not 16)."""
    from test_torch_port_vae_training import vq_trainers

    logged = {"j": [], "t": []}

    class JRecorder(JLogger):
        def log_metric(self, name, val, step):
            if name == "dev/FID":
                logged["j"].append(val)

    class Recorder(BasicLogger):
        def log_metric(self, name, val, step):
            if name == "dev/FID":
                logged["t"].append(val)

    jtrainer, trainer = vq_trainers(tmp_path, JRecorder(str(tmp_path), "j", True, 1),
                                    Recorder(str(tmp_path), "t", True, 1))
    jtrainer.fid_fn = jfid.FID(jax_features, 6)
    trainer.fid_fn = tfid.FID(port_features, 6)
    for epoch in (0, 1):
        jtrainer._evaluate(epoch, jax.random.key(3))
        trainer._evaluate(epoch, seed=3)
    assert trainer.fid_fn.real.n == 8 and trainer.fid_fn.fake.n == 8
    assert len(logged["t"]) == 2 and np.isfinite(logged["t"]).all()
    np.testing.assert_allclose(logged["t"], logged["j"], rtol=2e-4)
