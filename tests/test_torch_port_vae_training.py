"""The port's stage-1 training against the JAX package's, on the CPU: the
losses, the discriminator's train-mode BatchNorm, LPIPS, the tiny KL VAE's
training forward, one fp32 VAE-GAN train step of either bottleneck with the
discriminator inactive and active, one step at grad_accum 2 against JAX's
and against the port's own step at 1 (many steps and whole runs:
`test_torch_port_stage1_parity.py`), trainer checkpoints across packages,
dev-set batching and perplexity, the reconstruction figure and the CLI."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core import checkpoint as jckpt
from image_diffusion_tpu.core import config as jcfg
from image_diffusion_tpu.core.logging import BasicLogger as JLogger
from image_diffusion_tpu.core.metrics import MetricHolder as JHolder
from image_diffusion_tpu.models import Discriminator as JDiscriminator
from image_diffusion_tpu.models import build_vae as jbuild_vae
from image_diffusion_tpu.models.lpips import LPIPS as JLPIPS
from image_diffusion_tpu.training import data as jdata
from image_diffusion_tpu.training import losses as jlosses
from image_diffusion_tpu.training.diffusion_trainer import make_optimizer
from image_diffusion_tpu.training.vae_trainer import VAETrainer as JTrainer
from image_diffusion_tpu.training.vae_trainer import VAETrainState as JState
from image_diffusion_tpu.training.vae_trainer import make_vae_train_step as jmake_step
from image_diffusion_tpu.training.vae_trainer import normalize_batch as jnormalize
from image_diffusion_torch.compat.from_jax import (
    disc_flax_params,
    disc_flax_stats,
    disc_state_dict,
    vae_flax_variables,
    vae_state_dict,
)
from image_diffusion_torch.core import config as tcfg
from image_diffusion_torch.core.logging import BasicLogger
from image_diffusion_torch.core.metrics import MetricHolder
from image_diffusion_torch.core.plotting import plot_reconstructions
from image_diffusion_torch.models import build_discriminator, build_vae
from image_diffusion_torch.models.lpips import LPIPS
from image_diffusion_torch.training import data as tdata
from image_diffusion_torch.training import losses as tlosses
from image_diffusion_torch.training.diffusion_trainer import Optimizer
from image_diffusion_torch.training.vae_trainer import (
    VAEDraws,
    VAETrainer,
    VAETrainState,
    make_vae_train_step,
    normalize_batch,
)
from torch_oracles import VGG16_CONV_IDX, random_lpips_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_trainers.py's tiny config, with a discriminator that has a
# BatchNorm layer (disc_channels (8, 16))
ARCH = dict(in_channels=3, channels=(8, 16), z_dim=3, enc_num_res_blocks=1, dec_num_res_blocks=1,
            attn_resolutions=(), num_heads=1, init_resolution=16, num_groups=4)
TRAIN = dict(learning_rate=1e-3, batch_size=4, epochs=1, clip_grad=1.0, precision="fp32", seed=0,
             log_interval=1, disc_start=1, disc_channels=(8, 16))
VQ = dict(bottleneck="vq", codebook_size=16, codebook_beta=0.25, codebook_gamma=0.99)
RNG = jax.random.key(7)


def configs(tmp, bottleneck="kl", **over):
    arch = {**ARCH, **(VQ if bottleneck == "vq" else {})}
    train = {**TRAIN, "checkpoints_dir": str(tmp), "logs_dir": str(tmp), **over}
    return (jcfg.VAEConfig(jcfg.VAEArch(**arch), jcfg.VAETrainConfig(**train)),
            tcfg.VAEConfig(tcfg.VAEArch(**arch), tcfg.VAETrainConfig(**train)))


def images(n=4, res=16, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, res, res, 3)).astype(np.uint8)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("name", ["hinge", "mse", "bce"])
def test_gan_losses_match_jax(name):
    rng = np.random.default_rng(2)
    fake, real = (rng.normal(size=(3, 5, 5, 1)).astype(np.float32) * 2 for _ in range(2))
    d = getattr(tlosses, f"{name}_d_loss")(torch.from_numpy(fake), torch.from_numpy(real))
    g = getattr(tlosses, f"{name}_g_loss")(torch.from_numpy(fake))
    assert tlosses.D_LOSSES[name] is getattr(tlosses, f"{name}_d_loss")
    np.testing.assert_allclose(float(d), float(jlosses.D_LOSSES[name](fake, real)), rtol=1e-6)
    np.testing.assert_allclose(float(g), float(jlosses.G_LOSSES[name](fake)), rtol=1e-6)


def test_recon_losses_match_jax():
    rng = np.random.default_rng(3)
    real, fake = (rng.normal(size=(3, 4, 4, 3)).astype(np.float32) for _ in range(2))
    tr, tf = torch.from_numpy(real), torch.from_numpy(fake).to(torch.bfloat16)
    np.testing.assert_allclose(float(tlosses.recon_loss(tr, tf)),
                               float(jlosses.recon_loss(real, jnp.asarray(fake, jnp.bfloat16))),
                               rtol=1e-6)
    per = tlosses.recon_loss_per_sample(torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(per.numpy(), np.asarray(jlosses.recon_loss_per_sample(real, fake)),
                               rtol=1e-6)
    assert float(per.mean()) == pytest.approx(
        float(tlosses.recon_loss(torch.from_numpy(real), torch.from_numpy(fake))), rel=1e-6)


def test_normalize_batch_matches_jax():
    x = images()
    flip = np.array([True, False, True, False])
    got = normalize_batch(torch.from_numpy(x), torch.from_numpy(flip))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnormalize(x, flip)))


def test_discriminator_train_mode_matches_flax():
    """Two threaded train-mode passes, fp32: logits at 2e-4 (the repo's fp32
    bar), batch statistics and running statistics (biased variance,
    retention 0.9) at 1e-6."""
    rng = np.random.default_rng(4)
    x1, x2 = (rng.normal(size=(3, 16, 16, 3)).astype(np.float32) for _ in range(2))
    model = JDiscriminator(channels=(8, 16), dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, model.init(jax.random.key(0), x1, train=False))
    assert set(variables["params"]) == {"conv_0", "conv_1", "bn_1", "conv_2"}
    apply = jax.jit(lambda p, s, x: model.apply({"params": p, "batch_stats": s}, x, train=True,
                                                mutable=["batch_stats"]))
    disc = build_discriminator((8, 16), torch.float32, "cpu")
    disc.load_state_dict(disc_state_dict(variables["params"], variables["batch_stats"]))
    stats = variables["batch_stats"]
    for x in (x1, x2):
        ref, mut = apply(variables["params"], stats, x)
        stats = jax.tree.map(np.asarray, mut["batch_stats"])
        got = disc(torch.from_numpy(x))
        assert got.shape == (3, 3, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=2e-4)
        for a, b in zip(leaves(disc_flax_stats(disc.state_dict())), leaves(stats)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    # the flax trees round-trip through the state dict
    jax.tree.map(np.testing.assert_array_equal, disc_flax_params(dict(disc.named_parameters())),
                 variables["params"])


def test_discriminator_shape_at_full_width():
    with torch.device("meta"):
        disc = build_discriminator(device="meta")
    assert disc(torch.empty(2, 128, 128, 3, device="meta")).shape == (2, 15, 15, 1)
    assert sum(p.numel() for p in disc.parameters()) == 663_361


def _lpips_package_layout(state):
    """The same weights in the lpips package's key layout."""
    slices = [(1, 0, 4), (2, 4, 9), (3, 9, 16), (4, 16, 23), (5, 23, 30)]
    out = {}
    for idx in VGG16_CONV_IDX:
        s = next(n for n, lo, hi in slices if lo <= idx < hi)
        for leaf in ("weight", "bias"):
            out[f"net.slice{s}.{idx}.{leaf}"] = state[f"features.{idx}.{leaf}"]
    for i in range(5):
        out[f"lin{i}.model.1.weight"] = state[f"lin.{i}.weight"].reshape(1, -1, 1, 1)
    return out


def test_lpips_matches_jax():
    """fp32, reduced and per-sample, both weight layouts: rtol 1e-5."""
    state = random_lpips_state(0)
    rng = np.random.default_rng(5)
    real, fake = (np.tanh(rng.normal(size=(2, 32, 32, 3))).astype(np.float32) for _ in range(2))
    jl = JLPIPS.from_state_dict(state)
    ref = np.asarray(jax.jit(lambda a, b: jl(a, b, reduce=False))(real, fake))
    for layout in (state, _lpips_package_layout(state)):
        lp = LPIPS.from_state_dict(layout)
        with torch.no_grad():
            per = lp(torch.from_numpy(real), torch.from_numpy(fake), reduce=False)
            mean = lp(torch.from_numpy(real), torch.from_numpy(fake))
        np.testing.assert_allclose(per.numpy(), ref, rtol=1e-5)
        np.testing.assert_allclose(float(mean), ref.mean(), rtol=1e-5)
    bf = LPIPS.from_state_dict(state).astype(torch.bfloat16)
    assert bf.convs[0][0].dtype == torch.bfloat16 and bf.weights[0][0].dtype == torch.float32
    with torch.no_grad():
        approx = bf(torch.from_numpy(real), torch.from_numpy(fake), reduce=False)
    assert approx.dtype == torch.float32
    np.testing.assert_allclose(approx.numpy(), ref, rtol=5e-2)


def test_lpips_file_loader(tmp_path):
    from image_diffusion_torch.models.lpips import try_load_lpips

    state = random_lpips_state(1)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "vgg.pth")
    lp = try_load_lpips(str(tmp_path / "vgg.pth"))
    assert lp is not None and len(lp.convs) == 13
    np.testing.assert_array_equal(lp.weights[3][0].numpy(), state["features.7.weight"])
    assert try_load_lpips(None) is None and try_load_lpips(str(tmp_path / "missing.pth")) is None


_MODELS = {}


def models(bottleneck):
    """The tiny JAX VAE (fp32) of `bottleneck`, discriminator, random LPIPS
    and initial variables (made once per bottleneck)."""
    if bottleneck not in _MODELS:
        _MODELS[bottleneck] = _make_models(bottleneck)
    return _MODELS[bottleneck]


@pytest.fixture(scope="module")
def jax_models():
    return models("kl")


def _make_models(bottleneck):
    jc, _ = configs("/nonexistent", bottleneck)
    vae = jbuild_vae(jc.arch, dtype=jnp.float32)
    disc = JDiscriminator(channels=jc.train.disc_channels, dtype=jnp.float32)
    x0 = np.zeros((1, 16, 16, 3), np.float32)
    vae_vars = jax.tree.map(np.asarray, jax.jit(lambda: vae.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, x0))())
    disc_vars = jax.tree.map(np.asarray, jax.jit(lambda: disc.init(jax.random.key(2), x0,
                                                                   train=False))())
    return vae, disc, JLPIPS.from_state_dict(random_lpips_state(0)), vae_vars, disc_vars


def test_tiny_kl_vae_training_forward_matches_flax(jax_models):
    """forward(sample=True, noise) and the KL prior, fp32: 2e-4."""
    vae, _, _, vae_vars, _ = jax_models
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    noise = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    ref, prior, perp = jax.jit(lambda v, x, n: vae.apply(v, x, sample=True, noise=n))(vae_vars, x, noise)
    mean_ref, _, _ = jax.jit(lambda v, x: vae.apply(v, x, sample=False))(vae_vars, x)
    model = build_vae(tcfg.VAEArch(**ARCH), torch.float32, "cpu")
    model.load_state_dict(vae_state_dict(vae_vars))
    with torch.no_grad():
        got, got_prior, got_perp = model(torch.from_numpy(x), sample=True, noise=torch.from_numpy(noise))
        mean_got, _, _ = model(torch.from_numpy(x), sample=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    np.testing.assert_allclose(mean_got.numpy(), np.asarray(mean_ref), atol=2e-4)
    assert float(got_prior) == pytest.approx(float(prior), rel=2e-4)
    assert float(got_perp) == float(perp) == 0.0


# -------------------------------------------------------------- train step


def jax_draws(step, B=4):
    """The flip mask and noise of the JAX step body, in its order."""
    k_flip, k_sample = jax.random.split(jax.random.fold_in(RNG, step))
    flip = jax.random.bernoulli(k_flip, 0.5, (B,))
    noise = jax.random.normal(k_sample, (B, 8, 8, 3), jnp.float32)
    return VAEDraws(torch.from_numpy(np.array(flip)), torch.from_numpy(np.array(noise)))


_JAX_STEPS = {}


def jax_step(bottleneck, disc_active, accum=1):
    """One fp32 JAX train step from the initial variables: the new state
    and the metrics (computed once per argument set)."""
    key = (bottleneck, disc_active, accum)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = _run_jax_step(*key)
    return _JAX_STEPS[key]


def percept(bottleneck, lpips):
    """The step tests' LPIPS term: `lpips` for KL, none for VQ.  A tiny VQ
    VAE at init decodes every position from nearly the same code, so its
    reconstructions are nearly constant and the random VGG's max-pools see
    near-ties: JAX's own LPIPS gradient moves by 1.1% (relative L2) when
    x_hat moves by 2.4e-6, the size of the port-vs-JAX difference in
    x_hat, so a VQ step with LPIPS would hold that conditioning to the
    2e-4 bar, not the trainer.  The KL cases hold the LPIPS term's path."""
    return lpips if bottleneck == "kl" else None


def _run_jax_step(bottleneck, disc_active, accum):
    vae, disc, lp, vae_vars, disc_vars = models(bottleneck)
    lp = percept(bottleneck, lp)
    jc, _ = configs("/nonexistent", bottleneck, grad_accum=accum)
    vae_tx = make_optimizer(jc.train.learning_rate, jc.train.warmup_steps, jc.train.clip_grad)
    disc_tx = make_optimizer(jc.train.learning_rate, 0, jc.train.clip_grad)
    state = JState(step=jnp.zeros((), jnp.int32), vae_params=vae_vars["params"],
                   vae_opt=vae_tx.init(vae_vars["params"]), codebook=vae_vars.get("codebook"),
                   disc_params=disc_vars["params"], disc_stats=disc_vars["batch_stats"],
                   disc_opt=disc_tx.init(disc_vars["params"]))
    step = jmake_step(vae, disc, jc, lp, vae_tx, disc_tx)
    new, metrics = step(state, images(), RNG, disc_active=disc_active)
    return jax.tree.map(np.asarray, new), {k: float(v) for k, v in metrics.items()}


def port_state(bottleneck):
    _, _, _, vae_vars, disc_vars = models(bottleneck)
    _, tc = configs("/nonexistent", bottleneck)
    vae = build_vae(tc.arch, torch.float32, "cpu", param_dtype=torch.float32)
    vae.load_state_dict(vae_state_dict(vae_vars))
    disc = build_discriminator(tc.train.disc_channels, torch.float32, "cpu")
    disc.load_state_dict(disc_state_dict(disc_vars["params"], disc_vars["batch_stats"]))
    lr, clip = tc.train.learning_rate, tc.train.clip_grad
    return VAETrainState(vae, disc, Optimizer(vae.parameters(), lr, tc.train.warmup_steps, clip),
                         Optimizer(disc.parameters(), lr, 0, clip))


def port_step(bottleneck, disc_active, accum=1):
    """The port's step on `jax_step`'s inputs: (state, metrics)."""
    state = port_state(bottleneck)
    _, tc = configs("/nonexistent", bottleneck, grad_accum=accum)
    lpips = percept(bottleneck, LPIPS.from_state_dict(random_lpips_state(0)))
    metrics = make_vae_train_step(tc, lpips)(state, torch.from_numpy(images()), jax_draws(0),
                                             disc_active)
    return state, metrics


def codebook_tree(vae):
    """The port VAE's codebook as the JAX trainer's `codebook` tree."""
    return vae_flax_variables({k: v for k, v in vae.state_dict().items()
                               if k.startswith("codebook.")})["codebook"]


def _assert_moments(got, ref):
    """Adam's moments after one update are 0.1 g and 1e-3 g^2 of the
    clipped gradient g: per tensor, the fp32 bar 2e-4 of its norm, with a
    1e-9 floor for gradients that are zero but for fp noise."""
    for a, b in zip(leaves(got), leaves(ref)):
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) < 2e-4 * np.linalg.norm(b) + 1e-9


def _assert_step_matches(state, metrics, bottleneck, disc_active, accum=1):
    """The port's step against JAX's from the same state and inputs: every
    metric at rtol 2e-4; both Adams' moments per tensor (see
    `_assert_moments`); the parameter updates p - p0 over all tensors at
    relative L2 1e-3 (Adam divides by sqrt(nu), which turns fp noise in
    near-zero gradients into lr-sized differences per element); BatchNorm
    running statistics at 1e-6; the VQ codebook (cluster sizes, ema_w,
    embeddings) at rtol 1e-5."""
    _, _, _, vae_vars, disc_vars = models(bottleneck)
    ref_state, ref_metrics = jax_step(bottleneck, disc_active, accum)
    assert set(metrics) == set(ref_metrics)
    for name, ref in ref_metrics.items():
        assert float(metrics[name]) == pytest.approx(ref, rel=2e-4, abs=1e-7), name

    vae_names = [n for n, _ in state.vae.named_parameters()]
    disc_names = [n for n, _ in state.disc.named_parameters()]

    def vae_tree(tensors):
        return vae_flax_variables(dict(zip(vae_names, tensors)))["params"]

    def disc_tree(tensors):
        return disc_flax_params(dict(zip(disc_names, tensors)))

    mu, nu = state.vae_opt.moments()
    adam = ref_state.vae_opt[1][0]
    _assert_moments(vae_tree(mu), adam.mu)
    _assert_moments(vae_tree(nu), adam.nu)
    got = np.concatenate([(a - b).ravel() for a, b in zip(leaves(vae_tree(state.vae_opt.params)),
                                                         leaves(vae_vars["params"]))])
    ref = np.concatenate([(a - b).ravel() for a, b in zip(leaves(ref_state.vae_params),
                                                         leaves(vae_vars["params"]))])
    assert rel_l2(got, ref) < 1e-3
    assert state.step == int(ref_state.step) == 1
    if bottleneck == "vq":
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5),
                     codebook_tree(state.vae), ref_state.codebook)
        assert not np.array_equal(ref_state.codebook["codebook"]["embeddings"],
                                  vae_vars["codebook"]["codebook"]["embeddings"])

    stats = disc_flax_stats(state.disc.state_dict())
    for a, b in zip(leaves(stats), leaves(ref_state.disc_stats)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    dadam = ref_state.disc_opt[1][0]
    assert state.disc_opt.count == int(dadam.count) == int(disc_active)
    if disc_active:
        dmu, dnu = state.disc_opt.moments()
        _assert_moments(disc_tree(dmu), dadam.mu)
        _assert_moments(disc_tree(dnu), dadam.nu)
        got = np.concatenate([(a - b).ravel() for a, b in zip(
            leaves(disc_tree(state.disc_opt.params)), leaves(disc_vars["params"]))])
        ref = np.concatenate([(a - b).ravel() for a, b in zip(
            leaves(ref_state.disc_params), leaves(disc_vars["params"]))])
        assert rel_l2(got, ref) < 1e-3
    else:  # an inactive discriminator is untouched, statistics included
        for a, b in zip(leaves(disc_tree(state.disc_opt.params)), leaves(disc_vars["params"])):
            np.testing.assert_array_equal(a, b)
        jax.tree.map(np.testing.assert_array_equal, stats, disc_vars["batch_stats"])


@pytest.mark.parametrize("disc_active", [False, True], ids=["disc_inactive", "disc_active"])
@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_one_fp32_train_step_matches_jax(bottleneck, disc_active):
    """The same parameters, codebook, batch, flip mask and noise: the state
    and metrics after one step (see `_assert_step_matches`)."""
    _assert_step_matches(*port_step(bottleneck, disc_active), bottleneck, disc_active)


@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_accumulated_train_step_matches_jax(bottleneck):
    """grad_accum 2 with the discriminator active against JAX's grad_accum
    2 step: the micro-batches' BatchNorm statistics chained in the same
    order, the VQ statistics summed and applied once (see
    `_assert_step_matches`)."""
    _assert_step_matches(*port_step(bottleneck, True, accum=2), bottleneck, True, accum=2)


@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_accumulated_train_step_matches_one_shot(bottleneck):
    """With the discriminator inactive, grad_accum 2 equals grad_accum 1 on
    the same batch: recon, percept and prior losses and the gradient norm
    at rtol 1e-5; the gradient Adam was given (clipped, averaged over the
    micro-batches) at relative L2 1e-6, fp32 summation-order noise (~1e-7);
    the parameter updates at relative L2 1e-3 (see
    `test_one_fp32_train_step_matches_jax`); the codebook after its one
    EMA update at rtol 1e-5."""
    one, m1 = port_step(bottleneck, False)
    two, m2 = port_step(bottleneck, False, accum=2)
    for k in ("vae/recon_loss", "vae/percept_loss", "vae/prior_loss", "vae/vae_grad"):
        assert float(m2[k]) == pytest.approx(float(m1[k]), rel=1e-5, abs=1e-7), k
    g1, g2 = (torch.cat([p.grad.flatten() for p in s.vae_opt.params]) for s in (one, two))
    assert rel_l2(g2.numpy(), g1.numpy()) < 1e-6
    p0 = port_state(bottleneck).vae_opt.params
    u1, u2 = (torch.cat([(p - q).flatten() for p, q in zip(s.vae_opt.params, p0)]).detach()
              for s in (one, two))
    assert rel_l2(u2.numpy(), u1.numpy()) < 1e-3
    if bottleneck == "vq":
        for a, b in zip(two.vae.codebook.buffers(), one.vae.codebook.buffers()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    assert two.step == one.step == 1 and two.disc_opt.count == 0


# ------------------------------------------------------------- the trainer


@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_checkpoints_cross_packages(tmp_path, bottleneck):
    """A JAX trainer checkpoint resumes in the port with equal parameters,
    VQ codebook, BatchNorm statistics, both Adams' moments and step; after
    one more step the port's checkpoint restores into the JAX trainer's
    state and resumes in the JAX trainer with equal values."""
    jc, tc = configs(tmp_path, bottleneck)
    data = jdata.ArrayDataset(images())
    jtrainer = JTrainer(jc, data, None, JLogger(str(tmp_path), "j", True, 1), JHolder(1),
                        run_name="j")
    jtrainer.state, _ = jax_step(bottleneck, disc_active=True)
    path = jtrainer.save(0)
    js = jtrainer.state

    trainer = VAETrainer(tc, tdata.ArrayDataset(images()), None, BasicLogger(str(tmp_path), "t", True, 1),
                         MetricHolder(1), checkpoint=path, run_name="t", device="cpu")
    st = trainer.state
    assert st.step == 1 and st.disc_opt.count == 1 and trainer.curr_epoch == 1

    def trees(state):
        vmu, vnu = state.vae_opt.moments()
        dmu, dnu = state.disc_opt.moments()
        vae = lambda ts: vae_flax_variables(dict(zip(trainer.vae_names, ts)))["params"]  # noqa: E731
        disc = lambda ts: disc_flax_params(dict(zip(trainer.disc_names, ts)))  # noqa: E731
        return [vae(state.vae_opt.params), vae(vmu), vae(vnu), disc(state.disc_opt.params),
                disc(dmu), disc(dnu), disc_flax_stats(state.disc.state_dict())]

    vadam, dadam = js.vae_opt[1][0], js.disc_opt[1][0]
    for got, ref in zip(trees(st), [js.vae_params, vadam.mu, vadam.nu, js.disc_params, dadam.mu,
                                    dadam.nu, js.disc_stats]):
        for a, b in zip(leaves(got), leaves(ref)):
            np.testing.assert_array_equal(a, b)
    if bottleneck == "vq":
        jax.tree.map(np.testing.assert_array_equal, codebook_tree(st.vae), js.codebook)

    trainer.train_step(st, torch.from_numpy(images()), jax_draws(1), True)
    back = trainer.save(3)
    saved, meta = jckpt.load_checkpoint(back)
    assert meta["epoch"] == 3 and int(saved["extra"]["step"]) == 2
    restored = [jckpt.restore_into(js.vae_params, saved["vae"]),
                jckpt.restore_into(js.vae_opt, saved["vae_optim"]),
                jckpt.restore_into(js.disc_params, saved["disc"]),
                jckpt.restore_into(js.disc_opt, saved["disc_optim"]),
                jckpt.restore_into(js.disc_stats, saved["disc_stats"])]
    vadam, dadam = restored[1][1][0], restored[3][1][0]
    assert int(vadam.count) == 2 and int(dadam.count) == 2
    for got, ref in zip([restored[0], vadam.mu, vadam.nu, restored[2], dadam.mu, dadam.nu,
                         restored[4]], trees(st)):
        for a, b in zip(leaves(got), leaves(ref)):
            np.testing.assert_array_equal(a, b)
    resumed = JTrainer(jc, data, None, jtrainer.logger, JHolder(1), checkpoint=back, run_name="j")
    assert int(resumed.state.step) == 2 and resumed.curr_epoch == 4
    assert ("codebook" in saved) == (bottleneck == "vq")
    if bottleneck == "vq":
        assert not np.array_equal(saved["codebook"]["codebook"]["embeddings"],
                                  js.codebook["codebook"]["embeddings"])
        for tree in (jckpt.restore_into(js.codebook, saved["codebook"]), resumed.state.codebook):
            jax.tree.map(np.testing.assert_array_equal, tree, codebook_tree(st.vae))


def test_checkpoint_trees_are_copies_of_the_state():
    """The flax trees a checkpoint is written from hold copies of the CPU
    tensors, not views: an asynchronous save serializes them on a thread
    while the next step updates parameters and codebook in place."""
    vae = build_vae(configs("/nonexistent", "vq")[1].arch, torch.float32, "cpu",
                    torch.Generator().manual_seed(0))
    disc = build_discriminator((8, 16), torch.float32, "cpu", torch.Generator().manual_seed(1))
    trees = [vae_flax_variables(vae.state_dict()), disc_flax_params(dict(disc.named_parameters())),
             disc_flax_stats(disc.state_dict())]
    before = [[a.copy() for a in leaves(t)] for t in trees]
    with torch.no_grad():
        for t in list(vae.state_dict().values()) + list(disc.state_dict().values()):
            t.add_(1.0)
    for tree, ref in zip(trees, before):
        for a, b in zip(leaves(tree), ref):
            np.testing.assert_array_equal(a, b)


def test_eval_batches_count_each_sample_once():
    x = images(n=8)
    got = list(tdata.eval_batches(tdata.ArrayDataset(x), 3))
    ref = list(jdata.eval_batches(jdata.ArrayDataset(x), 3))
    assert [n for n, _ in got] == [n for n, _ in ref] == [3, 3, 2]
    for (_, (a,)), (_, (b,)) in zip(got, ref):
        assert a.dtype == torch.uint8 and a.shape == (3, 16, 16, 3)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    seen = np.concatenate([a.numpy()[:n] for n, (a,) in got])
    np.testing.assert_array_equal(seen, x)


def test_dev_evaluation_weights_the_padded_tail(tmp_path):
    """8 dev images at batch 3: the logged dev losses are the means over the
    8 samples, whatever the pad rows hold."""
    _, tc = configs(tmp_path, batch_size=3)
    x = images(n=8)

    class Recorder(BasicLogger):
        def log_metric(self, name, val, step):
            logged[name] = val

    logged = {}
    lp = LPIPS.from_state_dict(random_lpips_state(0))
    trainer = VAETrainer(tc, tdata.ArrayDataset(x), tdata.ArrayDataset(x),
                         Recorder(str(tmp_path), "e", True, 1), MetricHolder(1), run_name="e",
                         percept_fn=lp, device="cpu")
    trainer._evaluate(0, seed=5)
    from image_diffusion_torch.core.rng import eval_generator

    gen, recon, percept = eval_generator(5), [], []
    for n_valid, (xb,) in tdata.eval_batches(tdata.ArrayDataset(x), 3):
        noise = torch.randn((3, 8, 8, 3), generator=gen)
        _, rl, pl, _ = trainer.eval_step(trainer.state.vae, xb, noise, n_valid)
        recon.append(rl[:n_valid])
        percept.append(pl[:n_valid])
    assert len(torch.cat(recon)) == 8
    assert logged["dev/recon_loss"] == pytest.approx(float(torch.cat(recon).mean()), rel=1e-6)
    assert logged["dev/percept_loss"] == pytest.approx(float(torch.cat(percept).mean()), rel=1e-6)


def dev_images():
    """8 images of distinct brightness, so that the tiny VQ VAE's tokens
    spread over the codes of `spread_codebook`."""
    rng = np.random.default_rng(9)
    return (rng.integers(0, 64, (8, 16, 16, 3)) + 24 * np.arange(8)[:, None, None, None]
            ).astype(np.uint8)


def vq_trainers(tmp_path, jlogger, tlogger, **over):
    """A JAX VQ trainer whose codebook holds 16 of its encoder's tokens of
    `dev_images` (the float64 gap between any token's two nearest codes is
    >= 4.4e-6, far above the port-vs-JAX distance error ~1e-7), and the
    port's trainer resumed from its checkpoint."""
    jc, tc = configs(tmp_path, "vq", batch_size=3, **over)
    x = dev_images()
    jtrainer = JTrainer(jc, jdata.ArrayDataset(x), jdata.ArrayDataset(x), jlogger, JHolder(1),
                        run_name="j")
    variables = {"params": jtrainer.state.vae_params, "codebook": jtrainer.state.codebook}
    z = np.asarray(jtrainer.vae.apply(variables, jnormalize(x), method=lambda m, x: m.encoder(x)))
    emb = z.reshape(-1, 3)[np.random.default_rng(9).choice(8 * 64, 16, replace=False)]
    inner = {**jtrainer.state.codebook["codebook"], "embeddings": jnp.asarray(emb)}
    jtrainer.state = jtrainer.state.replace(codebook={"codebook": inner})
    trainer = VAETrainer(tc, tdata.ArrayDataset(x), tdata.ArrayDataset(x), tlogger, MetricHolder(1),
                         checkpoint=jtrainer.save(0), run_name="t", device="cpu")
    return jtrainer, trainer


def test_dev_perplexity_over_a_padded_tail_matches_jax(tmp_path):
    """8 dev images at batch 3, VQ, the same weights and codebook: the
    logged dev/perplexity (each batch's perplexity over its valid rows,
    weighted by their number) and the dev losses at rtol 2e-4.  The tail's
    pad row, and the weighting, each move the value by more than that."""
    logged = {"j": {}, "t": {}}

    class JRecorder(JLogger):
        def log_metric(self, name, val, step):
            logged["j"][name] = val

    class Recorder(BasicLogger):
        def log_metric(self, name, val, step):
            logged["t"][name] = val

    jtrainer, trainer = vq_trainers(tmp_path, JRecorder(str(tmp_path), "j", True, 1),
                                    Recorder(str(tmp_path), "t", True, 1))
    jtrainer._evaluate(0, jax.random.key(3))
    trainer._evaluate(0, seed=3)
    assert set(logged["t"]) == set(logged["j"]) == {"dev/recon_loss", "dev/percept_loss",
                                                    "dev/perplexity"}
    for name, ref in logged["j"].items():
        assert logged["t"][name] == pytest.approx(ref, rel=2e-4, abs=1e-7), name
    batches = list(tdata.eval_batches(trainer.dev_set, 3))
    perps = [float(trainer.eval_step(trainer.state.vae, x, None, n)[3]) for n, (x,) in batches]
    n_tail, (x_tail,) = batches[-1]
    all_rows = float(trainer.eval_step(trainer.state.vae, x_tail, None)[3])
    assert n_tail == 2 and abs(all_rows / perps[-1] - 1) > 1e-3
    assert abs(np.mean(perps) / logged["t"]["dev/perplexity"] - 1) > 1e-3


def test_reconstruction_figure_matches_jax_eval_step(tmp_path, monkeypatch):
    """Every `log_imgs_freq` steps of `train`, before the step, the first 4
    images of the plot set and their reconstructions through the eval
    path: those against JAX's eval step on the same weights (exact and at
    2e-4), and the figure written as plots/{step}_recon.png."""
    from image_diffusion_torch.training import vae_trainer

    plot = tmp_path / "plot.npy"
    np.save(plot, dev_images()[2:8])
    drawn = []
    monkeypatch.setattr(vae_trainer, "plot_reconstructions",
                        lambda a, b: drawn.append((a, b)) or plot_reconstructions(a, b))
    jtrainer, trainer = vq_trainers(tmp_path, JLogger(str(tmp_path), "j", True, 1),
                                    BasicLogger(str(tmp_path), "t", True, 1), plot_set=str(plot),
                                    log_imgs_freq=3, epochs=2)
    x = dev_images()[2:6]
    ref_hat = jtrainer.eval_step(jtrainer.state.vae_params, jtrainer.state.codebook, x,
                                 jax.random.key(0), 4)[0]
    trainer.train()  # epoch 1 of 2: steps 2 and 3, the figure before step 2, the first
    assert len(drawn) == 1 and (tmp_path / "t" / "plots" / "2_recon.png").exists()
    np.testing.assert_array_equal(drawn[0][0], np.asarray(jnormalize(x)))
    np.testing.assert_allclose(drawn[0][1], np.asarray(ref_hat), atol=2e-4)


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A grad_accum that does not divide the batch, a plot set without
    matplotlib, and the default device without a card raise; VQ and
    grad_accum configs construct, the codebook outside the VAE's Adam."""
    data = tdata.ArrayDataset(images())
    logger = BasicLogger(str(tmp_path), "r", True, 1)
    with pytest.raises(ValueError, match="grad_accum"):
        VAETrainer(configs(tmp_path, grad_accum=3)[1], data, None, logger, MetricHolder(1),
                   device="cpu")
    for tc in (configs(tmp_path, grad_accum=2)[1], configs(tmp_path, "vq", grad_accum=2)[1]):
        st = VAETrainer(tc, data, None, logger, MetricHolder(1), device="cpu").state
        assert len(st.vae_opt.params) == len(list(st.vae.parameters()))
    codebook = {id(b) for b in st.vae.codebook.buffers()}
    assert len(codebook) == 3 and not codebook & {id(p) for p in st.vae_opt.params}
    np.save(tmp_path / "plot.npy", images())
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        VAETrainer(configs(tmp_path, plot_set=str(tmp_path / "plot.npy"))[1], data, None, logger,
                   MetricHolder(1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VAETrainer(configs(tmp_path)[1], data, None, logger, MetricHolder(1))


def _write_config(tmp_path, arch=ARCH, **over):
    lines = [f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in arch.items()]
    train = {**TRAIN, "precision": "fp16", "epochs": 2, "log_interval": 2,
             "train_set": tmp_path / "train.npy", "dev_set": tmp_path / "dev.npy",
             "checkpoints_dir": tmp_path / "ck", "logs_dir": tmp_path / "logs", **over}
    lines += [f"{k}: {list(v) if isinstance(v, tuple) else v}" for k, v in train.items()]
    (tmp_path / "c.yaml").write_text("\n".join(lines) + "\n")
    np.save(tmp_path / "train.npy", images(n=8, seed=7))
    np.save(tmp_path / "dev.npy", images(n=5, seed=8))
    return str(tmp_path / "c.yaml")


def _cli(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-m", "image_diffusion_torch.scripts.train_vae",
                           "--config", _write_config(tmp_path), "--experiment-name", "cli",
                           "--no-mlflow", "--device", "cpu", *args],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def _main(tmp_path, *args):
    """The CLI's `main` in this process."""
    from image_diffusion_torch.scripts.train_vae import main

    return main(["--config", _write_config(tmp_path), "--experiment-name", "cli", "--no-mlflow",
                 "--device", "cpu", *args])


def test_cli_trains_a_tiny_config_on_the_cpu(tmp_path):
    """2 epochs of 2 steps (the discriminator from step 1), bf16 compute,
    random LPIPS weights from a file, through `python -m`; then the run
    resumes from epoch 0 and trains epoch 1 again."""
    state = random_lpips_state(0)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "vgg.pth")
    out = _cli(tmp_path, "--lpips-weights", str(tmp_path / "vgg.pth"))
    assert out.returncode == 0, out.stderr
    for epoch in (0, 1):
        assert (tmp_path / "ck" / "cli" / f"vae-epoch-{epoch:02}.ckpt").exists()
    rows = [r.split(",") for r in (tmp_path / "logs" / "cli_metrics.csv").read_text().splitlines()[1:]]
    names = {name for _, name, _ in rows}
    assert {"vae/recon_loss", "vae/percept_loss", "vae/prior_loss", "vae/vae_grad", "gan/d_loss",
            "gan/g_loss", "gan/fake_acc", "gan/real_acc", "gan/disc_grad", "util/imgs_per_sec",
            "dev/recon_loss", "dev/percept_loss"} <= names
    assert all(np.isfinite(float(v)) for _, _, v in rows)
    assert float(next(v for _, n, v in rows if n == "vae/percept_loss")) > 0
    resumed = _main(tmp_path, "--lpips-weights", str(tmp_path / "vgg.pth"), "--checkpoint",
                    str(tmp_path / "ck" / "cli" / "vae-epoch-00.ckpt"))
    assert resumed.curr_epoch == 1 and resumed.state.step == 4


def test_cli_needs_lpips_or_the_acknowledgment(tmp_path):
    with pytest.raises(SystemExit, match="--allow-no-lpips"):
        _main(tmp_path)
    with pytest.warns(UserWarning, match="ZERO"):
        _main(tmp_path, "--allow-no-lpips")
    rows = (tmp_path / "logs" / "cli_metrics.csv").read_text().splitlines()
    assert any(",vae/percept_loss,0.0" in r for r in rows)


def test_cli_trains_the_vq_config_with_accumulation(tmp_path):
    """The VQ keys of configs/vae-vq-32x32.yaml at the tiny width, at
    grad_accum 2 (micro-batches of 2), with a plot set, through the CLI's
    `main`: 2 epochs of 2 steps with the perplexity at each flush, the dev
    perplexity, a figure every 2 steps, the codebook in each checkpoint and
    moved by training, and a resume that restores it bit for bit."""
    from image_diffusion_torch.scripts.train_vae import main

    np.save(tmp_path / "plot.npy", images(n=4, seed=9))
    config = _write_config(tmp_path, arch={**ARCH, **VQ}, grad_accum=2, log_imgs_freq=2,
                           plot_set=tmp_path / "plot.npy")
    args = ["--config", config, "--experiment-name", "vq", "--no-mlflow", "--device", "cpu",
            "--allow-no-lpips"]
    with pytest.warns(UserWarning, match="ZERO"):
        trainer = main(args)
    rows = [r.split(",") for r in (tmp_path / "logs" / "vq_metrics.csv").read_text().splitlines()[1:]]
    names = [name for _, name, _ in rows]
    assert names.count("vae/perplexity") == 2 and names.count("dev/perplexity") == 2
    assert all(np.isfinite(float(v)) for _, _, v in rows)
    assert sorted(os.listdir(tmp_path / "logs" / "vq" / "plots")) == ["1_recon.png", "3_recon.png"]
    ck = str(tmp_path / "ck" / "vq" / "vae-epoch-01.ckpt")
    trees, _ = jckpt.load_checkpoint(ck)
    jax.tree.map(np.testing.assert_array_equal, trees["codebook"], codebook_tree(trainer.state.vae))
    init = build_vae(trainer.cfg.arch, torch.float32, "cpu", torch.Generator().manual_seed(0))
    assert not torch.equal(init.codebook.embeddings.weight, trainer.state.vae.codebook.embeddings.weight)
    with pytest.warns(UserWarning, match="ZERO"):
        resumed = main(args + ["--checkpoint", ck])
    assert resumed.curr_epoch == 2 and resumed.state.step == 4
    for a, b in zip(resumed.state.vae.codebook.buffers(), trainer.state.vae.codebook.buffers()):
        assert torch.equal(a, b)
