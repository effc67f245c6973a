"""The port's end-to-end quality run (image_diffusion_torch/tools/
e2e_synthetic_run.py) against the JAX package's tools/e2e_synthetic_run.py
on the CPU: the synthetic data and the grader, the seed-11 random
Inception file both histories grade with, the reconstruction-FID loop and
the VQ codebook numbers on a tiny VAE with the same weights, and whole runs
of the port's tool at tiny widths whose reports and history rows have the
JAX rows' keys."""

import functools
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core import config as jcfg
from image_diffusion_tpu.models import build_vae as jbuild_vae
from image_diffusion_tpu.models import fid as jfid
from image_diffusion_tpu.training.vae_trainer import make_eval_step as jmake_eval_step
from image_diffusion_tpu.training.vae_trainer import normalize_batch as jnormalize
from image_diffusion_torch.compat.from_jax import vae_state_dict
from image_diffusion_torch.core import config as tcfg
from image_diffusion_torch.models import build_vae
from image_diffusion_torch.models import fid as tfid
from image_diffusion_torch.tools import e2e_synthetic_run as tool
from image_diffusion_torch.training.vae_trainer import make_eval_step
from torch_oracles import random_inception

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import check_e2e_history  # noqa: E402
import e2e_synthetic_run as jtool  # noqa: E402

# tests/test_torch_port_vae_training.py's tiny VAE (16x16 images, 8x8x3 latents)
ARCH = dict(in_channels=3, channels=(8, 16), z_dim=3, enc_num_res_blocks=1, dec_num_res_blocks=1,
            attn_resolutions=(), num_heads=1, init_resolution=16, num_groups=4)
VQ = dict(bottleneck="vq", codebook_size=16, codebook_beta=0.25, codebook_gamma=0.99)
# the whole tool at tiny widths: 128x128 images to 8x8x3 latents, and a
# UNet whose attention at 64 tokens keeps ddpm-1000 grading cheap
TOOL_VAE = tcfg.VAEArch(channels=(8, 8, 8, 8, 16), enc_num_res_blocks=1, dec_num_res_blocks=1,
                        num_groups=4)
TOOL_UNET = tcfg.UNetArch(channels=(8, 16), mid_channels=(16, 16), time_dim=16, num_res_layers=1,
                          num_heads=2, num_groups=4)
TOOL_ARGS = ["--n-per-class", "8", "--batch", "8", "--vae-steps", "2", "--unet-steps", "2",
             "--fid-images", "0", "--sample-per-class", "1", "--device", "cpu"]
FID_KEYS = {"fid_weights", "recon_fid", "recon_fid_images", "generative_fid", "fid_images",
            "fid_sampler", "fid_img_per_sec"}
# the reconstruction-FID loop: the tool's --batch and its real chunk are
# replaced by 4 and the tool's 90; 5 dev images a class, so both tails pad
DEV_BATCH = 4
# the FID's features: 8 fixed pixel values of the 16x16x3 image, which both
# packages take without arithmetic, so that the statistics differ only by
# the reconstructions
PIXELS = np.random.default_rng(5).choice(16 * 16 * 3, 8, replace=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models run faster on one intra-op thread than on a share
    of the host's cores (10.7 s against 46 s for a run of the tool)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("seed", [0, 777])
def test_dataset_and_grader_equal_jax(seed):
    """make_dataset is bit-equal to the JAX tool's (images and labels), and
    anisotropy and classify agree exactly on every image."""
    imgs, labels = tool.make_dataset(20, seed=seed)
    ref_imgs, ref_labels = jtool.make_dataset(20, seed=seed)
    np.testing.assert_array_equal(imgs, ref_imgs)
    np.testing.assert_array_equal(labels, ref_labels)
    assert imgs.shape == (60, 128, 128, 3) and imgs.dtype == np.uint8
    for img in imgs.astype(np.float32) / 255.0:
        assert tool.anisotropy(img) == jtool.anisotropy(img)
        assert tool.classify(img) == jtool.classify(img)
    assert tool.PROFILES == jtool.PROFILES


def test_inception_file_equals_the_test_oracle(tmp_path):
    """The port's random Inception file at seed 11 is bit-equal to the JAX
    tool's, tests/torch_oracles.py:random_inception(seed=11): every tensor
    of the state dict."""
    path = str(tmp_path / "inception_oracle.pt")
    tool.random_inception_file(path, tool.INCEPTION_SEED)
    got = torch.load(path, weights_only=True)
    ref = random_inception(seed=11).state_dict()
    assert tool.INCEPTION_SEED == 11 and set(got) == set(ref) and len(got) > 500
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def port_features(x01):
    return x01.reshape(len(x01), -1).float()[:, torch.from_numpy(PIXELS)]


def jax_features(x01):
    return jnp.asarray(x01, jnp.float32).reshape(x01.shape[0], -1)[:, PIXELS]


@functools.lru_cache(maxsize=None)
def tiny_vaes(bottleneck):
    """The tiny JAX VAE's variables (fp32) and the port's VAE loaded from
    them through compat.from_jax.  For VQ the codebook holds 16 of the
    encoder's tokens of the dev images, so that their nearest codes sit
    far apart against the two packages' distance rounding."""
    arch = {**ARCH, **(VQ if bottleneck == "vq" else {})}
    jvae = jbuild_vae(jcfg.VAEArch(**arch), dtype=jnp.float32)
    x0 = np.zeros((1, 16, 16, 3), np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(lambda: jvae.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, x0))())
    if bottleneck == "vq":
        z = np.asarray(jvae.apply(variables, jnormalize(dev_images()),
                                  method=lambda m, x: m.encoder(x)))
        emb = z.reshape(-1, 3)[np.random.default_rng(9).choice(z.size // 3, 16, replace=False)]
        variables["codebook"]["codebook"]["embeddings"] = emb
    vae = build_vae(tcfg.VAEArch(**arch), torch.float32, "cpu")
    vae.load_state_dict(vae_state_dict(variables))
    jc = jcfg.VAEConfig(jcfg.VAEArch(**arch), jcfg.VAETrainConfig(precision="fp32"))
    return jvae, jc, variables, vae


def dev_images():
    return tool.make_dataset(5, size=16, seed=777)[0]


def jax_recon_fid(jvae, jc, variables, dev_imgs):
    """The JAX tool's real ingestion and reconstruction-FID loop
    (tools/e2e_synthetic_run.py:288-317) at batch DEV_BATCH -> (FID object
    before the reset, distance, reconstructions, the KL draws)."""
    eval_step = jmake_eval_step(jvae, None, jc, None)
    fid = jfid.FID(jax_features, 8)
    for i in range(0, len(dev_imgs), 90):
        chunk = dev_imgs[i:i + 90].astype(np.float32) / 255.0
        n_valid = len(chunk)
        if n_valid < 90:
            chunk = np.concatenate([chunk, np.zeros((90 - n_valid, *chunk.shape[1:]), np.float32)])
        fid.update_real_once(chunk, n_valid=n_valid)
    # the draw the KL eval step makes: the VAE's first "sample" rng
    draw = jax.jit(lambda key: jvae.apply(
        variables, method=lambda m: jax.random.normal(m.make_rng("sample"), (DEV_BATCH, 8, 8, 3),
                                                      jnp.float32),
        rngs={"sample": key}))
    recons, draws = [], []
    for i in range(0, len(dev_imgs), DEV_BATCH):
        chunk = dev_imgs[i:i + DEV_BATCH]
        n_valid = len(chunk)
        if n_valid < DEV_BATCH:
            chunk = np.concatenate(
                [chunk, np.zeros((DEV_BATCH - n_valid, *chunk.shape[1:]), np.uint8)])
        key = jax.random.fold_in(jax.random.key(9), i)
        x_hat, _, _, _ = eval_step(variables["params"], variables.get("codebook"),
                                   jnp.asarray(chunk), key, n_valid)
        fid.update_fake(((np.asarray(x_hat) + 1.0) / 2.0).clip(0, 1), n_valid=n_valid)
        recons.append(np.asarray(x_hat))
        draws.append(np.array(draw(key)))
    return fid, float(fid.compute()), np.concatenate(recons), draws


@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_reconstruction_fid_loop_matches_jax(bottleneck):
    """15 dev images of 16x16 (seed 777) at batch 4 and real chunks of 90,
    both tails padded, the same weights and feature function: the
    reconstructions within 2e-4 (KL given JAX's reparametrization draws),
    the real and fake statistics (n, mean, covariance) within 1e-6
    relative (max|diff| / max|JAX|) and the distance within 1e-6
    relative; JAX's draws are the ones its eval step took (its own
    reconstruction from them within 1e-5, jitted against eager; another
    draw moves it by ~1e-1)."""
    jvae, jc, variables, vae = tiny_vaes(bottleneck)
    dev_imgs = dev_images()
    jfid_obj, ref, ref_recons, draws = jax_recon_fid(jvae, jc, variables, dev_imgs)
    if bottleneck == "kl":
        x = jnormalize(jnp.asarray(dev_imgs[:DEV_BATCH]))
        again = np.clip(np.asarray(jvae.apply(variables, x, sample=True,
                                              noise=jnp.asarray(draws[0]))[0]), -1, 1)
        np.testing.assert_allclose(again, ref_recons[:DEV_BATCH], atol=1e-5)

    fid = tfid.FID(port_features, 8)
    tool.ingest_dev(fid, dev_imgs, "cpu")
    recons = []
    eval_step = make_eval_step()

    def recording(*args):
        out = eval_step(*args)
        recons.append(out[0].numpy())
        return out

    def noise(i, shape):
        assert shape == (DEV_BATCH, 8, 8, 3)
        return torch.from_numpy(draws[i // DEV_BATCH])

    fake_stats = []
    compute = fid.compute
    fid.compute = lambda: (fake_stats.append(fid.fake.finalize()), compute())[1]
    got = tool.reconstruction_fid(vae, recording, fid, dev_imgs, DEV_BATCH, "cpu",
                                  noise if bottleneck == "kl" else None)
    np.testing.assert_allclose(np.concatenate(recons), ref_recons, atol=2e-4)
    assert fid.real.n == jfid_obj.real.n == 15 and fid.fake.n == 0 and jfid_obj.fake.n == 15

    def rel(a, b):
        return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())

    for mine, theirs in ((fid.real.finalize(), jfid_obj.real.finalize()),
                         (fake_stats[0], jfid_obj.fake.finalize())):
        assert rel(mine[0], theirs[0]) <= 1e-6
        assert rel(mine[1], theirs[1]) <= 5e-6
    assert got == pytest.approx(ref, rel=1e-6)


def test_vq_code_counts_match_jax():
    """The tool's code counts over the dev set (15 images at batch 4: 3
    whole batches, the tail left out as in JAX), utilization and perplexity
    equal the JAX tool's code_counts and arithmetic exactly
    (tools/e2e_synthetic_run.py:332-356)."""
    jvae, _, variables, vae = tiny_vaes("vq")
    probe = dev_images()

    @jax.jit
    def code_counts(params, codebook, x_u8):
        idx = jvae.apply({"params": params, "codebook": codebook}, jnormalize(x_u8),
                         method="encode_indices")
        return jnp.sum(jax.nn.one_hot(idx.reshape(-1), 16, dtype=jnp.float32), axis=0)

    pb = min(DEV_BATCH, len(probe))
    ref = np.zeros((16,), np.float64)
    for i in range(0, len(probe) - pb + 1, pb):
        ref += np.asarray(code_counts(variables["params"], variables["codebook"],
                                      jnp.asarray(probe[i:i + pb])))
    probs = ref / ref.sum()
    ent = -np.sum(probs[probs > 0] * np.log(probs[probs > 0]))

    counts, n_images = tool.code_counts(vae, probe, DEV_BATCH, "cpu")
    np.testing.assert_array_equal(counts, ref)
    assert tool.vq_numbers(counts, n_images) == {
        "vq_codebook_size": 16, "vq_codebook_utilization": round(float(np.mean(ref > 0)), 4),
        "vq_dev_perplexity": round(float(np.exp(ent)), 2), "vq_dev_images": 12}
    assert np.count_nonzero(counts) > 1
    with pytest.raises(ValueError, match="empty VQ probe"):
        tool.vq_numbers(np.zeros(16), 0)


def test_latest_checkpoint_is_the_highest_epoch(tmp_path):
    """--resume's choice: the highest epoch number, not the last name."""
    assert tool.latest_ckpt(str(tmp_path), "e2e_vae", "vae") is None
    (tmp_path / "e2e_vae").mkdir()
    for n in ("00", "09", "10", "99", "100"):
        (tmp_path / "e2e_vae" / f"vae-epoch-{n}.ckpt").write_bytes(b"")
    assert tool.latest_ckpt(str(tmp_path), "e2e_vae", "vae").endswith("vae-epoch-100.ckpt")


def jax_row_keys(bottleneck):
    rows = check_e2e_history.load_history(os.path.join(REPO, "docs", "e2e_history.jsonl"))
    last = [r for r in rows if r.get("bottleneck") == bottleneck][-1]
    return set(last) - {"round", "note"} - FID_KEYS


@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_tool_runs_at_tiny_widths_with_the_jax_keys(tmp_path, bottleneck):
    """A whole run on the CPU (128x128 images to 8x8 latents, tiny widths,
    3 VAE and 3 UNet steps, no FID): the report's keys are the JAX rows'
    of the same bottleneck in docs/e2e_history.jsonl (less round, note and
    the FID keys --fid-images 0 leaves out), its numbers finite, the real
    data classified at >= 0.95; --history appends a row that the history
    checker loads, with the round tag and a note naming the device; the
    report file and the grid figure are written.  KL then resumes from the
    highest epoch of each stage and records it."""
    out, history = tmp_path / "out", tmp_path / "h.jsonl"
    args = TOOL_ARGS + ["--out", str(out), "--bottleneck", bottleneck,
                        "--history", str(history), "--round-tag", "t1"]
    report = tool.run(args, vae_arch=TOOL_VAE, unet_arch=TOOL_UNET)
    assert set(report) == jax_row_keys(bottleneck)
    assert report["bottleneck"] == bottleneck and report["profile"] == "custom"
    assert report["real_classifier_acc"] >= 0.95
    assert report["vae_steps"] == report["unet_steps"] == 3
    numbers = [v for v in report.values() if isinstance(v, (int, float))]
    assert np.isfinite(numbers).all() and set(report["cond_accuracy_per_class"]) == {0, 1, 2}
    if bottleneck == "vq":
        assert report["vq_dev_images"] == 1000 and report["vq_codebook_size"] == 1024
    rows = check_e2e_history.load_history(str(history))
    assert len(rows) == 1 and rows[0]["round"] == "t1" and "on the CPU" in rows[0]["note"]
    assert {k: v for k, v in rows[0].items() if k not in ("round", "note")} == {
        **report, "cond_accuracy_per_class": {str(k): v for k, v in
                                              report["cond_accuracy_per_class"].items()}}
    assert (out / "e2e_report.json").exists() and (out / "e2e_grid.png").stat().st_size > 0
    if bottleneck == "vq":
        return
    for stage in ("vae", "unet"):
        src = out / f"e2e_{stage}" / f"{stage}-epoch-00.ckpt"
        for n in ("99", "100"):
            shutil.copy(src, out / f"e2e_{stage}" / f"{stage}-epoch-{n}.ckpt")
    again = tool.run(args + ["--resume"], vae_arch=TOOL_VAE, unet_arch=TOOL_UNET)
    assert again["resumed_from"] == {"vae": "vae-epoch-100.ckpt", "unet": "unet-epoch-100.ckpt"}
    assert set(again) == jax_row_keys(bottleneck) | {"resumed_from"}
    assert len(check_e2e_history.load_history(str(history))) == 2


def test_tool_defaults_to_the_card():
    """Without --device the tool asks for the card; on a machine without
    one it raises before it makes any data."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.run(["--n-per-class", "1"])
