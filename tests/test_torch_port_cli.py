"""The port's command-line entry points against the JAX package's scripts
on the same inputs: make_bundle (bundles bit-equal, leaf by leaf),
prepare_dataset (the vae mode byte-identical, the diffusion mode's
latents at the fp32 bar and through both CLIs at a bf16 bar, labels
bit-equal), sample_grid (the images of `DiffusionPipeline.sample`),
visualize_latents and the plotting helpers; and the two stages joined by
checkpoints the port's own trainers wrote.

The JAX scripts run in this process (`runpy`, `sys.argv` patched) on the
CPU backend tests/conftest.py selects; the port's run with `--device cpu`.
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core import checkpoint as jckpt
from image_diffusion_tpu.core import plotting as jplotting
from image_diffusion_tpu.core.config import UNetArch as JUNetArch
from image_diffusion_tpu.core.config import VAEArch as JVAEArch
from image_diffusion_tpu.models import io as jio
from image_diffusion_tpu.pipelines.diffusion import DiffusionPipeline as JPipeline
from image_diffusion_torch.compat.from_jax import unet_flax_params, vae_flax_variables
from image_diffusion_torch.core import checkpoint as ckpt
from image_diffusion_torch.core import plotting
from image_diffusion_torch.core.config import UNetArch, VAEArch
from image_diffusion_torch.models import build_unet, build_vae
from image_diffusion_torch.models.io import load_vae
from image_diffusion_torch.pipelines import DiffusionPipeline, to_uint8
from image_diffusion_torch.scripts import (
    make_bundle,
    prepare_dataset,
    sample_grid,
    train_diffusion,
    train_vae,
    visualize_latents,
)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
ATOL = 2e-4
# both CLIs encode in bf16 and store fp16: max |port - JAX| / max |JAX|
BF16_REL = 2e-2
# the trainers' tiny configs (tests/test_torch_port_*training.py): 16x16
# images, 8x8x3 latents
VAE_ARCH = dict(in_channels=3, channels=(8, 16), z_dim=3, enc_num_res_blocks=1,
                dec_num_res_blocks=1, attn_resolutions=(), num_heads=1, init_resolution=16,
                num_groups=4)
VQ = dict(bottleneck="vq", codebook_size=32, codebook_beta=0.25, codebook_gamma=0.99)
UNET_ARCH = dict(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16,
                 num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
T_STEPS = 8


def run_jax(script, *args):
    """One of the JAX package's scripts/*.py, in this process."""
    argv = sys.argv
    sys.argv = [script, *map(str, args)]
    try:
        runpy.run_path(os.path.join(SCRIPTS, script), run_name="__main__")
    finally:
        sys.argv = argv


def write_yaml(path, values):
    path.write_text("".join(f"{k}: {list(v) if isinstance(v, tuple) else v}\n"
                            for k, v in values.items()))
    return str(path)


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def assert_files_equal(a, b):
    """Two checkpoint files: the same meta, and every leaf bit-equal."""
    (ta, ma), (tb, mb) = ckpt.load_checkpoint(a), ckpt.load_checkpoint(b)
    assert ma == mb
    assert_trees_equal(ta, tb)


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """Tiny fp32 checkpoints written by the JAX package: the KL VAE as a
    per-model file, the VQ VAE as a trainer epoch checkpoint (the codebook
    a sibling tree), the UNet as a per-model file and as trainer
    checkpoints with and without `unet_ema`; and a diffusion config.  The
    weights are seeded draws of the port's initializers (no JAX compile)."""
    d = tmp_path_factory.mktemp("jax_ckpts")
    g = torch.Generator().manual_seed(1)
    paths = {}
    for name, extra in (("kl", {}), ("vq", VQ)):
        arch = JVAEArch(**VAE_ARCH, **extra)
        variables = vae_flax_variables(
            build_vae(VAEArch(**VAE_ARCH, **extra), torch.float32, "cpu", g).state_dict())
        paths[name] = str(d / f"{name}.ckpt")
        if name == "kl":
            jio.save_vae(paths[name], arch, variables)
        else:
            jckpt.save_checkpoint(paths[name], architecture=arch.to_dict(), epoch=0,
                                  vae=variables["params"], codebook=variables["codebook"])
    arch = JUNetArch(**UNET_ARCH)
    params = [unet_flax_params(build_unet(UNetArch(**UNET_ARCH), torch.float32, "cpu", g)
                               .state_dict()) for _ in range(2)]
    paths["unet"] = str(d / "unet.ckpt")
    jio.save_unet(paths["unet"], arch, {"params": params[0]})
    paths["unet_epoch"] = str(d / "unet-epoch-00.ckpt")
    jckpt.save_checkpoint(paths["unet_epoch"], architecture=arch.to_dict(), epoch=0,
                          unet=params[0])
    paths["unet_ema_epoch"] = str(d / "unet-ema-epoch-00.ckpt")
    jckpt.save_checkpoint(paths["unet_ema_epoch"], architecture=arch.to_dict(), epoch=0,
                          unet=params[0], unet_ema=params[1])
    paths["config"] = write_yaml(d / "diff.yaml", {**UNET_ARCH, "num_steps": T_STEPS})
    return paths


@pytest.fixture(scope="module")
def images_npy(tmp_path_factory):
    """7 uint8 16x16 images: one batch of 4 and a tail of 3."""
    path = tmp_path_factory.mktemp("images") / "images.npy"
    np.save(path, np.random.default_rng(4).integers(0, 256, (7, 16, 16, 3), dtype=np.uint8))
    return str(path)


@pytest.fixture(scope="module")
def jax_bundle(jax_ckpts, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundle") / "bundle.ckpt")
    run_jax("make_bundle.py", "--vae", jax_ckpts["kl"], "--unet", jax_ckpts["unet"],
            "--config", jax_ckpts["config"], "--out", path)
    return path


# ------------------------------------------------------------ make_bundle


@pytest.mark.parametrize("vae,unet,ema", [
    ("kl", "unet", False),
    ("vq", "unet_epoch", False),
    ("vq", "unet_ema_epoch", False),
    ("kl", "unet_ema_epoch", True),
], ids=["per-model-files", "vq-trainer-checkpoints", "ema-checkpoint-without-ema", "ema"])
def test_make_bundle_matches_jax(jax_ckpts, tmp_path, vae, unet, ema):
    """At the CLI's default (bf16) dtype the bundle holds the checkpoints'
    fp32 weights, leaf by leaf bit-equal to the JAX script's bundle."""
    args = ["--vae", jax_ckpts[vae], "--unet", jax_ckpts[unet], "--config", jax_ckpts["config"],
            "--classes", "sun,snow,rain"] + (["--ema"] if ema else [])
    run_jax("make_bundle.py", *args, "--out", tmp_path / "jax.ckpt")
    make_bundle.main(args + ["--out", str(tmp_path / "port.ckpt"), "--device", "cpu"])
    assert_files_equal(str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt"))

    trees, meta = ckpt.load_checkpoint(str(tmp_path / "port.ckpt"))
    assert meta["architecture"]["classes"] == "sun,snow,rain"
    assert meta["architecture"]["scheduler"]["num_steps"] == T_STEPS
    assert ("codebook" in trees["vae"]) == (vae == "vq")
    src, _ = ckpt.load_checkpoint(jax_ckpts[unet])
    expected = src["unet_ema"] if ema else src["unet"]
    assert_trees_equal(trees["unet"]["params"], expected.get("params", expected))


def test_make_bundle_ema_needs_the_ema_tree(jax_ckpts, tmp_path):
    args = ["--vae", jax_ckpts["kl"], "--unet", jax_ckpts["unet_epoch"], "--config",
            jax_ckpts["config"], "--ema"]
    with pytest.raises(SystemExit) as jax_exit:
        run_jax("make_bundle.py", *args, "--out", tmp_path / "jax.ckpt")
    with pytest.raises(SystemExit) as port_exit:
        make_bundle.main(args + ["--out", str(tmp_path / "port.ckpt"), "--device", "cpu"])
    assert str(port_exit.value) == str(jax_exit.value) and "unet_ema" in str(port_exit.value)
    assert not os.listdir(tmp_path)


def test_port_trained_checkpoints_join_through_the_clis(tmp_path):
    """images -> the port's train_vae -> its prepare_dataset (random labels)
    -> its train_diffusion (ema_decay set) -> make_bundle --ema in both
    packages, bit-equal; the JAX pipeline reads the port's bundle and holds
    the port-trained EMA weights."""
    np.save(tmp_path / "images.npy",
            np.random.default_rng(5).integers(0, 256, (8, 16, 16, 3), dtype=np.uint8))
    train = dict(learning_rate=1e-3, batch_size=4, epochs=1, clip_grad=1.0, precision="fp16",
                 seed=0, log_interval=1, checkpoints_dir=tmp_path / "ck",
                 logs_dir=tmp_path / "logs")
    vae_cfg = write_yaml(tmp_path / "vae.yaml", {
        **VAE_ARCH, **train, "disc_start": 1, "disc_channels": (8, 16),
        "train_set": tmp_path / "images.npy", "dev_set": tmp_path / "no-dev.npy"})
    with pytest.warns(UserWarning, match="ZERO"):
        train_vae.main(["--config", vae_cfg, "--experiment-name", "vae", "--no-mlflow",
                        "--allow-no-lpips", "--device", "cpu"])
    vae_ckpt = str(tmp_path / "ck" / "vae" / "vae-epoch-00.ckpt")

    prepare_dataset.main(["diffusion", "--diffusion-images", str(tmp_path / "images.npy"),
                          "--vae-checkpoint", vae_ckpt, "--out", str(tmp_path / "lat"),
                          "--labels-mode", "random", "--batch-size", "4", "--device", "cpu"])
    latents = np.load(tmp_path / "lat" / "diffusion_dataset.npy")
    assert latents.shape == (8, 8, 8, 6) and latents.dtype == np.float16
    assert np.isfinite(latents).all()

    diff_cfg = write_yaml(tmp_path / "diff.yaml", {
        **UNET_ARCH, **train, "num_steps": T_STEPS, "warmup_steps": 2, "ema_decay": 0.9,
        "train_set": tmp_path / "lat" / "diffusion_dataset.npy",
        "train_labels": tmp_path / "lat" / "diffusion_labels.npy"})
    train_diffusion.main(["--config", diff_cfg, "--experiment-name", "unet", "--no-mlflow",
                          "--device", "cpu"])
    unet_ckpt = str(tmp_path / "ck" / "unet" / "unet-epoch-00.ckpt")

    args = ["--vae", vae_ckpt, "--unet", unet_ckpt, "--config", diff_cfg, "--ema"]
    make_bundle.main(args + ["--out", str(tmp_path / "port.ckpt"), "--device", "cpu"])
    run_jax("make_bundle.py", *args, "--out", tmp_path / "jax.ckpt")
    assert_files_equal(str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt"))

    jpipe = JPipeline.from_checkpoint(str(tmp_path / "port.ckpt"), dtype=jnp.float32)
    trees, _ = ckpt.load_checkpoint(unet_ckpt)
    assert_trees_equal(jax.tree.map(np.asarray, jpipe.unet_variables["params"]), trees["unet_ema"])
    vae_trees, _ = ckpt.load_checkpoint(vae_ckpt)
    assert_trees_equal(jax.tree.map(np.asarray, jpipe.vae_variables["params"]), vae_trees["vae"])


# --------------------------------------------------------- prepare_dataset


def test_prepare_dataset_vae_mode_matches_jax(tmp_path):
    """Images of odd sizes and modes (RGB, grayscale, RGBA; png and jpg,
    another file ignored) -> a byte-identical uint8 blob."""
    from PIL import Image

    src = tmp_path / "images"
    src.mkdir()
    rng = np.random.default_rng(6)
    for name, shape, mode in (("b.png", (20, 24, 3), "RGB"), ("a.PNG", (13, 9), "L"),
                              ("c.jpg", (17, 30, 3), "RGB"), ("d.png", (11, 11, 4), "RGBA")):
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(src / name)
    (src / "notes.txt").write_text("not an image")
    run_jax("prepare_dataset.py", "vae", "--vae-images", src, "--image-size", 12,
            "--out", tmp_path / "jax")
    prepare_dataset.main(["vae", "--vae-images", str(src), "--image-size", "12",
                          "--out", str(tmp_path / "port")])
    got = (tmp_path / "port" / "vae_dataset.npy").read_bytes()
    assert got == (tmp_path / "jax" / "vae_dataset.npy").read_bytes()
    assert np.load(tmp_path / "port" / "vae_dataset.npy").shape == (4, 12, 12, 3)


@pytest.mark.parametrize("vae", ["kl", "vq"])
def test_encode_matches_jax_at_fp32(jax_ckpts, images_npy, vae):
    """The stored-latent map at fp32 (KL's mean || log_var, VQ's codes),
    and the batched extraction: batches of 4 with a tail of 3 give the rows
    of one batch of 7, stored as fp16."""
    x = np.load(images_npy)
    model, _ = load_vae(jax_ckpts[vae], torch.float32, "cpu")
    with torch.inference_mode():
        got = prepare_dataset.encode(model, torch.from_numpy(x)).numpy()
    jmodel, variables, _ = jio.load_vae(jax_ckpts[vae], dtype=jnp.float32)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x.astype(jnp.float32) / 127.5 - 1.0, sample=False,
                                            method="encode")[0])(variables, x)
    assert got.shape == (7, 8, 8, 3 if vae == "vq" else 6)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
    stored = prepare_dataset.extract_latents(model, np.load(images_npy, mmap_mode="r"), 4, "cpu")
    assert stored.dtype == np.float16
    np.testing.assert_allclose(stored.astype(np.float32), got, atol=ATOL, rtol=1e-3)


def test_prepare_dataset_diffusion_matches_jax(jax_ckpts, images_npy, tmp_path):
    """Both CLIs at their bf16 compute: latents within BF16_REL, the random
    labels bit-equal."""
    args = ["diffusion", "--diffusion-images", images_npy, "--vae-checkpoint", jax_ckpts["kl"],
            "--labels-mode", "random", "--batch-size", "4"]
    run_jax("prepare_dataset.py", *args, "--out", tmp_path / "jax")
    prepare_dataset.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    got, ref = (np.load(tmp_path / side / "diffusion_dataset.npy") for side in ("port", "jax"))
    assert got.shape == ref.shape == (7, 8, 8, 6) and got.dtype == ref.dtype == np.float16
    err = np.abs(got.astype(np.float32) - ref.astype(np.float32)).max()
    assert err <= BF16_REL * np.abs(ref.astype(np.float32)).max(), err
    labels, jax_labels = (np.load(tmp_path / side / "diffusion_labels.npy")
                          for side in ("port", "jax"))
    assert labels.dtype == jax_labels.dtype == np.uint8
    np.testing.assert_array_equal(labels, jax_labels)


@pytest.fixture(scope="module")
def tiny_clip(tmp_path_factory):
    """A from_pretrained-loadable CLIP directory: a random tiny CLIPModel,
    a hand-made BPE vocabulary and an image processor, built offline (a
    copy of tests/test_clip_labels.py's `tiny_clip` fixture, with the
    text config's eos_token_id set to the vocabulary's <|endoftext|>, so
    each prompt pools at its own EOS: with the default id, absent from
    this vocabulary, every prompt pools at its first token and all three
    embeddings are one)."""
    import json

    from transformers import (
        CLIPConfig,
        CLIPImageProcessor,
        CLIPModel,
        CLIPProcessor,
        CLIPTokenizer,
    )

    d = tmp_path_factory.mktemp("tiny_clip")
    # minimal CLIP-BPE vocab: specials, whole words for the prompts, and
    # single chars (plain + word-final </w>) as fallback
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for w in "a hot cold mild place".split():
        vocab.setdefault(w + "</w>", len(vocab))
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault(ch + "</w>", len(vocab))
    with open(d / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(d / "merges.txt", "w") as f:
        f.write("#version: 0.2\n")

    tok = CLIPTokenizer(vocab_file=str(d / "vocab.json"), merges_file=str(d / "merges.txt"))
    cfg = CLIPConfig(
        text_config=dict(vocab_size=tok.vocab_size, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=16, projection_dim=16,
                         eos_token_id=vocab["<|endoftext|>"]),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8,
                           projection_dim=16),
        projection_dim=16,
    )
    torch.manual_seed(0)
    model = CLIPModel(cfg)
    improc = CLIPImageProcessor(size={"shortest_edge": 32}, crop_size={"height": 32, "width": 32})
    CLIPProcessor(image_processor=improc, tokenizer=tok).save_pretrained(str(d))
    model.save_pretrained(str(d))
    return str(d)


CLIP_CLASSES = "a hot place,a cold place,a mild place"


@pytest.fixture(scope="module")
def jax_clip_run(jax_ckpts, images_npy, tiny_clip, tmp_path_factory):
    """JAX's script with CLIP labels (its default `jax` backend) -> its
    output directory."""
    out = tmp_path_factory.mktemp("clip_jax")
    run_jax("prepare_dataset.py", "diffusion", "--diffusion-images", images_npy,
            "--vae-checkpoint", jax_ckpts["kl"], "--clip", tiny_clip, "--batch-size", 4,
            "--classes", CLIP_CLASSES, "--out", out)
    return out


@pytest.mark.parametrize("backend", ["port", "torch"])
def test_prepare_dataset_clip_labels_match_jax(jax_ckpts, images_npy, tiny_clip, jax_clip_run,
                                               tmp_path, backend):
    """`--labels-mode clip` (the default) on the same images, VAE and tiny
    offline CLIP: the labels of JAX's script and of transformers' eager
    model, the latents within BF16_REL as with random labels."""
    prepare_dataset.main(["diffusion", "--diffusion-images", images_npy, "--vae-checkpoint",
                          jax_ckpts["kl"], "--clip", tiny_clip, "--clip-backend", backend,
                          "--batch-size", "4", "--classes", CLIP_CLASSES, "--out",
                          str(tmp_path), "--device", "cpu"])
    labels = np.load(tmp_path / "diffusion_labels.npy")
    jax_labels = np.load(jax_clip_run / "diffusion_labels.npy")
    assert labels.shape == (7,) and labels.dtype == jax_labels.dtype == np.uint8
    np.testing.assert_array_equal(labels, jax_labels)

    from transformers import CLIPModel, CLIPProcessor

    model = CLIPModel.from_pretrained(tiny_clip).eval()
    proc = CLIPProcessor.from_pretrained(tiny_clip)
    with torch.no_grad():
        out = model(pixel_values=proc(images=list(np.load(images_npy)),
                                      return_tensors="pt")["pixel_values"],
                    **proc(text=CLIP_CLASSES.split(","), return_tensors="pt", padding=True))
    np.testing.assert_array_equal(labels, out.logits_per_image.argmax(-1).numpy())

    got, ref = (np.load(d / "diffusion_dataset.npy").astype(np.float32)
                for d in (tmp_path, jax_clip_run))
    assert got.shape == ref.shape == (7, 8, 8, 6)
    assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()


def test_zero_shot_labels_take_the_argmax_of_each_batch():
    """The classifying loop on processed pixel batches and token ids: the
    argmax of `logits_per_image` row by row, whatever the batch split."""
    from image_diffusion_torch.models.clip import CLIPZeroShot
    from test_torch_port_clip import TINY, random_batch, random_clip_state

    clip = CLIPZeroShot.from_state_dict(random_clip_state(6, **TINY), vision_heads=2,
                                        text_heads=2, patch_size=8, eos_token_id=63,
                                        device="cpu")
    pixel, ids, am = random_batch(6, eos_id=63, b=7)
    want = clip.logits_per_image(pixel, ids, am).argmax(-1).numpy()
    got = prepare_dataset.zero_shot_labels(clip, [pixel[:4], pixel[4:]], ids, am)
    assert got.dtype == np.uint8 and len(set(want.tolist())) > 1
    np.testing.assert_array_equal(got, want)


def test_prepare_dataset_clip_labels_need_transformers(jax_ckpts, images_npy, tmp_path,
                                                       monkeypatch):
    """Without transformers the CLIP mode exits naming it, before any
    latent is extracted; it never falls back to random labels."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers"):
        prepare_dataset.main(["diffusion", "--diffusion-images", images_npy, "--vae-checkpoint",
                              jax_ckpts["kl"], "--out", str(tmp_path), "--device", "cpu"])
    assert not os.listdir(tmp_path)


# ------------------------------------------------------------- sample_grid


def test_sample_grid_cli_on_a_jax_bundle(jax_bundle, tmp_path):
    """The CLI's images are `DiffusionPipeline.sample`'s with the same
    arguments (the progress bar changes nothing); it writes the figure; its
    default device is the card, which this host lacks."""
    out = tmp_path / "grid" / "out.png"
    argv = [jax_bundle, "--device", "cpu", "--sampler", "ddim", "--steps", "4", "--cfg", "1", "3",
            "--seed", "0", "--progress", "--out", str(out)]
    sample_grid.main(argv)
    assert out.stat().st_size > 0
    _, scales, images, seconds = sample_grid.sample(sample_grid.parse_args(argv))
    ref = DiffusionPipeline.from_checkpoint(jax_bundle, device="cpu").sample(
        [1, 2], seed=0, sampler="ddim", num_inference_steps=4)
    assert scales == [1, 2] and images.shape == (6, 16, 16, 3) and seconds > 0
    torch.testing.assert_close(images, ref, atol=0, rtol=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_grid.main([jax_bundle, "--out", str(out)])


# ------------------------------------------------- visualize_latents, plots


@pytest.mark.parametrize("vae", ["kl", "vq"])
def test_visualize_latents_matches_jax_at_fp32(jax_ckpts, images_npy, tmp_path, vae):
    """Encode then decode the posterior mean (KL) or the codes (VQ), as the
    JAX script's jitted function does, at fp32; the CLI draws the figure."""
    x = np.load(images_npy)[:3]
    model, _ = load_vae(jax_ckpts[vae], torch.float32, "cpu")
    z, x_hat = visualize_latents.encode_decode(model, torch.from_numpy(x))

    jmodel, variables, arch = jio.load_vae(jax_ckpts[vae], dtype=jnp.float32)

    @jax.jit
    def encode_decode(batch_u8):  # scripts/visualize_latents.py's, at fp32
        x = batch_u8.astype(jnp.float32) / 127.5 - 1.0
        z, _, _ = jmodel.apply(variables, x, sample=False, method="encode")
        if arch.bottleneck == "kl":
            z, _ = jnp.split(z.astype(jnp.float32), 2, axis=-1)
        x_hat = jmodel.apply(variables, z, quantize=arch.bottleneck == "vq", method="decode")
        return z.astype(jnp.float32), x_hat.astype(jnp.float32)

    jz, jx_hat = encode_decode(x)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(jx_hat), atol=ATOL)
    rgb = visualize_latents.latent_rgb(np.asarray(jz)[..., :2])
    assert rgb.shape == (3, 8, 8, 3) and rgb.dtype == np.uint8 and not rgb[..., 2].any()

    out = tmp_path / "latents.png"
    visualize_latents.main([jax_ckpts[vae], "--images", images_npy, "--n", "3", "--out", str(out),
                            "--device", "cpu"])
    assert out.stat().st_size > 0


def test_plotting_matches_jax():
    import matplotlib.pyplot as plt

    x = np.random.default_rng(7).uniform(-1.3, 1.3, (6, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(plotting.to_uint8(x), jplotting.to_uint8(x))
    np.testing.assert_array_equal(plotting.to_uint8(x), to_uint8(torch.from_numpy(x)).numpy())
    for nrow, padding in ((1, 2), (3, 2), (4, 0)):
        np.testing.assert_array_equal(plotting.make_grid(x, nrow, padding),
                                      jplotting.make_grid(x, nrow, padding))
    for fig in (plotting.plot_cfg_grid(x, ["a", "b", "c"], [1, 2]),
                plotting.plot_reconstructions(x[:2], x[2:4])):
        assert len(fig.axes) >= 1
        plt.close(fig)
