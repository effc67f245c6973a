"""The port's eval_fid CLI against the JAX package's scripts/eval_fid.py on
the CPU: the real images' statistics of both on the same random
InceptionV3 weights (tests/torch_oracles.py), and the port's printed FID
against its own FID accumulator over `DiffusionPipeline.sample`.  The two
CLIs' FIDs cannot agree: the frameworks draw different sampling noise."""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from image_diffusion_tpu.models import fid as jfid
from image_diffusion_torch.core import config as tcfg
from image_diffusion_torch.models import build_unet, build_vae
from image_diffusion_torch.models import fid as tfid
from image_diffusion_torch.models.inception import load_inception
from image_diffusion_torch.pipelines import DiffusionPipeline
from image_diffusion_torch.scripts import eval_fid
from torch_oracles import random_inception

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
# a tiny bundle: 16x16 images from 8x8x3 latents
VAE_ARCH = dict(in_channels=3, channels=(8, 16), z_dim=3, enc_num_res_blocks=1,
                dec_num_res_blocks=1, attn_resolutions=(), num_heads=1, init_resolution=16,
                num_groups=4)
UNET_ARCH = dict(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16,
                 num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    """random_inception(0)'s state dict as a torch file, and the port's model of it."""
    path = str(tmp_path_factory.mktemp("inception") / "inception.pth")
    torch.save(random_inception(0).state_dict(), path)
    return dict(path=path, model=load_inception(path, "cpu"))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tiny fp32 bundle of random weights in the JAX layout, and 5 real
    16x16 uint8 images."""
    d = tmp_path_factory.mktemp("eval_fid")
    g = torch.Generator().manual_seed(11)
    vae = build_vae(tcfg.VAEArch(**VAE_ARCH), torch.float32, "cpu", g).state_dict()
    unet = build_unet(tcfg.UNetArch(**UNET_ARCH), torch.float32, "cpu", g).state_dict()
    DiffusionPipeline(tcfg.VAEArch(**VAE_ARCH), vae, tcfg.UNetArch(**UNET_ARCH), unet,
                      tcfg.ScheduleConfig(num_steps=8), "a,b,c", dtype=torch.float32,
                      device="cpu").to_checkpoint(str(d / "bundle.ckpt"))
    np.save(d / "real.npy", np.random.default_rng(12).integers(0, 256, (5, 16, 16, 3),
                                                               dtype=np.uint8))
    return dict(model=str(d / "bundle.ckpt"), real=str(d / "real.npy"))


def _record(monkeypatch, module):
    """FID objects `module.FID` makes, kept as they are made."""
    made = []

    class Recording(module.FID):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(module, "FID", Recording)
    return made


def test_eval_fid_real_statistics_match_jax(bundle, inception, monkeypatch):
    """`--max-real 3` of 5 images, one chunk of 3: the real mean and
    covariance of both CLIs at 1e-5.  Their FIDs cannot agree: the two
    frameworks draw different sampling noise."""
    args = [bundle["model"], "--real", bundle["real"], "--fid-weights", inception["path"],
            "--num-images", "3", "--batch", "3", "--sampler", "ddim", "--steps", "2",
            "--max-real", "3"]
    jmade = _record(monkeypatch, jfid)
    argv = sys.argv
    sys.argv = ["eval_fid.py", *args, "--use-cpu"]
    try:
        runpy.run_path(os.path.join(SCRIPTS, "eval_fid.py"), run_name="__main__")
    finally:
        sys.argv = argv
    made = _record(monkeypatch, tfid)
    eval_fid.evaluate(eval_fid.parse_args([*args, "--device", "cpu"]))
    (j,), (t,) = jmade, made
    assert t.real.n == j.real.n == 3
    for a, b in zip(t.real.finalize(), j.real.finalize()):
        assert rel_max(a, b) < 1e-5


def test_eval_fid_cli_scores_its_own_samples(bundle, inception, monkeypatch, capsys):
    """4 images at `--batch 3` (3 classes: one image each a call, 2 calls,
    the second keeping 1): the printed last line is the FID of the port's
    own FID over `pipe.sample` with seeds 0 and 1 against the 5 real images;
    fewer than 2 real images exit."""
    args = [bundle["model"], "--real", bundle["real"], "--fid-weights", inception["path"],
            "--num-images", "4", "--batch", "3", "--sampler", "ddim", "--steps", "2",
            "--device", "cpu"]
    made = _record(monkeypatch, tfid)
    eval_fid.main(args)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    (fid,) = made
    assert fid.real.n == 5 and fid.fake.n == 4

    ref = tfid.FID(inception["model"], 2048)
    real = np.load(bundle["real"]).astype(np.float32) / 255.0
    ref.update_real_once(torch.from_numpy(real))
    pipe = DiffusionPipeline.from_checkpoint(bundle["model"], device="cpu")
    for seed, take in ((0, 3), (1, 1)):
        imgs = pipe.sample(3.0, num_images=1, seed=seed, sampler="ddim", num_inference_steps=2)
        ref.update_fake(((imgs + 1.0) / 2.0)[:take])
    score = ref.compute()
    assert np.isfinite(score) and last == f"{score:.4f}"
    with pytest.raises(SystemExit, match="need >= 2 real images"):
        eval_fid.main(args + ["--max-real", "1"])
