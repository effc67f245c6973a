"""The port's in-process sharded sampling on the CPU: `sample` and
`sample_batch` over a list of devices (repeats allowed, the batch padded
with wrap-around rows) against the one-device results, per-row generators
across shards, `sample_grid`, `eval_fid` and `serve` with `--device cpu
--data-parallel 2`, their refusals, and the launch counters under threads.
Bar: 1e-5 against the one-device run (tests/test_sharding.py's): each
shard samples its rows with the same draws, at another batch size."""

import argparse
import glob
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

from image_diffusion_torch import ops
from image_diffusion_torch.core.config import ScheduleConfig, UNetArch, VAEArch
from image_diffusion_torch.models import build_unet, build_vae
from image_diffusion_torch.models import fid as tfid
from image_diffusion_torch.ops import attention
from image_diffusion_torch.parallel.mesh import shard_devices
from image_diffusion_torch.pipelines import DiffusionPipeline
from image_diffusion_torch.scripts import eval_fid, sample_grid, serve

VAE_TINY = VAEArch(in_channels=3, channels=(8, 16), z_dim=3, enc_num_res_blocks=1,
                   dec_num_res_blocks=1, attn_resolutions=(), num_heads=2, init_resolution=16,
                   num_groups=4)
UNET_TINY = UNetArch(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16,
                     num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
REL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_pipeline(num_steps=12, vq=False):
    g = torch.Generator().manual_seed(3)
    arch = VAEArch(**{**VAE_TINY.to_dict(), **(dict(bottleneck="vq", codebook_size=16,
                                                       codebook_beta=0.25, codebook_gamma=0.99)
                                                  if vq else {})})
    vae = build_vae(arch, torch.float32, "cpu", g).state_dict()
    unet = build_unet(UNET_TINY, torch.float32, "cpu", g).state_dict()
    return DiffusionPipeline(arch, vae, UNET_TINY, unet, ScheduleConfig(num_steps=num_steps),
                             "a,b,c", dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def pipe():
    return tiny_pipeline()


@pytest.fixture(scope="module")
def bundle(pipe, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundle") / "tiny.ckpt")
    pipe.to_checkpoint(path)
    return path


def assert_close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    torch.testing.assert_close(got, ref, rtol=REL, atol=REL)


@pytest.mark.parametrize("sampler,steps,eta", [("ddpm", None, 0.0), ("ddim", 6, 1.0),
                                               ("dpm", 5, 0.0)])
@pytest.mark.parametrize("scales,shards", [(list(range(1, 10)), 2), ([3.0], 8)])
def test_sharded_grid_equals_the_one_device_grid(pipe, sampler, steps, eta, scales, shards):
    """27 images over 2 shards (28 rows) and 3 over 8 (8 rows, most of
    them padding): the grid of one device, in order, at 1e-5; the
    stochastic samplers' noise is the one-device draw's rows."""
    kw = dict(seed=4, sampler=sampler, num_inference_steps=steps, eta=eta)
    ref = pipe.sample(scales, **kw)
    got = pipe.sample(scales, devices=["cpu"] * shards, **kw)
    assert got.shape[0] == 3 * len(scales)
    assert_close(got, ref)


def test_distinct_devices_get_replicas_and_threads(pipe):
    """Shards on two distinct devices ("cpu:0" is not "cpu"): a replica of
    the weights for the device that is not the pipeline's, one thread a
    device, the caller's site log filled from both, and the one-device
    grid."""
    fresh = tiny_pipeline()
    with ops.record_sites() as ref_sites:
        ref = fresh.sample([1.0, 2.0], seed=6, sampler="dpm", num_inference_steps=3)
    with ops.record_sites() as sites:
        got = fresh.sample([1.0, 2.0], seed=6, sampler="dpm", num_inference_steps=3,
                           devices=["cpu:0", "cpu"])
    assert list(fresh._replicas) == [torch.device("cpu", 0)]
    assert fresh._replicas[torch.device("cpu", 0)][0] is not fresh.unet
    # the UNet's sites at 12 rows (6 images, conditional and unconditional)
    # unsharded, at 6 on each shard; the decode's at 6 images and at 3
    unet_sites = len([s for s in ref_sites if s[0] == 12])
    assert unet_sites > 0 and len([s for s in sites if s[0] == 6]) == 2 * unet_sites
    assert len(sites) - 2 * unet_sites == 2 * (len(ref_sites) - unet_sites)
    assert_close(got, ref)


def test_sharded_vq_decode_and_uint8(pipe):
    vq = tiny_pipeline(num_steps=6, vq=True)
    ref = vq.sample([1.0, 2.0], seed=1, sampler="ddpm", output="uint8")
    got = vq.sample([1.0, 2.0], seed=1, sampler="ddpm", output="uint8", devices=["cpu"] * 4)
    assert got.dtype == torch.uint8 and (got.int() - ref.int()).abs().max() <= 1


def test_sample_batch_noise_block_and_generator_state(pipe):
    """A step-noise block's rows go with their rows; a caller's generator
    ends in the state the one-device run leaves (shard 0 draws from it)."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(5, 8, 8, 3, generator=g)
    noise = torch.randn(12, 5, 8, 8, 3, generator=g)
    args = ([0, 1, 2, 0, 1], [1.0, 2.0, 3.0, 4.0, 5.0], x)
    ref = pipe.sample_batch(*args, sampler="ddpm", noise=noise)
    assert_close(pipe.sample_batch(*args, sampler="ddpm", noise=noise, devices=["cpu"] * 3), ref)
    gens = [torch.Generator().manual_seed(2) for _ in range(2)]
    ref = pipe.sample_batch(*args, sampler="ddim", num_inference_steps=4, eta=1.0,
                            generator=gens[0])
    got = pipe.sample_batch(*args, sampler="ddim", num_inference_steps=4, eta=1.0,
                            generator=gens[1], devices=["cpu"] * 2)
    assert_close(got, ref)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.parametrize("sampler,steps,eta", [("ddim", 6, 1.0), ("dpm", 5, 0.0)])
def test_each_shard_equals_its_rows_alone(pipe, sampler, steps, eta):
    """The grid's own draws rebuilt from its seed (the initial latents,
    then one grid-shaped draw a step) reproduce the one-device grid bit for
    bit through `noise=`; over 2 shards each shard's rows equal, bit for
    bit, `sample_batch` of its 14 rows alone with their rows of that block
    (the second shard's: 14-26 and the wrap-around pad row 0), so the
    sharded draw path hands each row its own noise exactly."""
    scales = list(range(1, 10))
    labels = torch.arange(3).repeat(9)
    row_scales = torch.tensor(scales, dtype=torch.float32).repeat_interleave(3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((27, *pipe.latent_shape), generator=g)
    block = torch.stack([torch.randn(x.shape, generator=g) for _ in range(steps)])
    kw = dict(sampler=sampler, num_inference_steps=steps, eta=eta)
    ref = pipe.sample(scales, seed=4, **kw)
    if eta:
        assert torch.equal(pipe.sample_batch(labels, row_scales, x, noise=block, **kw), ref)
    sharded = pipe.sample(scales, seed=4, devices=["cpu"] * 2, **kw)
    for rows in (list(range(14)), list(range(14, 27)) + [0]):
        own = pipe.sample_batch(labels[rows], row_scales[rows], x[rows],
                                noise=block[:, rows] if eta else None, **kw)
        n = min(len(rows), 27 - rows[0])
        assert torch.equal(own[:n], sharded[rows[0]:rows[0] + n]), rows[0]


def test_row_generators_go_with_their_rows(pipe):
    """Per-row generators under ddpm: a request's image is the same alone,
    in a one-device batch, and in any slot of a batch sharded 2 or 3 ways
    (padding rows draw from copies, so no generator is drawn twice)."""
    seeds = [11, 12, 13, 14, 15]

    def run(order, devices=None):
        gens = [torch.Generator().manual_seed(seeds[i]) for i in order]
        x = torch.stack([torch.randn(8, 8, 3, generator=g) for g in gens])
        labels, scales = [i % 3 for i in order], [1.0 + i for i in order]
        out = pipe.sample_batch(labels, scales, x, sampler="ddpm", row_generators=gens,
                                devices=devices)
        return dict(zip(order, out))

    ref = run(range(5))
    for order, devices in (([4, 3, 2, 1, 0], ["cpu"] * 2), ([2, 0, 4, 1, 3], ["cpu"] * 3),
                           ([3], ["cpu"] * 2)):
        got = run(order, devices)
        for i in order:
            assert_close(got[i], ref[i])


def test_shard_devices_rules():
    """The sampling CLIs' shards: one CPU device unless asked; N CPU shards
    with --data-parallel N; the card by default, which this host may lack."""
    assert shard_devices("cpu") is None
    assert shard_devices("cpu", 3) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard_devices("cuda", 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sample_grid.sample(sample_grid.parse_args(["x.ckpt", "--data-parallel", "2"]))


def test_sample_grid_cli_data_parallel(bundle):
    """`sample_grid --device cpu --data-parallel 2` gives the one-shard
    images of the same arguments."""
    argv = [bundle, "--device", "cpu", "--sampler", "dpm", "--steps", "4", "--cfg", "1", "4",
            "--seed", "2"]
    _, _, ref, _ = sample_grid.sample(sample_grid.parse_args(argv))
    _, scales, got, _ = sample_grid.sample(sample_grid.parse_args(argv + ["--data-parallel", "2"]))
    assert scales == [1, 2, 3] and got.shape == (9, 16, 16, 3)
    assert_close(got, ref)


def test_eval_fid_cli_data_parallel(bundle, tmp_path, monkeypatch):
    """`eval_fid --device cpu --data-parallel 2`: the fake statistics and
    the FID of the one-shard run, 5 images in calls of 3.  The features are
    a fixed random projection in place of the InceptionV3 (the FID's
    pluggable feature function; tests/test_torch_port_eval_fid.py runs the
    CLI with the Inception): only the sampling is sharded."""
    from image_diffusion_torch.models import inception

    np.save(tmp_path / "real.npy",
            np.random.default_rng(12).integers(0, 256, (5, 16, 16, 3), dtype=np.uint8))
    proj = torch.randn(16 * 16 * 3, 2048, generator=torch.Generator().manual_seed(4))
    monkeypatch.setattr(inception, "load_inception",
                        lambda path, device: lambda x: x.reshape(len(x), -1).float() @ proj)
    made = []

    class Recording(tfid.FID):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(tfid, "FID", Recording)
    argv = [bundle, "--real", str(tmp_path / "real.npy"), "--fid-weights", "unused.pth",
            "--num-images", "5", "--batch", "3", "--sampler", "ddim", "--steps", "2",
            "--device", "cpu"]
    ref = eval_fid.evaluate(eval_fid.parse_args(argv))
    got = eval_fid.evaluate(eval_fid.parse_args(argv + ["--data-parallel", "2"]))
    assert got["images"] == ref["images"] == 5 and got["calls"] == ref["calls"] == 2
    one, two = made
    assert two.fake.n == one.fake.n == 5
    np.testing.assert_allclose(two.fake.sum, one.fake.sum, rtol=REL, atol=REL)
    assert got["fid"] == pytest.approx(ref["fid"], rel=1e-4)


def engine(bundle, **kw):
    args = dict(model=bundle, host="127.0.0.1", port=0, batch_size=4, linger_ms=1.0,
                sampler="ddpm", steps=4, eta=0.0, device="cpu", data_parallel=None)
    return serve.Engine(argparse.Namespace(**{**args, **kw}))


def test_serve_data_parallel_batches_equal_one_device(bundle):
    """An engine sharding its batch of 4 over 2 CPU shards answers with the
    images of the one-device engine, per-row generators and all."""
    seeds, labels, scales = [5, 6, 7, 0], [0, 1, 2, 0], [1.0, 2.0, 3.0, 1.0]
    ref = engine(bundle)._run(seeds, labels, scales)
    eng = engine(bundle, data_parallel=2)
    assert eng.devices == [torch.device("cpu")] * 2
    got = eng._run(seeds, labels, scales)
    assert got.dtype == torch.uint8 and (got.int() - ref.int()).abs().max() <= 1


def test_serve_refuses_a_data_parallel_that_does_not_divide(bundle):
    with pytest.raises(SystemExit, match="--data-parallel 3 must divide --batch-size 4"):
        engine(bundle, data_parallel=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine(bundle, device="cuda", data_parallel=2)


def test_launch_counter_survives_threads():
    """The wrappers' launch counts under contention: 16 threads of 5,000
    increments with a 1 us switch interval lose none."""
    class Wrapper:
        launches = 0

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [attention._count_launch(Wrapper)
                                                    for _ in range(5000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert Wrapper.launches == 16 * 5000


def test_every_jax_cli_flag_has_a_counterpart():
    """The JAX CLIs' flags against the port's: only `--use-cpu`, which the
    port's `--device` replaces, has none."""
    def flags(path):
        return set(re.findall(r"""add_argument\(\s*["'](--[a-z0-9-]+)""", open(path).read()))

    missing = {}
    for path in sorted(glob.glob(os.path.join(REPO, "scripts", "*.py"))):
        port = os.path.join(REPO, "image_diffusion_torch", "scripts", os.path.basename(path))
        if os.path.basename(path) != "__init__.py":
            missing[os.path.basename(path)] = flags(path) - flags(port)
    assert len(missing) == 8 and {"--data-parallel"} <= flags(os.path.join(REPO, "scripts",
                                                                           "serve.py"))
    assert set().union(*missing.values()) == {"--use-cpu"}, missing
