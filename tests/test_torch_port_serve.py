"""The port's serving path: `DiffusionPipeline.sample_batch` given the
JAX server's per-row draws against JAX's `sample_batch(row_keys=...)`; the
port's `Engine` (slot independence, its batches against `sample_batch`
with the same per-row generators, failures reaching the waiters); and
`python -m image_diffusion_torch.scripts.serve` as a subprocess on the CPU,
answering `/healthz`, `/info` and `/sample` as `scripts/serve.py` does."""

import argparse
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.ops import schedule as JS
from image_diffusion_tpu.pipelines.diffusion import DiffusionPipeline as JPipeline
from image_diffusion_torch.core.config import ScheduleConfig, UNetArch, VAEArch
from image_diffusion_torch.models import build_unet, build_vae
from image_diffusion_torch.pipelines import DiffusionPipeline
from image_diffusion_torch.scripts import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["a hot place", "a cold place", "a mild place"]
# the tiny bundle of tests/test_serve.py: 16x16 images, 8x8x3 latents
VAE_TINY = VAEArch(in_channels=3, channels=(8, 16), z_dim=3, bottleneck="kl",
                   enc_num_res_blocks=1, dec_num_res_blocks=1, attn_resolutions=(),
                   num_heads=2, init_resolution=16, num_groups=4)
UNET_TINY = UNetArch(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16,
                     num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
T_STEPS = 20
# fp32 on both sides through the UNet calls and the decode (the tiny
# pipeline's bar, tests/test_torch_port_pipeline.py)
ATOL = 5e-4
PNG = b"\x89PNG\r\n\x1a\n"


def tiny_pipeline(seed=3):
    g = torch.Generator().manual_seed(seed)
    vae = build_vae(VAE_TINY, torch.float32, "cpu", g).state_dict()
    unet = build_unet(UNET_TINY, torch.float32, "cpu", g).state_dict()
    return DiffusionPipeline(VAE_TINY, vae, UNET_TINY, unet, ScheduleConfig(num_steps=T_STEPS),
                             CLASSES, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "bundle.ckpt")
    tiny_pipeline().to_checkpoint(path)
    return path


def engine_args(bundle, **kw):
    return argparse.Namespace(**{**dict(model=bundle, host="127.0.0.1", port=0, batch_size=2,
                                        linger_ms=1.0, sampler="ddpm", steps=4, eta=0.0,
                                        device="cpu", data_parallel=None), **kw})


@pytest.fixture(scope="module")
def jax_pipeline(bundle):
    return JPipeline.from_checkpoint(bundle, dtype=jnp.float32)


@pytest.fixture(scope="module")
def engine(bundle):
    return serve.Engine(engine_args(bundle))


# ------------------------------------------------- per-row draws against JAX


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm"])
def test_sample_batch_with_the_jax_servers_row_draws_matches_jax(bundle, jax_pipeline, sampler):
    """JAX's engine draws row i's latent from fold_in(key(0), seed_i) and its
    step-t noise from fold_in(that key, t); those draws, handed to the
    port's `sample_batch(noise=...)`, give JAX's `sample_batch(row_keys=...)`."""
    seeds, labels, scales = [7, 3, 11], [1, 2, 0], [2.5, 4.0, 1.0]
    n_steps, eta = 4, 1.0 if sampler == "ddim" else 0.0
    row_keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(0), s))(
        jnp.asarray(seeds, jnp.int32))
    shape = (8, 8, 3)
    x_init = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(row_keys)
    ref = np.asarray(jax_pipeline.sample_batch(labels, scales, x_init, sampler=sampler,
                                        num_inference_steps=n_steps, eta=eta, row_keys=row_keys))

    ts = (range(T_STEPS - 1, -1, -1) if sampler == "ddpm"
          else np.asarray(JS.make_timesteps(T_STEPS, n_steps)).tolist())
    noise = np.stack([np.asarray(jax.vmap(
        lambda k, t=t: jax.random.normal(jax.random.fold_in(k, t), shape, jnp.float32))(row_keys))
        for t in ts])
    pipe = DiffusionPipeline.from_checkpoint(bundle, dtype=torch.float32, device="cpu")
    got = pipe.sample_batch(labels, scales, np.array(x_init), sampler=sampler,
                            num_inference_steps=n_steps, eta=eta, noise=noise)
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_sample_without_row_generators_is_unchanged():
    """`sample` draws its latents and then one batch-shaped block a step
    from one generator, as before per-row draws existed: its images equal
    `sample_batch` given those blocks as `noise`, and the values a run of
    the pipeline before the change gave (stored; seed 5, weights seed 3)."""
    pipe = tiny_pipeline()
    stored = {
        "ddpm": ([-73.694992, -68.300949, -73.931442, -75.409225, -85.09227, -80.816139],
                 [-0.320326, 0.168033, 0.189772]),
        "ddim": ([-81.137054, -79.964157, -85.166779, -79.004837, -89.675797, -88.375229],
                 [-0.409304, 0.169046, 0.070414]),
    }
    for sampler, (sums, pixel) in stored.items():
        imgs = pipe.sample([1.0, 3.0], seed=5, sampler=sampler, num_inference_steps=5, eta=1.0)
        np.testing.assert_allclose(imgs.sum(dim=(1, 2, 3)).numpy(), sums, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(imgs[0, 0, 0].numpy(), pixel, atol=1e-5)

        gen = torch.Generator().manual_seed(5)
        x_init = torch.randn((6, 8, 8, 3), generator=gen)
        n = T_STEPS if sampler == "ddpm" else 5
        noise = torch.stack([torch.randn((6, 8, 8, 3), generator=gen) for _ in range(n)])
        ref = pipe.sample_batch(torch.arange(3).repeat(2), torch.tensor([1.0, 3.0])
                                .repeat_interleave(3), x_init, sampler=sampler,
                                num_inference_steps=5, eta=1.0, noise=noise)
        torch.testing.assert_close(imgs, ref, atol=0, rtol=0)


def test_row_generators_draw_each_rows_noise_alone():
    """Row i's noise comes from generator i in sequence, whatever the other
    rows' generators are; a wrong count raises."""
    pipe = tiny_pipeline()
    x = torch.zeros((2, 8, 8, 3))

    def run(seeds):
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        return pipe.sample_batch([0, 1], [1.0, 1.0], x, sampler="ddim", num_inference_steps=3,
                                 eta=1.0, row_generators=gens)

    a, b = run([4, 9]), run([4, 2])
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)
    assert not torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="1 row generators for a batch of 2"):
        pipe.sample_batch([0, 1], [1.0, 1.0], x, sampler="ddpm",
                          row_generators=[torch.Generator()])


# ------------------------------------------------------------------ Engine


def test_ddpm_request_independent_of_batch_slot(engine):
    """The ancestral sampler draws noise at every step; a request's image is
    byte-identical alone (slot 0, next to a pad row) and co-batched in slot
    1 next to another request; distinct seeds in one slot differ."""
    alone = engine._run([7, 0], [1, 0], [2.5, 1.0])[0]
    cobatched = engine._run([3, 7], [2, 1], [9.0, 2.5])[1]
    assert alone.dtype == torch.uint8 and alone.shape == (16, 16, 3)
    torch.testing.assert_close(alone, cobatched, atol=0, rtol=0)
    other = engine._run([8, 0], [1, 0], [2.5, 1.0])[0]
    assert not torch.equal(alone, other)


def test_engine_batch_equals_sample_batch_with_the_same_generators(engine):
    seeds, labels, scales = [5, 6], [0, 2], [3.0, 7.0]
    got = engine._run(seeds, labels, scales)
    gens = engine._row_generators(seeds)
    x_init = torch.stack([torch.randn((8, 8, 3), generator=g) for g in gens])
    ref = engine.pipe.sample_batch(labels, scales, x_init, sampler="ddpm", row_generators=gens,
                                   output="uint8")
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failures_reach_the_waiters_and_a_dead_worker_never_hangs(bundle):
    engine = serve.Engine(engine_args(bundle, linger_ms=500.0))

    def fail(*_):
        raise RuntimeError("launch failed")

    engine._run = fail  # a batch's exception is relayed to its requests
    with pytest.raises(RuntimeError, match="launch failed"):
        engine.submit({"seed": 0, "label": 0, "cfg_scale": 1.0})

    # a PNG failure midway through a batch reaches only the rows not answered
    del engine._run
    calls = []

    def to_png(arr):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("encoder failed")
        return serve.Engine._to_png(arr)

    engine._to_png = to_png
    results = {}

    def call(i):
        try:
            results[i] = engine.submit({"seed": i, "label": 0, "cfg_scale": 1.0})
        except OSError as e:
            results[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert engine.stats == {"requests": 3, "batches": 2}
    assert sorted(type(r).__name__ for r in results.values()) == ["OSError", "bytes"]

    def die(*_):
        raise SystemExit("worker killed")

    engine._run = die  # the worker thread itself dies: submit raises, never hangs
    t0 = time.time()
    with pytest.raises(RuntimeError, match="inference worker died"):
        engine.submit({"seed": 0, "label": 0, "cfg_scale": 1.0})
    assert time.time() - t0 < 30


def test_the_server_defaults_to_the_card(bundle):
    """No `--device` means the card; without one the engine raises and
    never carries on on the CPU."""
    args = serve.parse_args([bundle])
    assert args.device == "cuda" and args.batch_size == 8 and args.sampler == "dpm"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Engine(args)


def test_resolve_class(engine):
    assert engine.resolve_class(2) == 2 and engine.resolve_class("a cold place") == 1
    for bad in (3, -1, True, "nope", None):
        with pytest.raises(ValueError):
            engine.resolve_class(bad)


# ------------------------------------------------------------------ server


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _post(url, payload, timeout=120):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


SERVER_ARGS = ["--batch-size", "2", "--sampler", "dpm", "--steps", "4", "--linger-ms", "50"]


@pytest.fixture(scope="module")
def server(bundle):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "image_diffusion_torch.scripts.serve", bundle, "--device", "cpu",
         "--port", str(port), *SERVER_ARGS],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 180
        while time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(f"server died:\n{proc.stdout.read()[-4000:]}")
            try:
                status, body = _get(base + "/healthz")
                if status == 200 and json.loads(body)["compiled"]:
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            time.sleep(0.3)
        else:
            raise AssertionError("the server never reported compiled=true")
        yield base
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def jax_info(bundle):
    """`/info` of scripts/serve.py's handler over its Engine on the same
    bundle and flags (no sampling happens for /info)."""
    spec = importlib.util.spec_from_file_location("jax_serve", os.path.join(REPO, "scripts",
                                                                            "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = argparse.Namespace(model=bundle, batch_size=2, linger_ms=50.0, sampler="dpm",
                              steps=4, eta=0.0, data_parallel=None, use_cpu=True)
    httpd = mod._Server(("127.0.0.1", 0), mod.make_handler(mod.Engine(args)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        return json.loads(_get(f"http://127.0.0.1:{httpd.server_address[1]}/info")[1])
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_info_matches_the_jax_server(server, bundle):
    status, body = _get(server + "/info")
    info = json.loads(body)
    assert status == 200
    assert info["classes"] == CLASSES and info["sampler"] == "dpm" and info["steps"] == 4
    assert info["batch_size"] == 2 and info["image_size"] == 16
    assert set(info["stats"]) == {"requests", "batches"}
    ref = jax_info(bundle)
    info.pop("stats"), ref.pop("stats")
    assert info == ref


def test_sample_returns_png_and_is_seed_deterministic(server):
    status, png1, ctype = _post(server + "/sample", {"class": 1, "cfg_scale": 2.5, "seed": 11})
    assert status == 200 and ctype == "image/png" and png1[:8] == PNG
    assert _post(server + "/sample", {"class": 1, "cfg_scale": 2.5, "seed": 11})[1] == png1
    assert _post(server + "/sample", {"class": 1, "cfg_scale": 2.5, "seed": 12})[1] != png1


def test_class_by_name_and_concurrent_batching(server):
    before = json.loads(_get(server + "/info")[1])["stats"]
    results = {}

    def call(i):
        results[i] = _post(server + "/sample",
                           {"class": "a cold place", "cfg_scale": 3.0, "seed": 100 + i})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r[0] == 200 and r[1][:8] == PNG for r in results.values())
    after = json.loads(_get(server + "/info")[1])["stats"]
    # 3 concurrent requests into a batch-2 server: 2 or 3 batches
    assert after["requests"] - before["requests"] == 3
    assert 2 <= after["batches"] - before["batches"] <= 3
    # a request's image is the same however it was batched
    assert _post(server + "/sample", {"class": 1, "cfg_scale": 3.0, "seed": 101})[1] == results[1][1]


@pytest.mark.parametrize("path,payload,code", [
    ("/sample", {"class": 99}, 400),
    ("/sample", {"class": True}, 400),  # JSON booleans are no class index
    ("/sample", {"class": "nope"}, 400),
    ("/sample", {"seed": None}, 400),
    ("/sample", {"seed": 2 ** 64}, 400),  # beyond torch.Generator.manual_seed's range
    ("/sample", {"seed": -2 ** 63 - 1}, 400),
    ("/sample", b"[1, 2]", 400),
    ("/sample", b"{not json", 400),
    ("/other", {}, 404),
    ("/nothing", None, 404),
], ids=["index", "bool", "name", "null-seed", "seed-too-large", "seed-too-small", "array", "not-json", "post-path", "get-path"])
def test_bad_requests(server, path, payload, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        if payload is None:
            _get(server + path)
        else:
            _post(server + path, payload)
    assert e.value.code == code
