"""The port's spans (`core/profiling.py`): nothing recorded and nothing of
torch called with no profiler running; under a profiler, nesting, parents
across the sampler's worker thread, the spans of a sampling call and of the
two train steps, and their place on a trace's clock.  On the card, spans
placed on the clock of a trace of CUDA activity alone hold exactly the
launches made inside them.

Imports neither JAX nor the JAX package, so the card test runs on a machine
with a card and no JAX (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_port_tracing.py -q --noconftest

Without a card the `cuda` tests skip.
"""

import contextvars
import json
import os
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from image_diffusion_torch.core import profiling
from image_diffusion_torch.core.config import (ScheduleConfig, UNetArch, VAEArch, VAEConfig,
                                               VAETrainConfig)
from image_diffusion_torch.core.profiling import span, take_spans, trace
from image_diffusion_torch.models import build_discriminator, build_unet, build_vae
from image_diffusion_torch.models.layers import GroupNorm
from image_diffusion_torch.ops import schedule as S
from image_diffusion_torch.pipelines import DiffusionPipeline
from image_diffusion_torch.training.diffusion_trainer import (Optimizer, TrainState,
                                                              make_train_step)
from image_diffusion_torch.training.vae_trainer import VAETrainState, make_vae_train_step

UNET = UNetArch(z_dim=3, channels=(16, 32), mid_channels=(32, 32), time_dim=32,
                num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
VAE = VAEArch(channels=(16, 32), z_dim=3, enc_num_res_blocks=1, dec_num_res_blocks=1,
              init_resolution=16, num_groups=4)


@pytest.fixture(autouse=True)
def empty_buffer():
    take_spans()
    yield
    take_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(func)
        return func(*args, **(kwargs or {}))


def test_off_records_nothing_and_calls_nothing_of_torch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with no profiler running")

    for owner, name in ((torch.cuda, "is_initialized"), (torch.cuda, "current_stream"),
                        (torch.autograd.profiler, "record_function"),
                        (threading, "get_native_id")):
        monkeypatch.setattr(owner, name, refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with Ops() as ops:
        with span("outer", rows=4):
            with span("inner"):
                pass
    assert ops.seen == [] and take_spans() == []


def test_nesting_parents_and_groups():
    with cpu_profile():
        for _ in range(2):
            with span("step", rows=8):
                with span("forward"):
                    with span("groupnorm"):
                        pass
                with span("optimizer"):
                    pass
    spans = take_spans()
    assert [s.name for s in spans] == ["groupnorm", "forward", "optimizer", "step"] * 2
    by = {s.id: s for s in spans}
    for s in spans:
        assert s.start <= s.end and s.tid == threading.get_native_id()
        if s.name == "step":
            assert s.parent is None and s.group == s.id and s.attrs == {"rows": 8}
            assert [k for k, _ in s.anchors] == ["host"]  # no CUDA here
        else:
            p = by[s.parent]
            assert p.start <= s.start and s.end <= p.end and s.group == p.group
            assert s.anchors == ()
    assert len({s.group for s in spans}) == 2
    assert take_spans() == []


def test_the_callers_span_is_the_parent_in_a_worker_thread():
    """`sample_batch` runs its shards in threads started with a copy of the
    caller's context: their spans are the call's children, and each one
    that starts a stretch of the worker's work would be anchored."""
    with cpu_profile():
        with span("call"):
            ctx = contextvars.copy_context()

            def work():
                for _ in range(2):
                    with span("step"):
                        with span("unet"):
                            pass
                return threading.get_native_id()

            with ThreadPoolExecutor(1) as pool:
                worker = pool.submit(ctx.run, work).result()
    spans = {(s.name, s.start): s for s in take_spans()}
    call = next(s for s in spans.values() if s.name == "call")
    steps = [s for s in spans.values() if s.name == "step"]
    assert worker != call.tid and len(steps) == 2
    for s in spans.values():
        if s.name != "call":
            assert s.tid == worker and s.group == call.id
    # no CUDA here, and the CPU profiler records the profiling thread alone:
    # the worker's steps make no anchor, the call a host one
    assert all(s.parent == call.id for s in steps)
    assert [k for k, _ in call.anchors] == ["host"]
    assert all(not s.anchors for s in spans.values() if s.name != "call")


def test_trace_writes_the_spans_on_its_clock(tmp_path):
    """Each span lies inside the host annotation around it and holds the one
    inside it, with a millisecond's room either side."""
    pause = 1e-3
    with trace(str(tmp_path)):
        with record_function("around"):
            time.sleep(pause)
            with span("block", rows=2):
                time.sleep(pause)
                with record_function("inside"):
                    time.sleep(pause)
                time.sleep(pause)
            time.sleep(pause)
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    marks = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    (block,) = [e for e in events if e.get("cat") == "program_span"]
    assert block["name"] == "block" and block["args"]["rows"] == 2
    assert block["tid"] == threading.get_native_id() and block["pid"] == os.getpid()
    around, inside = marks["around"], marks["inside"]
    room = 0.5 * pause * 1e6  # microseconds
    assert around["ts"] + room < block["ts"] < inside["ts"] - room
    end = block["ts"] + block["dur"]
    assert inside["ts"] + inside["dur"] + room < end < around["ts"] + around["dur"] - room
    assert take_spans() == []


def test_the_clock_fit_pairs_the_traces_anchors_and_leaves_out_a_delayed_one():
    def one(anchor, start):
        return profiling.Span("s", start, start + 1.0, 7, 1, None, 1, {}, (("cuda", anchor),))

    # two anchors of a later trace follow the ten this trace holds
    spans = [one(1000.0 * k, 1000.0 * k + 5) for k in range(12)]
    ts = [500.0 + 1000.0 * k for k in range(10)]
    ts[3] += 300.0  # a call the host entered late
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "tid": 7, "ts": t,
               "dur": 1} for t in ts]
    fit = profiling.clock_fit(spans, events)
    assert fit.pairs == 9 and fit.b == pytest.approx(1.0) and fit.a == pytest.approx(500.0)
    placed = fit.place(spans)
    assert placed[2].start == pytest.approx(2505.0) and placed[2].anchors == ()
    assert profiling.clock_fit(spans, []) is None


def tiny_pipeline() -> DiffusionPipeline:
    g = torch.Generator().manual_seed(0)
    unet = build_unet(UNET, torch.float32, "cpu", g)
    vae = build_vae(VAE, torch.float32, "cpu", g)
    return DiffusionPipeline(VAE, vae.state_dict(), UNET, unet.state_dict(),
                             ScheduleConfig(num_steps=50), ["a", "b", "c"],
                             dtype=torch.float32, device="cpu")


def test_a_ddim_call_records_its_spans():
    pipe = tiny_pipeline()
    norms = Counter()
    for model in (pipe.unet, pipe.vae):
        for m in model.modules():
            if isinstance(m, GroupNorm):
                m.register_forward_hook(lambda *_: norms.update(["calls"]))
    B = 2
    x = torch.randn(B, *pipe.latent_shape, generator=torch.Generator().manual_seed(1))
    with cpu_profile():
        pipe.sample_batch([0, 2], [3.0, 3.0], x, sampler="ddim", num_inference_steps=3)
    spans = take_spans()
    names = Counter(s.name for s in spans)
    assert {k: names[k] for k in ("sample.call", "sample.step", "unet.forward",
                                  "sample.decode")} == {
        "sample.call": 1, "sample.step": 3, "unet.forward": 3, "sample.decode": 1}
    assert names["groupnorm"] == norms["calls"] > 0
    assert set(names) == {"sample.call", "sample.step", "unet.forward", "sample.decode",
                          "groupnorm"}
    (call,) = [s for s in spans if s.name == "sample.call"]
    assert call.attrs == {"rows": B} and all(s.group == call.id for s in spans)
    assert [s.attrs for s in spans if s.name == "unet.forward"] == [{"rows": 2 * B}] * 3
    by = {s.id: s for s in spans}
    assert {by[s.parent].name for s in spans if s.name == "unet.forward"} == {"sample.step"}


def test_a_diffusion_train_step_records_its_phases():
    g = torch.Generator().manual_seed(2)
    unet = build_unet(UNET, torch.float32, "cpu", g, param_dtype=torch.float32).train()
    state = TrainState(unet, Optimizer(unet.parameters(), 1e-4, 0, 1.0))
    step = make_train_step(S.make_schedule(50, 1e-4, 0.02, "linear", device="cpu"), 0.15, True)
    x = torch.randn(2, 4, 4, 6, generator=g)
    with cpu_profile():
        step(state, x, torch.tensor([0, 1]), g)
    spans = take_spans()
    by = {s.id: s for s in spans}
    assert Counter(s.name for s in spans if s.name != "groupnorm") == {
        "train.step": 1, "train.forward": 1, "unet.forward": 1, "train.backward": 1,
        "optimizer": 1}
    (top,) = [s for s in spans if s.name == "train.step"]
    assert top.attrs == {"rows": 2} and top.parent is None
    parents = {s.name: by[s.parent].name for s in spans if s.parent is not None}
    assert parents == {"train.forward": "train.step", "unet.forward": "train.forward",
                       "groupnorm": "unet.forward", "train.backward": "train.step",
                       "optimizer": "train.step"}


def test_a_stage1_step_records_its_phases_and_two_optimizers():
    g = torch.Generator().manual_seed(3)
    cfg = VAEConfig(arch=VAE, train=VAETrainConfig(batch_size=2, disc_channels=(8, 16)))
    vae = build_vae(VAE, torch.float32, "cpu", g, param_dtype=torch.float32).train()
    disc = build_discriminator((8, 16), torch.float32, "cpu", g)
    state = VAETrainState(vae, disc, Optimizer(vae.parameters(), 1e-4, 0, 1.0),
                          Optimizer(disc.parameters(), 1e-4, 0, 1.0))
    step = make_vae_train_step(cfg, lambda real, fake: (real - fake).abs().mean())
    x = torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8, generator=g)
    with cpu_profile():
        step(state, x, g, True)
    spans = take_spans()
    by = {s.id: s for s in spans}
    assert Counter(s.name for s in spans if s.name != "groupnorm") == {
        "vae.step": 1, "vae.forward": 1, "vae.disc_phase": 1, "vae.gen_phase": 1, "lpips": 1,
        "optimizer": 2}
    parents = Counter((s.name, by[s.parent].name) for s in spans if s.parent is not None)
    assert parents[("optimizer", "vae.disc_phase")] == parents[("optimizer", "vae.gen_phase")] == 1
    assert parents[("lpips", "vae.gen_phase")] == 1
    assert {by[s.parent].name for s in spans if s.name == "groupnorm"} == {"vae.forward"}


# ------------------------------------------------------------------ the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["caller", "worker thread"])
def test_cuda_spans_hold_exactly_the_launches_inside_them(card, where):
    """In a trace of CUDA activity alone (the benchmark's), a span placed by
    its anchors holds every launch made inside it and neither the launch
    just before it nor the one just after, and bears the id the trace gives
    the launching thread."""
    x = torch.ones(1 << 10, device="cuda")
    for _ in range(3):  # warm the kernels and the allocator
        x.neg_(), x.add_(1.0), x.abs_()
    torch.cuda.synchronize()
    inside = 64

    def burst():
        for _ in range(3):  # spans before: anchors for the fit
            with span("warm"):
                x.mul_(1.0)
        x.neg_()
        with span("burst"):
            for _ in range(inside):
                x.add_(1.0)
        x.abs_()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if where == "caller":
            burst()
        else:
            with span("call"), ThreadPoolExecutor(1) as pool:
                pool.submit(contextvars.copy_context().run, burst).result()
        torch.cuda.synchronize()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"cuda_spans_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    recorded = take_spans()
    fit = profiling.clock_fit(recorded, events)
    assert fit is not None
    print(f"clock fit: {fit}")
    (burst_span,) = [s for s in fit.place(recorded) if s.name == "burst"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    kinds, tids = {"neg": [], "add": [], "abs": []}, set()
    for e in events:
        if e.get("cat") == "kernel":
            for k in kinds:
                if k in e["name"].lower():
                    call = launch[e["args"]["correlation"]]
                    kinds[k].append(call["ts"])
                    tids.add(call["tid"])
    assert tids == {burst_span.tid}
    assert len(kinds["add"]) == inside and len(kinds["neg"]) == len(kinds["abs"]) == 1
    assert all(burst_span.start <= t < burst_span.end for t in kinds["add"])
    assert kinds["neg"][0] < burst_span.start and kinds["abs"][0] >= burst_span.end
    print(f"room: {burst_span.start - kinds['neg'][0]:.2f} us before, "
          f"{kinds['abs'][0] - burst_span.end:.2f} us after; launches "
          f"{min(kinds['add']) - burst_span.start:.2f} us after the start, "
          f"{burst_span.end - max(kinds['add']):.2f} us before the end")
