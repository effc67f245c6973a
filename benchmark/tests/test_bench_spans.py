"""The program's spans in a synthetic traced window: their place on the
trace's clock by their anchors, the credit rule (by the launching thread,
else by any thread; idle gaps split at the spans' edges), the four readers
that use it, and a program without spans, which leaves them unread."""

import types
from pathlib import Path

import pytest

import harness
import spans as S
from image_diffusion_torch.core import profiling

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SHIFT = 5000.0  # the recorder's clock runs this far ahead of the trace's
MAIN, WORKER, AUTOGRAD = 1, 2, 3
# a trace of CUDA activity alone names a thread's runtime calls otherwise
# than by its native id
TRACE_TID = {MAIN: 9001, WORKER: 9002, AUTOGRAD: 9003}


def X(name, cat, ts, dur, tid, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(corr, at, tid, start, dur, name="kernel_k"):
    return [X("cudaLaunchKernel", "cuda_runtime", at, 1, TRACE_TID[tid], corr),
            X(name, "kernel", start, dur, 7, corr)]


class Program:
    """Spans as the recorder keeps them (its own clock), and the anchor
    events a trace holds of them."""

    def __init__(self):
        self.spans, self.events = [], []

    def add(self, name, start, end, tid, parent=None, anchored=False, **attrs):
        sid = len(self.spans) + 1
        group = sid if parent is None else self.spans[parent - 1].group
        anchors = (("cuda", start + SHIFT),) if anchored else ()
        self.spans.append(profiling.Span(name, start + SHIFT, end + SHIFT, tid, sid, parent,
                                         group, attrs, anchors))
        if anchored:
            self.events.append(X("cudaStreamQuery", "cuda_runtime", start, 0.5, TRACE_TID[tid]))
        return sid


def sampling():
    """A call on the main thread, two sampler steps on a worker, the UNet
    and a GroupNorm in the first; kernels launched inside a GroupNorm, in the
    UNet, from a thread with no span open, on the main thread (once while
    the worker's GroupNorm is open), and after the call."""
    p = Program()
    call = p.add("sample.call", 0, 100, MAIN, anchored=True, rows=2)
    step = p.add("sample.step", 10, 60, WORKER, call, anchored=True)
    unet = p.add("unet.forward", 15, 55, WORKER, step, rows=4)
    p.add("groupnorm", 20, 30, WORKER, unet)
    p.add("sample.step", 60, 90, WORKER, call, anchored=True)
    ev = p.events + (launch(1, 22, WORKER, 30, 10) + launch(2, 40, WORKER, 40, 5)
                     + launch(3, 50, AUTOGRAD, 45, 5) + launch(4, 95, MAIN, 95, 3)
                     + launch(5, 105, MAIN, 105, 5) + launch(6, 25, MAIN, 31, 2))
    return p.spans, ev


def training():
    p = Program()
    top = p.add("train.step", 0, 100, MAIN, anchored=True, rows=8)
    p.add("train.backward", 10, 50, MAIN, top)
    p.add("optimizer", 60, 80, MAIN, top)
    p.add("train.step", 100, 140, MAIN, anchored=True, rows=8)
    ev = p.events + (launch(1, 5, MAIN, 5, 10) + launch(2, 20, AUTOGRAD, 20, 20)
                     + launch(3, 65, MAIN, 65, 10) + launch(4, 105, MAIN, 110, 10))
    return p.spans, ev


def reading(monkeypatch, recorded, events):
    taken = [recorded]
    monkeypatch.setattr(profiling, "take_spans", lambda: taken.pop() if taken else [])
    return types.SimpleNamespace(events=events)


def read(name, r):
    return harness.load_file(METRICS / f"{name}.py").read(r)


def test_spans_are_placed_on_the_traces_clock_and_clipped():
    recorded, events = sampling()
    fit = profiling.clock_fit(recorded, events)
    assert fit.pairs == 3 and fit.b == pytest.approx(1.0) and fit.a == pytest.approx(-SHIFT)
    assert fit.threads == {MAIN: 9001, WORKER: 9002}
    placed = S.clipped(fit.place(recorded), 25.0, 70.0)
    assert [s.tid for s in placed] == [9001, 9002, 9002, 9002, 9002]
    assert [(s.name, s.start, s.end) for s in placed] == [
        ("sample.call", 25, 70), ("sample.step", 25, 60), ("unet.forward", 25, 55),
        ("groupnorm", 25, 30), ("sample.step", 60, 70)]


def test_credit_by_launching_thread_then_any_thread():
    recorded, events = sampling()
    placed = profiling.clock_fit(recorded, events).place(recorded)
    c = S.credit(events, placed)
    assert c.window_s == pytest.approx(110e-6) and c.busy_s == pytest.approx(28e-6)
    # the GroupNorm's launch, the UNet's, the autograd-like thread's (no span
    # of its own: the innermost on any thread, the UNet), the call's two (one
    # while the worker's GroupNorm is the innermost on any thread), and one
    # after every span
    assert c.device == pytest.approx({"groupnorm": 10e-6, "unet.forward": 10e-6,
                                      "sample.call": 5e-6, S.OUTSIDE: 5e-6})
    unet = next(s for s in placed if s.name == "unet.forward")
    assert c.inclusive[unet.id] == pytest.approx(20e-6)
    assert c.ops == {"kernel_k": pytest.approx(c.device)}


def test_an_idle_gap_is_split_at_the_spans_edges():
    recorded, events = sampling()
    c = S.credit(events, profiling.clock_fit(recorded, events).place(recorded))
    # idle [0, 30]: call, step, UNet, GroupNorm; [50, 95]: the UNet, the
    # first step, the second step, the call; [98, 105]: the call, outside
    assert c.idle == pytest.approx({"sample.call": 17e-6, "sample.step": 40e-6,
                                    "unet.forward": 10e-6, "groupnorm": 10e-6,
                                    S.OUTSIDE: 5e-6})


def test_the_sample_readers_share_one_take(monkeypatch, capsys):
    r = reading(monkeypatch, *sampling())
    assert read("program_idle_share.sample", r) == pytest.approx(100 * 77 / 110)
    assert read("norm_share.sample", r) == pytest.approx(100 * 10 / 28)
    err = capsys.readouterr().err
    assert "clock from 3 anchors" in err and err.count("clock from") == 1
    assert "unet.forward 0.020 device ms over 4 rows: 5.0000 ms per 1,000 rows" in err
    assert ("0.000030 s of kernel_k: groupnorm 0.000010, unet.forward 0.000010, "
            "sample.call 0.000005, outside the program 0.000005") in err


def test_the_train_readers(monkeypatch):
    r = reading(monkeypatch, *training())
    # the window [0, 120] (the trace's events; the second step is cut),
    # busy [5, 15], [20, 40], [65, 75] and [110, 120]: every gap inside a step
    assert read("program_idle_share.train", r) == pytest.approx(100 * 70 / 120)
    assert read("optimizer_share.train", r) == pytest.approx(100 * 10 / 50)
    c = r._program_spans[1]
    assert c.device == pytest.approx({"train.step": 20e-6, "train.backward": 20e-6,
                                      "optimizer": 10e-6})
    assert c.idle == pytest.approx({"train.step": 45e-6, "train.backward": 15e-6,
                                    "optimizer": 10e-6})


@pytest.mark.parametrize("name", ["program_idle_share.sample", "program_idle_share.train",
                                  "norm_share.sample", "optimizer_share.train"])
def test_a_program_without_spans_leaves_the_readers_unread(monkeypatch, name):
    _, events = sampling()
    monkeypatch.delattr(profiling, "take_spans")
    assert read(name, types.SimpleNamespace(events=events)) is None


def test_spans_whose_anchors_the_trace_lacks_leave_the_readers_unread(monkeypatch):
    recorded, events = sampling()
    events = [e for e in events if e["name"] != "cudaStreamQuery"]
    assert read("norm_share.sample", reading(monkeypatch, recorded, events)) is None
