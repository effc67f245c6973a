"""The trace reader and the per-layer readers on a small synthetic Chrome
trace: the idle share from the union of device intervals (overlaps
counted once, clipped to the window), kernels per step, attention
attributed by kernel name and by the host operation that launched it, and
the breakdown."""

import types
from pathlib import Path

import pytest

import harness
import tracereader

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def X(name, cat, ts, dur, tid, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events(window=True):
    ev = [
        # the host's main thread and the autograd thread
        X("aten::convolution", "cpu_op", 0, 12, 1),
        X("cudaLaunchKernel", "cuda_runtime", 5, 2, 1, corr=1),
        X("cudaLaunchKernel", "cuda_runtime", 8, 2, 1, corr=2),
        X("autograd::engine::evaluate_function: FlashAttentionBackward", "cpu_op", 35, 35, 2),
        X("cudaLaunchKernel", "cuda_runtime", 48, 1, 2, corr=3),
        X("cudaLaunchKernel", "cuda_runtime", 85, 1, 1, corr=4),
        # the card: two overlapping kernels, one under FlashAttentionBackward,
        # one running past the window's end
        X("sm90_xmma_gemm_bf16", "kernel", 10, 20, 7, corr=1),
        X("void (anonymous namespace)::wg_packed_attention_kernel<16>(...)", "kernel", 20, 20, 7,
          corr=2),
        X("softmax_warp_backward", "kernel", 50, 10, 7, corr=3),
        X("Memset (Device)", "gpu_memset", 90, 30, 7, corr=4),
    ]
    if window:
        ev.append(X("bench.window", "user_annotation", 0, 100, 1))
    return ev


def test_busy_is_the_union_of_device_intervals_in_the_window():
    s = tracereader.summarize(events())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(50e-6)  # [10, 40] + [50, 60] + [90, 100]
    assert s.kernels == 3


def test_without_an_annotation_the_window_is_the_traces_span():
    s = tracereader.summarize(events(window=False))
    assert s.window_s == pytest.approx(120e-6)
    assert s.busy_s == pytest.approx(70e-6)


def test_breakdown_ranks_device_ops_and_names_gaps_by_the_host():
    s = tracereader.summarize(events())
    assert s.device_ops[0] == ["sm90_xmma_gemm_bf16", pytest.approx(20e-6)]
    gaps = dict((k, v) for k, v in s.idle_gaps)
    # [0, 10]: the convolution on the main thread; [40, 50] and [60, 90]:
    # the autograd node on its own thread
    assert gaps == {"aten::convolution": pytest.approx(10e-6),
                    "autograd::engine::evaluate_function: FlashAttentionBackward":
                        pytest.approx(40e-6)}


def test_gaps_outside_any_host_event():
    ev = [e for e in events() if e["tid"] != 2]
    gaps = dict(tracereader.summarize(ev).idle_gaps)
    assert gaps[tracereader.NO_CALL] == pytest.approx(40e-6)  # [40, 50] and [60, 90]


def test_attention_by_kernel_name_and_by_launching_host_op():
    train = harness.load_file(METRICS / "attn_roofline.train.py")
    ev = events()
    assert tracereader.device_seconds(ev, train.KERNELS) == pytest.approx(20e-6)
    assert tracereader.device_seconds(ev, train.KERNELS, train.HOST_OPS) == pytest.approx(30e-6)
    sample = harness.load_file(METRICS / "attn_roofline.sample.py")
    assert tracereader.device_seconds(ev, sample.KERNELS) == pytest.approx(20e-6)


def reading(ev, units=2):
    session = types.SimpleNamespace(unit_steps=3, unit_flops=1e9,
                                    unit_attention=[(989e12 * 5e-6, 0.0)])
    return harness.Reading(tracereader.summarize(ev), ev, units, session, lambda: ev)


@pytest.mark.parametrize("kind", ["sample", "train"])
def test_per_layer_readers(kind):
    r = reading(events())
    read = {m: harness.load_file(METRICS / f"{m}.{kind}.py").read
            for m in ("idle_share", "kernels_per_step", "mfu", "attn_roofline")}
    assert read["idle_share"](r) == pytest.approx(50.0)
    assert read["kernels_per_step"](r) == pytest.approx(3 / 6)
    assert read["mfu"](r) == pytest.approx(100 * 2e9 / 100e-6 / 989e12)
    # 2 units of 5 us of least time against 20 us of packed kernels, and for
    # training 2 x 10 us more launched under the flash sites' gradient
    want = 100 * 10e-6 / (20e-6 if kind == "sample" else 40e-6)
    assert read["attn_roofline"](r) == pytest.approx(want)


def test_readers_return_nothing_without_work():
    r = reading(events())
    r.attention, r.flops = [], 0
    for m in ("mfu.train", "attn_roofline.train", "attn_roofline.sample"):
        assert harness.load_file(METRICS / f"{m}.py").read(r) is None
