"""The port's packed-attention kernel module: its plain version against the
JAX packed kernel in interpret mode, the einsum path, the site route and
the wrapper's refusals.  The CUDA kernel itself is held against its plain
version in tests/test_torch_port_cuda.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.ops.pallas.attention import _packed_forward
from image_diffusion_torch import ops
from image_diffusion_torch.ops.attention import (
    packed_attention,
    reference_attention,
    reference_packed_attention,
)


def _qkv(B, N, C, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, N, C)) * scale).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("d", [16, 32, 48, 64])
def test_plain_version_matches_jax_packed_kernel(n, d):
    heads = 2
    q, k, v = _qkv(2, n, heads * d, seed=n + d)
    scale = 1.0 / math.sqrt(d)
    ref = np.asarray(jax.jit(lambda q, k, v: _packed_forward(q, k, v, heads, scale, True))(q, k, v))
    got = reference_packed_attention(*(torch.from_numpy(t) for t in (q, k, v)), heads)
    assert got.dtype == torch.float32
    # both use bf16 operands with fp32 accumulation (tests/test_pallas.py bar)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("d", [16, 32, 48, 64])
def test_plain_version_row_sums_are_the_weights_sums(n, d):
    """The row sums handed to the backward, (B, heads, N) fp32, against
    fp64 sums of the same fp32 weights: 1e-5 relative (an fp32 sum of n <=
    64 positive terms is exact to a few 2^-24), and the output is the one
    returned without them."""
    heads = 2
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, n, heads * d, seed=n + d))
    out, row_sum = reference_packed_attention(q, k, v, heads, return_row_sum=True)
    assert row_sum.dtype == torch.float32 and row_sum.shape == (2, heads, n)
    torch.testing.assert_close(out, reference_packed_attention(q, k, v, heads), atol=0, rtol=0)
    bf = torch.bfloat16
    qs = (q * (1.4426950408889634 / math.sqrt(d))).to(bf).float().reshape(2, n, heads, d)
    kh = k.to(bf).float().reshape(2, n, heads, d)
    s = torch.einsum("bnhd,bmhd->bhnm", qs, kh)
    w = torch.exp2(torch.clamp(s, -100.0, 100.0))
    np.testing.assert_allclose(row_sum.numpy(), w.double().sum(-1).numpy(), rtol=1e-5)


def test_plain_version_extreme_logits_stay_finite():
    q, k, v = _qkv(2, 64, 128, seed=3)
    out = reference_packed_attention(torch.from_numpy(q * 1e3), torch.from_numpy(k * 1e3),
                                     torch.from_numpy(v), 8)
    assert torch.isfinite(out).all()


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(3, 32, 64, seed=4))
    before = packed_attention.launches
    out = packed_attention(q, k, v, 2)
    assert packed_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, reference_packed_attention(q, k, v, 2), atol=0, rtol=0)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_wrapper_raises_off_the_cpu_instead_of_falling_back():
    q = torch.empty(2, 16, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        packed_attention(q, q, q, 2)


def test_einsum_path_matches_jax_xla_route():
    """The plain einsum path (fp32 verification mode) against
    the JAX layer's XLA formula, fp32 at 2e-5."""
    q, k, v = _qkv(2, 64, 96, seed=5)
    heads, d = 3, 32

    def jax_path(q, k, v):
        split = lambda t: t.reshape(2, 64, heads, d).transpose(0, 2, 1, 3)  # noqa: E731
        s = jnp.einsum("bhnd,bhmd->bhnm", split(q), split(k), precision="highest") / math.sqrt(d)
        w = jax.nn.softmax(s, axis=-1)
        o = jnp.einsum("bhnm,bhmd->bhnd", w, split(v), precision="highest")
        return o.transpose(0, 2, 1, 3).reshape(2, 64, heads * d)

    ref = np.asarray(jax.jit(jax_path)(q, k, v))
    got = reference_attention(*(torch.from_numpy(t) for t in (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("N,C,heads,dtype,route", [
    (1024, 256, 8, torch.bfloat16, "kernel"),
    (1024, 128, 8, torch.bfloat16, "kernel"),
    (256, 384, 8, torch.bfloat16, "kernel"),
    (16, 512, 8, torch.bfloat16, "kernel"),
    (1024, 384, 1, torch.bfloat16, "flash"),   # VAE mid-block, d=384
    (1024, 256, 8, torch.float32, "plain"),    # verification mode
    (24, 128, 8, torch.bfloat16, "plain"),     # N not a multiple of 16
    (64, 40, 2, torch.bfloat16, "plain"),      # d=20
])
def test_site_route(N, C, heads, dtype, route):
    assert ops.site_route(N, C, heads, dtype) == route


def test_record_sites_logs_only_inside_the_block():
    ops.log_site(1, 16, 64, 2, "kernel")
    with ops.record_sites() as log:
        ops.log_site(2, 64, 128, 8, "kernel")
    ops.log_site(3, 16, 64, 2, "plain")
    assert log == [(2, 64, 128, 8, "kernel")]


def test_library_name_follows_the_source_and_the_headers(tmp_path, monkeypatch):
    """A kernel's library is named by a digest of its source, every header
    beside it and the flags, so an edit to a shared header rebuilds: the
    name changes with the source, with a header, and with a new header, and
    not otherwise."""
    from image_diffusion_torch.ops import build

    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("a")
    assert first == build.library_path("a") and first.parent == build.BUILD_DIR
    assert first.name.startswith("liba-") and first.suffix == ".so"
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = build.library_path("a")
    (tmp_path / "other.cuh").write_text("")
    third = build.library_path("a")
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert len({first, second, third, build.library_path("a")}) == 4
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-DX",))
    assert build.library_path("a") not in {first, second, third}


def test_first_build_is_safe_under_threads(tmp_path, monkeypatch):
    """Two threads building one source together (a server's warm-up and
    its worker on a fresh machine) start one compile, and no temporary
    file is left; loading waits for the same lock.  A fake nvcc counts its
    runs and writes its output after a pause."""
    import threading

    from image_diffusion_torch.ops import build

    count = tmp_path / "count"
    (tmp_path / "bin").mkdir()
    fake = tmp_path / "bin" / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo run >> {count}\n"
                    "sleep 0.5\n"
                    'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
                    'echo lib > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    results, errors = [], []

    def call():
        try:
            results.append(build.build(["packed_attention"]))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(results) == 2 and results[0] == results[1]
    assert count.read_text().splitlines() == ["run"]
    assert [p.name for p in (tmp_path / "out").iterdir()] == [results[0][0].name]
    assert results[0][0].read_text() == "lib\n"


def test_packed_kernels_share_one_header():
    from image_diffusion_torch.ops import build

    assert (build.CSRC / "packed_common.cuh").exists()
    for name in ("packed_attention", "packed_attention_bwd", "flash_attention"):
        assert '#include "packed_common.cuh"' in (build.CSRC / f"{name}.cu").read_text()


def test_forward_wgmma_kernel_has_one_block_shape():
    """No compile-time switch picks the warpgroups of a block: the forward's
    wgmma kernel is built with two, the sources say which sites take it."""
    from image_diffusion_torch.ops import build

    for name in ("packed_attention", "packed_attention_bwd"):
        assert "#ifndef" not in (build.CSRC / f"{name}.cu").read_text()
    assert "constexpr int kWarpgroups = 2;" in (build.CSRC / "packed_attention.cu").read_text()


PTXAS = """ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__x12wg_dq_kernelILi32ELi2EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__x12wg_dq_kernelILi32ELi2EEEvPKf
    0 bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__x11dkdv_kernelILi64ELi4EEEvPKf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 27904 bytes smem
"""


@pytest.mark.parametrize("stores,loads", [(0, 0), (8, 0), (16, 24)])
def test_chip_smoke_reads_registers_and_spills_from_ptxas(stores, loads):
    """Phase 2 of chip_smoke.py fails a build that spills: it reads each
    kernel's registers and the spill bytes of all kernels from ptxas'
    verbose output."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    entries, spilled = chip_smoke.ptxas_summary(PTXAS.format(stores=stores, loads=loads))
    assert spilled == stores + loads
    assert entries == [f"wg_dq_kernel<32,2> 168 registers, spill stores/loads {stores}/{loads} B",
                       "dkdv_kernel<64,4> 128 registers, spill stores/loads 0/0 B"]
    assert chip_smoke.ptxas_summary("") == ([], 0)
