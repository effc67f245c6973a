"""The torch port's configuration, checkpoint codec and import isolation,
held against the JAX package."""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core import checkpoint as jckpt
from image_diffusion_tpu.core import config as jcfg
from image_diffusion_torch.core import checkpoint as tckpt
from image_diffusion_torch.core import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# keys of the port alone (core/config.py), left out of `to_dict` at their defaults
PORT_ONLY = {"layout", "latent_scale", "clip_denoised"}


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_configs_match_jax(path):
    """Both packages read every config alike.  A config only the port reads
    (`denoiser: dit`) may set the port's own keys, which the JAX package
    has not; the rest of its dicts still agree."""
    jraw, traw = jcfg.parse_config(path), tcfg.parse_config(path)
    assert jraw == traw
    port_only = PORT_ONLY if traw.get("denoiser") == "dit" else set()

    def shared(d):
        return {k: v for k, v in d.items() if k not in port_only}

    for jcls, tcls in ((jcfg.UNetArch, tcfg.UNetArch), (jcfg.ScheduleConfig, tcfg.ScheduleConfig)):
        assert jcfg._build(jcls, jraw).to_dict() == shared(tcfg._build(tcls, traw).to_dict())
    if "bottleneck" in jraw:
        assert (jcfg._build(jcfg.VAEArch, jraw).to_dict()
                == tcfg._build(tcfg.VAEArch, traw).to_dict())


def test_precision_policy():
    assert tcfg.resolve_precision("fp16") is torch.bfloat16
    assert tcfg.resolve_precision("bf16") is torch.bfloat16
    assert tcfg.resolve_precision("fp32") is torch.float32
    with pytest.raises(ValueError):
        tcfg.resolve_precision("fp8")


def _tree(rng):
    return {
        "params": {
            "w32": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "w16": rng.standard_normal((7,)).astype(np.float16),
            "ints": np.arange(-5, 300, dtype=np.int32),
            "bytes": rng.integers(0, 256, (2, 3, 4), dtype=np.uint8),
            "big": rng.standard_normal((300, 300)).astype(np.float32),  # ext32 payload
            "scalar": np.full((), 0.5, np.float32),
        },
        "meta": {"name": "x" * 40, "n": [0, 127, 128, 255, 65536, -1, -33, -200, 2**40],
                 "f": 1.5, "none": None, "t": True, "f2": False,
                 "many": {str(i): i for i in range(20)}},
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_checkpoint_reads_jax_written_file(tmp_path):
    tree = _tree(np.random.default_rng(0))
    del tree["meta"]  # flax stores leaves as arrays: parameter trees only
    path = str(tmp_path / "j.ckpt")
    jckpt.save_checkpoint(path, architecture={"a": [1, 2]}, epoch=3, **tree)
    jtrees, jmeta = jckpt.load_checkpoint(path)
    ttrees, tmeta = tckpt.load_checkpoint(path)
    assert jmeta == tmeta
    _assert_tree_equal(jtrees, ttrees)


def test_checkpoint_written_by_port_loads_in_jax(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = str(tmp_path / "t.ckpt")
    tckpt.save_checkpoint(path, architecture={"a": 1}, epoch=None, **tree)
    jtrees, jmeta = jckpt.load_checkpoint(path)
    assert jmeta == {"architecture": {"a": 1}, "epoch": None, "trees": ["meta", "params"]}
    _assert_tree_equal(tree, jtrees)
    # a flax parameter tree round-trips into a model's template
    template = jax.tree.map(jnp.asarray, tree["params"])
    restored = jckpt.restore_into(template, jtrees["params"])
    for k in tree["params"]:
        np.testing.assert_array_equal(np.asarray(restored[k]), tree["params"][k])


def test_msgpack_codec_matches_library():
    rng = np.random.default_rng(2)
    obj = {"s": "é" * 300, "b": bytes(range(256)) * 300, "l": list(range(20)),
           "i": [-2**63, 2**64 - 1, -129, -32769], "d": 3.25}
    assert msgpack.unpackb(tckpt.packb(obj), raw=False, strict_map_key=False) == obj
    assert tckpt.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj
    arr = rng.standard_normal((4, 4)).astype(np.float32)
    with pytest.raises(TypeError):
        tckpt.packb({"x": arr.astype(np.float64)})
    with pytest.raises(ValueError):
        tckpt.unpackb(msgpack.packb(msgpack.ExtType(5, b"xx")))


def test_isolation_from_jax_in_a_subprocess():
    """Every module of the port, and chip_smoke.py, import neither JAX,
    flax, the JAX package, tools/, msgpack, yaml, matplotlib nor tqdm.
    torch itself may load tqdm (torch.hub does when it is installed), so
    only modules that appear after `import torch` count."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import numpy, torch
before = set(sys.modules)
import image_diffusion_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
banned = ("jax", "flax", "image_diffusion_tpu", "tools", "msgpack", "yaml", "matplotlib", "tqdm")
assert not any(n.split(".")[0] in banned[:-1] for n in before), "torch loaded a banned module"
bad = sorted(n for n in set(sys.modules) - before if n.split(".")[0] in banned)
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("image_diffusion_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_raises_without_a_card():
    from image_diffusion_torch.core import resolve_device
    from image_diffusion_torch.models import build_unet

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_unet(tcfg.UNetArch(channels=(16, 32), mid_channels=(32, 32), time_dim=32,
                                 num_res_layers=1, num_heads=2, num_groups=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
