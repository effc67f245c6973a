"""Each layer of the torch port against its flax counterpart in fp32, on
the same weights (the flax init carried across) and inputs: <= 2e-4, the
bar the JAX package holds against the original PyTorch code."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.models import layers as J
from image_diffusion_torch.compat.from_jax import _RESIDUAL, _SHORTCUT, _attn, _block, _to_torch
from image_diffusion_torch.models import layers as T

ATOL = 2e-4


def _carry(module, params, entries):
    """Load flax params into a torch module through (flax path, torch
    name, kind) entries; every parameter of the module must be covered."""
    state = {}
    for fp, tp, kind in entries:
        leaves = params
        for p in fp:
            leaves = leaves[p]
        for leaf, val in _to_torch(kind, leaves).items():
            state[f"{tp}.{leaf}".lstrip(".")] = torch.from_numpy(np.array(val, np.float32))
    missing, unexpected = module.load_state_dict(state, strict=False)
    assert not unexpected and set(missing) <= {n for n, _ in module.named_buffers()}
    return module.eval()


def _run(flax_module, torch_module, entries, x, *extra_j, extra_t=()):
    variables = flax_module.init(jax.random.key(0), x, *extra_j)
    ref = np.asarray(jax.jit(flax_module.apply)(variables, x, *extra_j))
    mod = _carry(torch_module, variables["params"], entries)
    xt = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = mod(xt, *extra_t).permute(0, 2, 3, 1).numpy()
    return out, ref


def _x(shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


F32 = jnp.float32


@pytest.mark.parametrize("shift", [0.0, 30.0])
def test_groupnorm(shift):
    """Also at a large mean, where E[x^2]-E[x]^2 cancels."""
    x = _x((2, 8, 8, 32)) + shift
    out, ref = _run(J.GroupNorm(8, F32), T.GroupNorm(8, 32), [(("norm",), "", "norm")], x)
    np.testing.assert_allclose(out, ref, atol=ATOL * (1 + shift))


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 32)])
def test_residual(cin, cout):
    entries = _RESIDUAL + ([_SHORTCUT] if cin != cout else [])
    out, ref = _run(J.Residual(cout, 8, F32), T.Residual(cin, cout, 8), entries, _x((2, 8, 8, cin)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("C,heads", [(32, 2), (64, 4), (48, 1)])
def test_spatial_self_attention(C, heads):
    entries = [(fp, tp.lstrip("."), k) for fp, tp, k in _attn((), "")]
    out, ref = _run(J.SpatialSelfAttention(heads, 8, F32), T.SpatialSelfAttention(C, heads, 8),
                    entries, _x((2, 8, 8, C), seed=C))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_downsample_and_upsample():
    x = _x((2, 8, 8, 16))
    out, ref = _run(J.Downsample(F32), T.Downsample(16), [(("down", "conv"), "down", "conv")], x)
    assert out.shape == (2, 4, 4, 16)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    out, ref = _run(J.Upsample(F32), T.Upsample(16), [(("up_conv", "conv"), "conv", "conv")], x)
    assert out.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_conv_block():
    entries = [(("norm", "norm"), "layers.0", "norm"), (("conv", "conv"), "layers.2", "conv")]
    out, ref = _run(J.ConvBlock(32, 8, F32), T.ConvBlock(16, 32, 8), entries, _x((2, 8, 8, 16)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_time_embedding():
    t = jnp.asarray([0, 1, 17, 999], jnp.int32)
    flax_mod = J.TimeEmbedding(32, F32)
    variables = flax_mod.init(jax.random.key(1), t)
    ref = np.asarray(jax.jit(flax_mod.apply)(variables, t))
    mod = T.TimeEmbedding(32)
    entries = [(("fc1", "dense"), "embeddings.0", "dense"), (("fc2", "dense"), "embeddings.2", "dense")]
    _carry(mod, variables["params"], entries)
    with torch.no_grad():
        out = mod(torch.tensor([0, 1, 17, 999])).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("with_skip", [False, True])
def test_diffusion_block(with_skip):
    x, temb = _x((2, 8, 8, 16), 1), _x((2, 32), 2)
    skip = _x((2, 8, 8, 16), 3)
    cin = 32 if with_skip else 16
    flax_mod = J.DiffusionBlock(32, 2, 2, 8, F32)
    args = (x, temb, skip) if with_skip else (x, temb)
    variables = flax_mod.init(jax.random.key(0), *args)
    ref = np.asarray(jax.jit(flax_mod.apply)(variables, *args))
    mod = T.DiffusionBlock(cin, 32, 2, 2, 8, 32)
    _carry(mod, variables["params"], [(fp, tp.lstrip("."), k) for fp, tp, k in _block((), "", 2)])
    nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        out = mod(nchw(x), torch.from_numpy(np.array(temb)),
                  nchw(skip) if with_skip else None).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_materialize_draws_from_the_generator():
    def build(seed):
        with torch.device("meta"):
            m = T.Residual(16, 32, 8)
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return T.materialize(m, torch.float32, torch.device("cpu"), g)

    a, b, c, z = build(0), build(0), build(1), build(None)
    w = "branch.2.weight"
    torch.testing.assert_close(a.state_dict()[w], b.state_dict()[w], atol=0, rtol=0)
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    assert a.state_dict()[w].abs().max() <= 1 / np.sqrt(16 * 9)
    assert torch.count_nonzero(z.state_dict()[w]) == 0
    torch.testing.assert_close(z.state_dict()["branch.0.weight"], torch.ones(16))
