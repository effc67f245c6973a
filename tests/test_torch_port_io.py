"""The port's model files: per-model files it writes, read by the JAX
package bit for bit, and the original PyTorch implementation's `.pt`
files (built here from the goldens' state dicts), read by both packages
to the goldens' outputs at the fp32 bar of tests/test_torch_parity.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core.config import UNetArch as JUNetArch
from image_diffusion_tpu.core.config import VAEArch as JVAEArch
from image_diffusion_tpu.models import io as jio
from image_diffusion_torch.compat.from_jax import unet_flax_params, vae_flax_variables
from image_diffusion_torch.core.config import UNetArch, VAEArch
from image_diffusion_torch.models import build_unet, build_vae
from image_diffusion_torch.models import io

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
ATOL = 2e-4
# the goldens' tiny configs (tests/test_torch_parity.py)
VAE_TINY = dict(in_channels=3, channels=(16, 32), z_dim=3, enc_num_res_blocks=1,
                dec_num_res_blocks=1, attn_resolutions=(32,), num_heads=2,
                init_resolution=32, num_groups=8)
VQ = dict(bottleneck="vq", codebook_size=32, codebook_beta=0.25, codebook_gamma=0.99)
UNET_TINY = dict(z_dim=3, channels=(16, 32, 32), mid_channels=(32, 32), time_dim=32,
                 num_res_layers=1, num_heads=2, num_groups=8, num_classes=3)


def nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("vq", [False, True], ids=["kl", "vq"])
def test_saved_vae_reads_back_in_jax_bit_equal(tmp_path, vq):
    arch = VAEArch(**VAE_TINY, **(VQ if vq else {}))
    state = build_vae(arch, torch.float32, "cpu", torch.Generator().manual_seed(1)).state_dict()
    path = str(tmp_path / "vae.ckpt")
    io.save_vae(path, arch, state)
    _, variables, jarch = jio.load_vae(path, dtype=jnp.float32)
    assert jarch == JVAEArch(**VAE_TINY, **(VQ if vq else {}))
    assert ("codebook" in variables) == vq
    _assert_trees_equal(jax.tree.map(np.asarray, variables), vae_flax_variables(state))
    # and back into the port: the same state dict
    got_arch, got = io.read_vae(path)
    assert got_arch == arch and set(got) == set(state)
    for k, v in state.items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0)


def test_saved_unet_reads_back_in_jax_bit_equal(tmp_path):
    arch = UNetArch(**UNET_TINY)
    state = build_unet(arch, torch.float32, "cpu", torch.Generator().manual_seed(2)).state_dict()
    path = str(tmp_path / "unet.ckpt")
    io.save_unet(path, arch, state)
    _, variables, jarch = jio.load_unet(path, dtype=jnp.float32)
    assert jarch == JUNetArch(**UNET_TINY)
    _assert_trees_equal(jax.tree.map(np.asarray, variables), {"params": unet_flax_params(state)})


def _original_file(tmp_path, golden, key, arch):
    """A `.pt` file in the original implementation's layout from a golden's
    state dict -> (path, the golden's other arrays)."""
    data = np.load(os.path.join(GOLDENS, golden))
    state = {k[len("state::"):]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("state::")}
    path = str(tmp_path / f"{key}.pt")
    torch.save({"architecture": arch.to_dict(), key: state}, path)
    return path, {k: data[k] for k in data.files if not k.startswith("state::")}


@pytest.mark.parametrize("vq", [False, True], ids=["kl", "vq"])
def test_original_vae_files_load_to_the_golden_outputs(tmp_path, vq):
    arch = VAEArch(**VAE_TINY, **(VQ if vq else {}))
    path, g = _original_file(tmp_path, "vae_vq_tiny.npz" if vq else "vae_kl_tiny.npz", "vae", arch)
    x = nhwc(g["x"])

    model, got_arch = io.load_vae(path, torch.float32, "cpu")
    assert got_arch == arch
    with torch.no_grad():
        z = model.encode(torch.from_numpy(x))[0]
        x_hat = model.decode(z if vq else z[..., :3], quantize=vq)
    np.testing.assert_allclose(x_hat.numpy(), nhwc(g["x_hat"]), atol=ATOL)
    if not vq:
        np.testing.assert_allclose(z.numpy(), nhwc(g["z_raw"]), atol=ATOL)

    # the JAX package reads the same file to the same outputs
    jmodel, variables, _ = jio.load_vae(path, dtype=jnp.float32)

    @jax.jit
    def roundtrip(v, x):
        z = jmodel.apply(v, x, sample=False, method="encode")[0]
        return z, jmodel.apply(v, z if vq else z[..., :3], quantize=vq, method="decode")

    jz, jx_hat = roundtrip(variables, x)
    np.testing.assert_allclose(np.asarray(jx_hat), nhwc(g["x_hat"]), atol=ATOL)
    if not vq:
        np.testing.assert_allclose(np.asarray(jz), nhwc(g["z_raw"]), atol=ATOL)


def test_original_unet_file_loads_to_the_golden_outputs(tmp_path):
    arch = UNetArch(**UNET_TINY)
    path, g = _original_file(tmp_path, "unet_tiny.npz", "unet", arch)
    x, t, c, mask = nhwc(g["x"]), g["t"], g["c"], g["mask"]

    model, got_arch = io.load_unet(path, torch.float32, "cpu")
    assert got_arch == arch
    with torch.no_grad():
        tx, tt = torch.from_numpy(x), torch.from_numpy(t)
        cond = model(tx, tt, torch.from_numpy(c), torch.from_numpy(mask)).numpy()
        uncond = model(tx, tt).numpy()
    np.testing.assert_allclose(cond, nhwc(g["out_cond"]), atol=ATOL)
    np.testing.assert_allclose(uncond, nhwc(g["out_uncond"]), atol=ATOL)

    jmodel, variables, _ = jio.load_unet(path, dtype=jnp.float32)
    jcond = jax.jit(jmodel.apply)(variables, x, t, c, mask)
    juncond = jax.jit(lambda v, x, t: jmodel.apply(v, x, t))(variables, x, t)
    np.testing.assert_allclose(np.asarray(jcond), nhwc(g["out_cond"]), atol=ATOL)
    np.testing.assert_allclose(np.asarray(juncond), nhwc(g["out_uncond"]), atol=ATOL)
