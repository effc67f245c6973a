"""The port's UNet and VAE: the original PyTorch goldens loaded with a
plain `load_state_dict`, and the tiny models against flax on the same
weights (fp32 at 2e-4; one bf16 comparison at its stated bar)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core import checkpoint as jckpt
from image_diffusion_tpu.core.config import UNetArch as JUNetArch
from image_diffusion_tpu.core.config import VAEArch as JVAEArch
from image_diffusion_tpu.models import UNet as JUNet
from image_diffusion_tpu.models import VAE as JVAE
from image_diffusion_tpu.models import io as jio
from image_diffusion_torch.compat.from_jax import (
    unet_flax_params,
    unet_state_dict,
    vae_flax_variables,
    vae_state_dict,
)
from image_diffusion_torch.core.config import UNetArch, VAEArch
from image_diffusion_torch.models import build_unet, build_vae
from image_diffusion_torch.models.io import load_unet, load_vae
from image_diffusion_torch.models.unet import UNet
from image_diffusion_torch.models.vae import VAE

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
ATOL = 2e-4

UNET_TINY = dict(z_dim=3, channels=(16, 32, 32), mid_channels=(32, 32), time_dim=32,
                 num_res_layers=1, num_heads=2, num_groups=8, num_classes=3)
VAE_TINY = dict(in_channels=3, channels=(16, 32), z_dim=3, enc_num_res_blocks=1,
                dec_num_res_blocks=1, attn_resolutions=(32,), num_heads=2,
                init_resolution=32, num_groups=8)
VQ = dict(bottleneck="vq", codebook_size=32, codebook_beta=0.25, codebook_gamma=0.99)


def _golden(name):
    data = np.load(os.path.join(GOLDENS, name))
    state = {k[len("state::"):]: torch.from_numpy(data[k]) for k in data.files if k.startswith("state::")}
    return state, {k: data[k] for k in data.files if not k.startswith("state::")}


def nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def test_param_counts_at_full_size():
    with torch.device("meta"):
        unet, vae = UNet(UNetArch()), VAE(VAEArch())
    assert sum(p.numel() for p in unet.parameters()) == 60_475_523
    assert sum(p.numel() for p in vae.parameters()) == 36_319_935


def test_unet_golden():
    state, g = _golden("unet_tiny.npz")
    model = build_unet(UNetArch(**UNET_TINY), torch.float32, "cpu")
    model.load_state_dict(state)
    x = torch.from_numpy(nhwc(g["x"]))
    t, c, mask = (torch.from_numpy(g[k]) for k in ("t", "c", "mask"))
    with torch.no_grad():
        cond = model(x, t, c, mask).numpy()
        uncond = model(x, t).numpy()
    np.testing.assert_allclose(cond, nhwc(g["out_cond"]), atol=ATOL)
    np.testing.assert_allclose(uncond, nhwc(g["out_uncond"]), atol=ATOL)


def test_kl_vae_golden():
    state, g = _golden("vae_kl_tiny.npz")
    model = build_vae(VAEArch(**VAE_TINY), torch.float32, "cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        z = model.encode(torch.from_numpy(nhwc(g["x"])))
        x_hat = model.decode(z[..., :3].contiguous())
    np.testing.assert_allclose(z.numpy(), nhwc(g["z_raw"]), atol=ATOL)
    np.testing.assert_allclose(x_hat.numpy(), nhwc(g["x_hat"]), atol=ATOL)


def test_vq_vae_golden():
    state, g = _golden("vae_vq_tiny.npz")
    model = build_vae(VAEArch(**VAE_TINY, **VQ), torch.float32, "cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        x_hat = model.decode(model.encode(torch.from_numpy(nhwc(g["x"]))), quantize=True)
    np.testing.assert_allclose(x_hat.numpy(), nhwc(g["x_hat"]), atol=ATOL)


def _unet_inputs(B=3, res=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, res, res, 3)).astype(np.float32)
    return x, np.array([0, 500, 999][:B], np.int32), np.array([0, 2, 1][:B], np.int32)


def _flax_unet(dtype):
    model = JUNet(**UNET_TINY, dtype=dtype)
    x, t, c = _unet_inputs()
    variables = jax.jit(lambda: model.init(jax.random.key(0), x, t, c))()
    return model, jax.tree.map(np.asarray, variables)


def test_tiny_unet_matches_flax_fp32():
    jmodel, variables = _flax_unet(jnp.float32)
    x, t, c = _unet_inputs()
    mask = np.array([[1.0], [0.0], [1.0]], np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, x, t, c, mask))
    model = build_unet(UNetArch(**UNET_TINY), torch.float32, "cpu")
    model.load_state_dict(unet_state_dict(variables["params"]))
    tx, tt, tc = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c)
    with torch.no_grad():
        out = model(tx, tt, tc, torch.from_numpy(mask))
        # mask 0 is exactly context=None: the 2x-batched CFG identity
        masked = model(tx, tt, tc, torch.zeros(3, 1))
        none = model(tx, tt)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    torch.testing.assert_close(masked, none, atol=0, rtol=0)
    # the flax tree round-trips through the state dict exactly
    back = unet_flax_params(model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, variables["params"])


def test_tiny_unet_matches_flax_bf16():
    """bf16 on both sides: bf16 activations and weights, and the port's
    attention sites take the kernel route (its plain version here) while
    JAX on the CPU takes the einsum route.  Bar: max |diff| <= 5e-2 of
    the output's max |value| (about 12 bf16 ulps at the output scale)."""
    jmodel, variables = _flax_unet(jnp.bfloat16)
    x, t, c = _unet_inputs()
    ref = np.asarray(jax.jit(jmodel.apply)(variables, x, t, c).astype(jnp.float32))
    model = build_unet(UNetArch(**UNET_TINY), torch.bfloat16, "cpu")
    model.load_state_dict(unet_state_dict(variables["params"]))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c))
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 5e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def _assert_state_equal(model, expected):
    state = model.state_dict()
    assert set(state) == set(expected)
    for k, v in expected.items():
        torch.testing.assert_close(state[k], v, atol=0, rtol=0)


def test_load_model_files_written_by_jax(tmp_path):
    """`models.io` reads the JAX package's per-model files and its trainer
    epoch checkpoints (raw params under the model key, the VQ codebook a
    sibling tree) into the same weights."""
    _, unet_vars = _flax_unet(jnp.float32)
    vae_arch = JVAEArch(**VAE_TINY, **VQ)
    vae_vars = jax.tree.map(np.asarray, JVAE(**VAE_TINY, **VQ, dtype=jnp.float32).init(
        {"params": jax.random.key(1)}, np.zeros((1, 32, 32, 3), np.float32), sample=False))
    unet_file, unet_epoch = str(tmp_path / "unet.ckpt"), str(tmp_path / "unet-epoch-00.ckpt")
    vae_file, vae_epoch = str(tmp_path / "vae.ckpt"), str(tmp_path / "vae-epoch-00.ckpt")
    jio.save_unet(unet_file, JUNetArch(**UNET_TINY), unet_vars)
    jckpt.save_checkpoint(unet_epoch, architecture=JUNetArch(**UNET_TINY).to_dict(), epoch=0,
                          unet=unet_vars["params"])
    jio.save_vae(vae_file, vae_arch, vae_vars)
    jckpt.save_checkpoint(vae_epoch, architecture=vae_arch.to_dict(), epoch=0,
                          vae=vae_vars["params"], codebook=vae_vars["codebook"])
    for path in (unet_file, unet_epoch):
        model, arch = load_unet(path, torch.float32, "cpu")
        assert arch == UNetArch(**UNET_TINY)
        _assert_state_equal(model, unet_state_dict(unet_vars["params"]))
    for path in (vae_file, vae_epoch):
        model, arch = load_vae(path, torch.float32, "cpu")
        assert arch == VAEArch(**VAE_TINY, **VQ)
        _assert_state_equal(model, vae_state_dict(vae_vars))


@pytest.mark.parametrize("vq", [False, True], ids=["kl", "vq"])
def test_tiny_vae_matches_flax_fp32(vq):
    arch_kw = dict(VAE_TINY, **(VQ if vq else {}))
    jmodel = JVAE(**arch_kw, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    variables = jax.jit(lambda: jmodel.init({"params": jax.random.key(0)}, x, sample=False))()
    variables = jax.tree.map(np.asarray, variables)
    ref_dec = np.asarray(jax.jit(lambda v, z: jmodel.apply(v, z, vq, method="decode"))(variables, z))
    ref_enc = jax.jit(lambda v, x: jmodel.apply(v, x, sample=False, method="encode"))(variables, x)

    model = build_vae(VAEArch(**arch_kw), torch.float32, "cpu")
    model.load_state_dict(vae_state_dict(variables))
    with torch.no_grad():
        dec = model.decode(torch.from_numpy(z), quantize=vq).numpy()
        enc = model.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(dec, ref_dec, atol=ATOL)
    if not vq:  # KL encode is the raw mean || log_var map
        np.testing.assert_allclose(enc, np.asarray(ref_enc[0]), atol=ATOL)
    back = vae_flax_variables(model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, variables)
