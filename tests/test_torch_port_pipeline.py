"""The port's pipeline on a tiny bundle written by the JAX package: the
ancestral sampler fed the noise JAX draws, the uint8 output, and a bundle
written by the port read back by JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core.config import ScheduleConfig as JSched
from image_diffusion_tpu.core.config import UNetArch as JUNetArch
from image_diffusion_tpu.core.config import VAEArch as JVAEArch
from image_diffusion_tpu.core.plotting import to_uint8 as jax_to_uint8
from image_diffusion_tpu.models import build_unet as jbuild_unet
from image_diffusion_tpu.models import build_vae as jbuild_vae
from image_diffusion_tpu.pipelines.diffusion import DiffusionPipeline as JPipeline
from image_diffusion_torch.pipelines import DiffusionPipeline, to_uint8

UNET_TINY = dict(z_dim=3, channels=(16, 32, 32), mid_channels=(32, 32), time_dim=32,
                 num_res_layers=1, num_heads=2, num_groups=8, num_classes=3)
VAE_TINY = dict(in_channels=3, channels=(16, 32), z_dim=3, enc_num_res_blocks=1,
                dec_num_res_blocks=1, attn_resolutions=(32,), num_heads=2,
                init_resolution=32, num_groups=8)
# fp32 on both sides through T UNet calls, the VAE decode and the CFG
# combination: agreement to fp32 reassociation noise, amplified by the
# guidance scale (up to 4 here) and the 1/sqrt(acp) steps of the sampler
ATOL = 5e-4


def make_jax_pipeline(num_steps, bottleneck="kl", seed=0):
    vae_kw = dict(VAE_TINY)
    if bottleneck == "vq":
        vae_kw.update(bottleneck="vq", codebook_size=32, codebook_beta=0.25, codebook_gamma=0.99)
    vae_arch, unet_arch = JVAEArch(**vae_kw), JUNetArch(**UNET_TINY)
    vae, unet = jbuild_vae(vae_arch, jnp.float32), jbuild_unet(unet_arch, jnp.float32)
    k1, k2 = jax.random.split(jax.random.key(seed))
    x = jnp.zeros((1, 32, 32, 3))
    vae_vars = jax.jit(lambda: vae.init({"params": k1}, x, sample=False))()
    lat = jnp.zeros((1, 16, 16, 3))
    unet_vars = jax.jit(lambda: unet.init(k2, lat, jnp.zeros((1,), jnp.int32),
                                          jnp.zeros((1,), jnp.int32)))()
    return JPipeline(vae_arch, vae_vars, unet_arch, unet_vars,
                     JSched(num_steps=num_steps), "a,b,c", dtype=jnp.float32)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    jpipe = make_jax_pipeline(num_steps=8)
    path = str(tmp_path_factory.mktemp("bundle") / "tiny.ckpt")
    jpipe.to_checkpoint(path)
    return jpipe, path


def test_ddpm_with_jax_step_noise_matches(bundle):
    """The grid of JAX's `sample(seed=5)`: x_init = normal(key), step noise
    normal(fold_in(fold_in(key, 1), t)), both handed to the port."""
    jpipe, path = bundle
    scales = [1.0, 4.0]
    ref = np.array(jpipe.sample(scales, seed=5, sampler="ddpm"))

    key = jax.random.key(5)
    B = 3 * len(scales)
    x_init = np.array(jax.random.normal(key, (B, 16, 16, 3), jnp.float32))
    key1 = jax.random.fold_in(key, 1)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key1, t), x_init.shape,
                                                   jnp.float32)) for t in range(7, -1, -1)])

    pipe = DiffusionPipeline.from_checkpoint(path, dtype=torch.float32, device="cpu")
    labels = np.tile(np.arange(3), len(scales))
    cfg = np.repeat(np.asarray(scales, np.float32), 3)
    got = pipe.sample_batch(labels, cfg, x_init, sampler="ddpm", noise=noise)
    assert got.shape == (B, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)

    # uint8 output: the same run converted in to_uint8's op order, and the
    # JAX package's host conversion of its own images within one level
    u8 = pipe.sample_batch(labels, cfg, x_init, sampler="ddpm", noise=noise, output="uint8")
    assert u8.dtype == torch.uint8
    torch.testing.assert_close(u8, to_uint8(got), atol=0, rtol=0)
    diff = np.abs(u8.numpy().astype(int) - jax_to_uint8(ref).astype(int))
    assert diff.max() <= 1
    np.testing.assert_array_equal(to_uint8(torch.from_numpy(ref)).numpy(), jax_to_uint8(ref))


def test_port_bundle_reads_back_in_jax(bundle, tmp_path):
    jpipe, path = bundle
    pipe = DiffusionPipeline.from_checkpoint(path, dtype=torch.float32, device="cpu")
    out = str(tmp_path / "port.ckpt")
    pipe.to_checkpoint(out)
    back = JPipeline.from_checkpoint(out, dtype=jnp.float32)
    assert back.unet_arch == jpipe.unet_arch and back.vae_arch == jpipe.vae_arch
    assert back.schedule_cfg == jpipe.schedule_cfg and back.classes == jpipe.classes
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.unet_variables),
                 jax.tree.map(np.asarray, jpipe.unet_variables))
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, back.vae_variables),
                 jax.tree.map(np.asarray, jpipe.vae_variables))


def test_sample_grid_layout_and_seed():
    """`sample` gives classes x scales rows, scale-major, and is a pure
    function of its seed."""
    jpipe = make_jax_pipeline(num_steps=4)
    from image_diffusion_torch.compat.from_jax import unet_state_dict, vae_state_dict
    from image_diffusion_torch.core.config import ScheduleConfig, UNetArch, VAEArch

    pipe = DiffusionPipeline(VAEArch(**VAE_TINY), vae_state_dict(jpipe.vae_variables),
                             UNetArch(**UNET_TINY), unet_state_dict(jpipe.unet_variables["params"]),
                             ScheduleConfig(num_steps=4), "a,b,c", dtype=torch.float32,
                             device="cpu")
    assert pipe.latent_shape == (16, 16, 3)
    a = pipe.sample([1.0, 2.0], seed=3, sampler="dpm", num_inference_steps=3)
    b = pipe.sample([1.0, 2.0], seed=3, sampler="dpm", num_inference_steps=3)
    assert a.shape == (6, 32, 32, 3)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="noise"):
        pipe.sample_batch([0], [1.0], torch.zeros(1, 16, 16, 3), sampler="ddpm")
    with pytest.raises(ValueError):
        pipe.sample_batch([0], [1.0], torch.zeros(1, 16, 16, 3), sampler="euler")
