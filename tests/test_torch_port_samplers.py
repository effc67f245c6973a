"""The port's deterministic samplers (DPM-Solver++ 2M, DDIM eta=0) and
the VQ bundle's re-quantizing decode, from the same x_init as the JAX
package's pipeline on a JAX-written bundle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_torch.pipelines import DiffusionPipeline
from test_torch_port_pipeline import ATOL, make_jax_pipeline


@pytest.mark.parametrize("bottleneck,sampler,steps", [
    ("kl", "dpm", 4),
    ("kl", "ddim", 4),
    ("vq", "dpm", 3),
])
def test_sampler_matches_jax(tmp_path, bottleneck, sampler, steps):
    jpipe = make_jax_pipeline(num_steps=20, bottleneck=bottleneck, seed=1)
    path = str(tmp_path / "b.ckpt")
    jpipe.to_checkpoint(path)

    rng = np.random.default_rng(7)
    x_init = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 1], np.int32)
    scales = np.array([1.0, 2.5, 4.0, 0.0], np.float32)
    ref = np.asarray(jpipe.sample_batch(labels, scales, x_init, sampler=sampler,
                                        num_inference_steps=steps, eta=0.0,
                                        key=jax.random.key(0)))

    pipe = DiffusionPipeline.from_checkpoint(path, dtype=torch.float32, device="cpu")
    got = pipe.sample_batch(labels, scales, x_init, sampler=sampler,
                            num_inference_steps=steps, eta=0.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
