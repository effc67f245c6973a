"""The torch port's schedule math against the JAX package on the same
numpy inputs (fp32; the tables are cast from the same float64 host math,
so agreement is to fp32 rounding, atol 1e-6 on O(1) values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.ops import schedule as JS
from image_diffusion_torch.ops import schedule as TS

ATOL = 1e-6


def _close(a, b, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=rtol)


@pytest.fixture(params=["linear", "cosine"])
def scheds(request):
    return (JS.make_schedule(50, noise_type=request.param),
            TS.make_schedule(50, noise_type=request.param))


def _inputs(seed, B=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 4, 4, 3)).astype(np.float32)
    eps = rng.standard_normal((B, 4, 4, 3)).astype(np.float32)
    z = rng.standard_normal((B, 4, 4, 3)).astype(np.float32)
    t = np.array([0, 17, 49][:B], np.int32)
    return x, eps, z, t


def test_tables_match(scheds):
    js, ts = scheds
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert ts.num_steps == 50
    with pytest.raises(ValueError):
        TS.make_schedule(10, noise_type="quadratic")


@pytest.mark.parametrize("n", [1, 4, 20, 50])
def test_timesteps_match(n):
    np.testing.assert_array_equal(np.asarray(JS.make_timesteps(50, n)),
                                  TS.make_timesteps(50, n).numpy())


def test_forward_and_posterior_functions(scheds):
    js, ts = scheds
    x, eps, z, t = _inputs(0)
    tx, teps, tz, tt = (torch.from_numpy(a) for a in (x, eps, z, t.astype(np.int64)))
    _close(JS.q_sample(js, x, z, t), TS.q_sample(ts, tx, tz, tt))
    _close(JS.predict_x0(js, x, eps, t), TS.predict_x0(ts, tx, teps, tt))
    _close(JS.posterior_mean(js, x, eps, t), TS.posterior_mean(ts, tx, teps, tt))
    sig = TS.posterior_sigma(ts, tt)
    _close(JS.posterior_sigma(js, t), sig)
    assert sig[0] == 0.0  # t == 0 adds no noise
    for j, r in zip(JS.ddpm_step(js, x, eps, t, z), TS.ddpm_step(ts, tx, teps, tt, tz)):
        _close(j, r)
    # 0-d timestep broadcasts like (B,)
    _close(JS.q_sample(js, x, z, jnp.int32(7)), TS.q_sample(ts, tx, tz, torch.tensor(7)))


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_step(scheds, eta):
    js, ts = scheds
    x, eps, z, t = _inputs(1)
    t_prev = np.array([-1, 9, 30], np.int32)
    args = (torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(t.astype(np.int64)),
            torch.from_numpy(t_prev.astype(np.int64)), torch.from_numpy(z))
    for j, r in zip(JS.ddim_step(js, x, eps, t, t_prev, z, eta), TS.ddim_step(ts, *args, eta)):
        _close(j, r, atol=1e-5)


@pytest.mark.parametrize("h_prev", [-1.0, 0.3])
def test_dpmpp_2m_step(scheds, h_prev):
    js, ts = scheds
    x, eps, x0p, t = _inputs(2)
    t = np.array([40, 17, 5], np.int32)
    t_prev = np.array([20, 5, -1], np.int32)  # the last row takes the final step
    args = (torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(t.astype(np.int64)),
            torch.from_numpy(t_prev.astype(np.int64)), torch.from_numpy(x0p))
    jout = JS.dpmpp_2m_step(js, x, eps, t, t_prev, x0p, jnp.float32(h_prev))
    tout = TS.dpmpp_2m_step(ts, *args, h_prev)
    for j, r in zip(jout, tout):
        _close(j, r, atol=1e-5, rtol=1e-4)
    # the final row is x0 itself; the first-step sentinel is first order
    np.testing.assert_array_equal(tout[0][2].numpy(), tout[1][2].numpy())
