"""The port's samplers and CFG against the JAX reference.

Schedules (sigmas, timesteps, step scalars) are numpy in both packages
and must be EQUAL; updates are f32 tensor math held to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import cfg as jcfg
from repro.diffusion import sampler as js
from repro_torch.diffusion import cfg as tcfg
from repro_torch.diffusion import sampler as ts


@pytest.mark.parametrize("num_steps", [1, 4, 20, 60])
@pytest.mark.parametrize("shift", [1.0, 3.0, 5.0])
def test_flow_match_schedule_equal(num_steps, shift):
    a, b = js.FlowMatchEuler(num_steps, shift), ts.FlowMatchEuler(num_steps, shift)
    assert np.array_equal(a.sigmas(), b.sigmas())
    for i in range(1, num_steps + 1):
        assert a.timestep(i) == b.timestep(i)
        sa, sb = a.step_scalars(i), b.step_scalars(i)
        assert type(sa) is type(sb) and sa == sb


@pytest.mark.parametrize("num_steps", [1, 5, 50])
def test_ddim_schedule_equal(num_steps):
    a, b = js.DDIM(num_steps), ts.DDIM(num_steps)
    for i in range(1, num_steps + 1):
        assert a.timestep(i) == b.timestep(i)
        assert a.step_scalars(i) == b.step_scalars(i)


@pytest.mark.parametrize("kind", ["flow", "ddim"])
def test_updates_match_reference(kind):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    pred = rng.normal(size=z.shape).astype(np.float32)
    a_s, b_s = ((js.FlowMatchEuler(6), ts.FlowMatchEuler(6)) if kind == "flow"
                else (js.DDIM(6), ts.DDIM(6)))
    for i in range(1, 7):
        ja = np.asarray(a_s.step(jnp.asarray(z), jnp.asarray(pred), i))
        tb = b_s.step(torch.from_numpy(z), torch.from_numpy(pred), i).numpy()
        np.testing.assert_allclose(ja, tb, rtol=1e-6, atol=1e-6)
        sc = a_s.step_scalars(i)
        ja = np.asarray(a_s.update(jnp.asarray(z), jnp.asarray(pred), sc))
        tb = b_s.update(torch.from_numpy(z), torch.from_numpy(pred), sc).numpy()
        np.testing.assert_allclose(ja, tb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("w", [0.0, 1.0, 5.0, 7.5])
def test_cfg_combine_matches_reference(w):
    rng = np.random.default_rng(1)
    c = rng.normal(size=(3, 7)).astype(np.float32)
    u = rng.normal(size=(3, 7)).astype(np.float32)
    a = np.asarray(jcfg.cfg_combine(jnp.asarray(c), jnp.asarray(u), w))
    b = tcfg.cfg_combine(torch.from_numpy(c), torch.from_numpy(u), w).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    cb = tcfg.cfg_combine(torch.from_numpy(c).bfloat16(), torch.from_numpy(u), w)
    assert cb.dtype == torch.bfloat16
