"""The port's LP geometry and configs against the JAX reference: exact.

Plans, blend weights, normalizers, rotation schedules and configs are
framework-free copies in ``repro_torch``; they must stay EQUAL to the
reference for K 2-8, r in {0, 0.25, 0.5, 1} and all three dims.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import partition as jpart
from repro.core.reconstruct import reconstruct as jreconstruct
from repro.core import schedule as jsched
from repro.core import spmd as jspmd
from repro.core import uniform as juni
from repro.core import weights as jw
from repro_torch import configs as tconfigs
from repro_torch.core import partition as tpart
from repro_torch.core.reconstruct import reconstruct as treconstruct
from repro_torch.core import schedule as tsched
from repro_torch.core import spmd as tspmd
from repro_torch.core import uniform as tuni
from repro_torch.core import weights as tw

EXTENTS = (13, 60, 104)        # WAN 480p latent (T, H, W)
PATCH = (1, 2, 2)


@pytest.mark.parametrize("K", range(2, 9))
@pytest.mark.parametrize("r", [0.0, 0.25, 0.5, 1.0])
def test_plans_weights_normalizers_equal(K, r):
    for dim in range(3):
        args = (EXTENTS[dim], PATCH[dim], K, r, dim)
        for jf, tf in ((jpart.plan_partition, tpart.plan_partition),
                       (jpart.plan_partition_balanced, tpart.plan_partition_balanced)):
            jp, tp = jf(*args), tf(*args)
            assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
            for a, b in zip(jw.partition_weights(jp), tw.partition_weights(tp)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            assert np.array_equal(jw.global_normalizer(jp), tw.global_normalizer(tp))
        ju, tu = juni.plan_uniform(*args), tuni.plan_uniform(*args)
        assert dataclasses.asdict(ju) == dataclasses.asdict(tu)
        assert np.array_equal(ju.normalizer(), tu.normalizer())
        assert juni.expansion_factor(ju) == tuni.expansion_factor(tu)
        assert np.array_equal(jspmd.window_weights(ju), tspmd.window_weights(tu))


@pytest.mark.parametrize("K", range(2, 9))
def test_rotation_schedules_equal(K):
    dims = jsched.usable_dims(EXTENTS, PATCH, K)
    assert dims == tsched.usable_dims(EXTENTS, PATCH, K)
    for n in (1, 4, 7, 20):
        assert jsched.rotation_schedule(n, dims) == tsched.rotation_schedule(n, dims)
    assert jsched.usable_dims((4, 8, 12), PATCH, K) == tsched.usable_dims((4, 8, 12), PATCH, K)
    with pytest.raises(ValueError):
        tsched.rotation_dim(0)


def test_configs_equal():
    j = jconfigs.get_config("wan21-dit-1.3b")
    t = tconfigs.get_config("wan21-dit-1.3b")
    tf = {f.name for f in dataclasses.fields(t)}
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        ja = dataclasses.asdict(a)
        assert {k: ja[k] for k in tf} == dataclasses.asdict(b)
    for name, shape in jconfigs.base.VDM_SHAPES.items():
        ja = dataclasses.asdict(shape)
        tb = dataclasses.asdict(tconfigs.get_shape(name))
        assert {k: ja[k] for k in tb} == tb
    with pytest.raises(KeyError):          # an architecture the port has not taken yet
        tconfigs.get_config("whisper-small")


@pytest.mark.parametrize("K,r", [(2, 0.5), (3, 1.0), (4, 0.25)])
def test_reconstruct_matches_reference(K, r):
    """Paper-exact stitching of unequal partitions, f32 (1e-6)."""
    rng = np.random.default_rng(K)
    plan = jpart.plan_partition(13, 1, K, r, 0)
    preds = [rng.normal(size=(2, e - s, 3, 5)).astype(np.float32)
             for s, e in zip(plan.lat_start, plan.lat_end)]
    a = np.asarray(jreconstruct([jnp.asarray(p) for p in preds], plan, axis=1))
    tplan = tpart.plan_partition(13, 1, K, r, 0)
    b = treconstruct([torch.from_numpy(p) for p in preds], tplan, axis=1).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", range(3))
def test_stack_and_blend_windows_match_reference(dim):
    """Uniform windows: stacking is exact; the blend (plain version on the
    CPU) equals the reference's jnp scatter-add to f32 rounding (1e-6)."""
    rng = np.random.default_rng(dim)
    z = rng.normal(size=(2, 13, 8, 12, 4)).astype(np.float32)
    extent = z.shape[dim + 1]
    plan = juni.plan_uniform(extent, PATCH[dim], 3, 0.5, dim)
    tplan = tuni.plan_uniform(extent, PATCH[dim], 3, 0.5, dim)
    jw_ = np.asarray(jspmd.stack_windows(jnp.asarray(z), plan, dim + 1))
    tw_ = tspmd.stack_windows(torch.from_numpy(z), tplan, dim + 1).numpy()
    assert np.array_equal(jw_, tw_)
    preds = rng.normal(size=jw_.shape).astype(np.float32)
    a = np.asarray(jspmd.blend_windows(jnp.asarray(preds), plan, dim + 1, use_kernel=False))
    b = tspmd.blend_windows(torch.from_numpy(preds), tplan, dim + 1).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K", [1, 2, 3, 4, 8])
def test_select_lp_impl_matches_reference(K):
    for tp in (1, 2):
        assert jspmd.select_lp_impl(K, tp) == tspmd.select_lp_impl(K, tp)
