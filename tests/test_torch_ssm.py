"""The port's Mamba2/SSD scan and blocks against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
Stated tolerance for every scan: ``5e-4 + 5e-4 |ref|`` elementwise, the
reference's own SSD tolerance (``tests/test_kernels.py``): f32
throughout, sums in another order.  The Mamba2 block (reduced zamba2
config, f32) is held to 1e-4 + 1e-4 |ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr

SSD_TOL = dict(rtol=5e-4, atol=5e-4)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _scan_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 8.0, size=(h,)).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return x, dt * A[None, None, :], dt, B, C


@pytest.mark.parametrize("factorized", [True, False])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s,chunk", [(64, 16), (37, 16), (100, 32)])
def test_gated_linear_scan_matches_reference(s, chunk, g, factorized):
    args = _scan_inputs(2, s, 4, 8, g, 4, seed=s + g)
    want = np.asarray(jssm.gated_linear_scan(*map(jnp.asarray, args), chunk=chunk,
                                             factorized=factorized))
    got = tssm.gated_linear_scan(*map(torch.from_numpy, args), chunk=chunk,
                                 factorized=factorized)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **SSD_TOL)


MAMBA_SSD_CASES = [      # tests/test_kernels.py:185-189
    (2, 100, 16, 32, 16, 32, 8),
    (1, 64, 8, 16, 8, 16, 8),
    (2, 37, 4, 8, 4, 16, 2),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,hb", MAMBA_SSD_CASES)
def test_plain_mamba_ssd_matches_pallas_interpret_and_oracles(b, s, h, p, n, chunk, hb):
    x, a, dt, B, C = _scan_inputs(b, s, h, p, 1, n, seed=s * 7 + h)
    B, C = B[:, :, 0], C[:, :, 0]
    jargs = [jnp.asarray(v) for v in (x, a, dt, B, C)]
    targs = [torch.from_numpy(v) for v in (x, a, dt, B, C)]
    pallas = np.asarray(jops.mamba_ssd(*jargs, chunk=chunk, head_block=hb, interpret=True))
    oracle = np.asarray(jref.mamba_ssd_ref(*jargs))
    ops.reset_launch_counts()
    plain = ops.mamba_ssd(*targs, chunk=chunk).numpy()
    assert ops.mamba_ssd.launches == 0
    np.testing.assert_allclose(plain, pallas, **SSD_TOL)
    np.testing.assert_allclose(plain, oracle, **SSD_TOL)
    np.testing.assert_allclose(plain, ref.mamba_ssd_ref(*targs).numpy(), **SSD_TOL)
    np.testing.assert_allclose(ref.mamba_ssd_ref(*targs).numpy(), oracle, **SSD_TOL)


def test_plain_mamba_ssd_keeps_the_clip():
    """Decays steep enough that |cum - centre| passes 60 inside a chunk:
    the +-60 clip changes the result, and the port keeps it as the
    reference does (finite, equal to the Pallas kernel)."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 64, 4, 8, 4
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(2.0, 6.0, size=(b, s, h)).astype(np.float32)
    B, C = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    args = (x, a, dt, B, C)
    pallas = np.asarray(jops.mamba_ssd(*map(jnp.asarray, args), chunk=64, head_block=4))
    plain = ops.mamba_ssd(*map(torch.from_numpy, args), chunk=64).numpy()
    exact = ref.mamba_ssd_ref(*map(torch.from_numpy, args)).numpy()   # no clip in it
    assert np.isfinite(plain).all()
    np.testing.assert_allclose(plain, pallas, **SSD_TOL)
    assert np.abs(plain - exact).max() > 1e-2


@pytest.fixture(scope="module")
def mamba_pair():
    cfg = get_config("zamba2-2.7b").reduced()
    jcfg = jget_config("zamba2-2.7b").reduced()
    jp = jssm.mamba2_init(jax.random.PRNGKey(0), jcfg.d_model, jcfg.ssm_state,
                          jcfg.ssm_headdim, jcfg.ssm_expand, jcfg.ssm_conv,
                          jcfg.ssm_groups, jnp.float32)
    # a nonzero conv bias, so the bias path is compared too
    jp["conv"]["b"] = jnp.asarray(np.random.default_rng(1).normal(
        size=jp["conv"]["b"].shape).astype(np.float32) * 0.1)
    tp = ttr._map_tree(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("s", [5, 64, 70])
def test_mamba2_apply_matches_reference(mamba_pair, s):
    cfg, jcfg, jp, tp = mamba_pair
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    want = np.asarray(jssm.mamba2_apply(jp, jnp.asarray(x), jcfg))
    got = tssm.mamba2_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


def test_mamba2_decode_matches_reference(mamba_pair):
    """Four decode tokens from a nonzero cache: outputs and both states."""
    cfg, jcfg, jp, tp = mamba_pair
    rng = np.random.default_rng(7)
    jc = jssm.mamba2_init_cache(2, jcfg)
    jc = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3)
          for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for k in tc:
        assert tuple(tc[k].shape) == tuple(tssm.mamba2_init_cache(2, cfg)[k].shape)
    for step in range(4):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jssm.mamba2_decode(jp, jnp.asarray(x), jc, jcfg)
        to, tc = tssm.mamba2_decode(tp, torch.from_numpy(x), tc, cfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK_TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **BLOCK_TOL)


def test_mamba2_prefill_state_agrees_with_stepped_decode(mamba_pair):
    """The port's chunked prefill and its recurrent decode compute the same
    block output token by token (the scan's two forms agree)."""
    cfg, _, _, tp = mamba_pair
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 20, cfg.d_model))
                         .astype(np.float32))
    full = tssm.mamba2_apply(tp, x, cfg, chunk=16)
    cache = tssm.mamba2_init_cache(1, cfg)
    outs = []
    for t in range(20):
        o, cache = tssm.mamba2_decode(tp, x[:, t:t + 1], cache, cfg)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **BLOCK_TOL)


def test_mamba2_init_matches_reference_layout(mamba_pair):
    cfg, _, jp, _ = mamba_pair
    tp = tssm.mamba2_init(cfg.d_model, cfg.ssm_state, cfg.ssm_headdim,
                          torch.Generator().manual_seed(0), cfg.ssm_expand, cfg.ssm_conv,
                          cfg.ssm_groups, torch.float32, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = {tuple(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(
                  ttr._map_tree(lambda t: t.numpy(), tp))[0]}
    for path, v in flat_j:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        assert flat_t[key].shape == v.shape and flat_t[key].dtype == v.dtype, key
    for name in ("A_log", "D"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]), rtol=1e-6)
    dt0 = np.log1p(np.exp(tp["dt_bias"].numpy()))         # softplus: dt in [1e-3, 0.1]
    assert (dt0 >= 1e-3 * 0.999).all() and (dt0 <= 0.1 * 1.001).all()
