"""The port's quantized LP wire against the JAX reference, on the CPU.

* ``halo_spec`` equals the reference's schedule for K 2-8, r in
  {0, 0.25, 0.5, 1} and all three dims.
* Every codec of ``CODEC_NAMES`` gives BIT-equal wire payloads, scales,
  decodes and error-feedback state on identical inputs (odd last dims
  for int4 included); bf16 payloads are compared as 16-bit patterns.
* ``simulate_halo_forward`` equals the reference bit for bit, output and
  threaded state, over 3 steps, for every codec, with and without the
  NaN guard, and with one latent row forced to NaN.  The denoiser
  ``w * 0.5`` is exact in both frameworks, so no DiT rounding enters.
* ``blend_windows_coded`` matches the reference's jnp path
  (``use_kernel=False``) within 2e-6: the same products, summed over K
  in another order (one f32 rounding per add on values of magnitude ~3).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.comm import residual as jresidual
from repro.comm import wire as jwire
from repro.core import spmd as jspmd
from repro.core import uniform as juni
from repro.distributed import collectives as jcoll
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import residual as tresidual
from repro_torch.comm import wire as twire
from repro_torch.core import spmd as tspmd
from repro_torch.core import uniform as tuni
from repro_torch.distributed import collectives as tcoll
from repro_torch.kernels import ops

EXTENTS = (13, 30, 52)
PATCH = (1, 2, 2)
BASE_NAMES = ("fp32", "bf16", "int8", "int4")


def _bits(x):
    """Raw bits of a numpy / torch / jax array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_bits_equal(a, b, what=""):
    a, b = np.asarray(a), b.contiguous().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape, (what, a.shape, b.shape)
    nan_a = np.isnan(a) if a.dtype.kind == "f" else np.zeros(a.shape, bool)
    nan_b = np.isnan(b) if b.dtype.kind == "f" else np.zeros(b.shape, bool)
    assert np.array_equal(nan_a, nan_b), what
    assert np.array_equal(_bits(np.where(nan_a, 0, a).astype(a.dtype)),
                          _bits(np.where(nan_b, 0, b).astype(b.dtype))), what


@pytest.mark.parametrize("K", range(2, 9))
@pytest.mark.parametrize("r", [0.0, 0.25, 0.5, 1.0])
def test_halo_spec_equals_reference(K, r):
    for dim in range(3):
        args = (EXTENTS[dim], PATCH[dim], K, r, dim)
        js = jcoll.halo_spec(juni.plan_uniform(*args))
        ts = tcoll.halo_spec(tuni.plan_uniform(*args))
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        assert (js.core_len, js.max_transfer, js.pad) == (ts.core_len, ts.max_transfer, ts.pad)


def _messages(shape, n, seed):
    rng = np.random.default_rng(seed)
    scales = np.array([1.0, 1e-3, 40.0, 0.0][:n], np.float32)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    return x * scales.reshape((n,) + (1,) * len(shape))      # slab 3 (if any) is all zero


@pytest.mark.parametrize("name", BASE_NAMES)
@pytest.mark.parametrize("shape", [(5, 16), (3, 4, 7), (9,)])
def test_base_codec_bit_equal(name, shape):
    """``encode_many`` of N stacked messages equals N reference encodes;
    ``encode`` of one message equals the reference's; decodes and the
    byte accounting match."""
    jc, tc = jcodecs.get_codec(name), tcodecs.get_codec(name)
    assert (jc.bits, jc.meta_bytes, jc.wire_dtype_bytes) == (tc.bits, tc.meta_bytes,
                                                             tc.wire_dtype_bytes)
    n_el = int(np.prod(shape))
    assert jc.wire_bytes(n_el) == tc.wire_bytes(n_el)
    assert jc.wire_elems(n_el, shape[-1]) == tc.wire_elems(n_el, shape[-1])
    x = _messages(shape, 4, seed=len(shape))
    tw_, tm = tc.encode_many(torch.from_numpy(x))
    tdec = tc.decode(tw_, tm, (4,) + shape)
    for n in range(4):
        jw_, jm = jc.encode(jnp.asarray(x[n]))
        _assert_bits_equal(jw_, tw_[n], f"{name} wire {n}")
        assert len(jm) == len(tm)
        for a, b in zip(jm, tm):
            _assert_bits_equal(a, b[n], f"{name} meta {n}")
        _assert_bits_equal(jc.decode(jw_, jm, shape), tdec[n], f"{name} decode {n}")
        ow, om = tc.encode(torch.from_numpy(x[n]))
        _assert_bits_equal(jw_, ow, f"{name} single wire {n}")
        for a, b in zip(jm, om):
            _assert_bits_equal(a, b, f"{name} single meta {n}")
    if name == "int4":
        assert tuple(tw_.shape[1:]) == tcodecs.int4_wire_shape(shape)


@pytest.mark.parametrize("name", [n for n in tcodecs.CODEC_NAMES if n not in BASE_NAMES])
@pytest.mark.parametrize("shape", [(5, 16), (3, 4, 7)])
def test_residual_step_bit_equal(name, shape):
    """One sender and receiver step of every residual codec from nonzero
    state, and the plain EF round trip: wire, scale, new prev/err,
    decoded value."""
    jc, tc = jcodecs.get_codec(name), tcodecs.get_codec(name)
    assert jc.name == tc.name and jc.displaced == tc.displaced and tc.stateful
    assert (jc.bits, jc.meta_bytes) == (tc.bits, tc.meta_bytes)
    x, prev, err, recv = (_messages(shape, 3, seed=s) for s in range(4))
    tw_, tm, tsend, terr = tresidual.residual_encode(
        tc.base, *map(torch.from_numpy, (x, prev, err)))
    thx, trecv = tresidual.residual_decode(tc.base, tw_, tm, torch.from_numpy(recv),
                                           (3,) + shape)
    for n in range(3):
        jw_, jm, jsend, jerr = jresidual.residual_encode(
            jc.base, *map(jnp.asarray, (x[n], prev[n], err[n])))
        _assert_bits_equal(jw_, tw_[n], f"{name} wire")
        _assert_bits_equal(jm[0], tm[0][n], f"{name} scale")
        _assert_bits_equal(jsend, tsend[n], f"{name} prev_send")
        _assert_bits_equal(jerr, terr[n], f"{name} err")
        jhx, jrecv = jresidual.residual_decode(jc.base, jw_, jm, jnp.asarray(recv[n]), shape)
        _assert_bits_equal(jhx, thx[n], f"{name} x_hat")
        _assert_bits_equal(jrecv, trecv[n], f"{name} prev_recv")
        jback, jerr2 = jresidual.ef_roundtrip(jc.base, jnp.asarray(x[n]), jnp.asarray(err[n]))
        tback, terr2 = tresidual.ef_roundtrip(tc.base, torch.from_numpy(x[n]),
                                              torch.from_numpy(err[n]))
        _assert_bits_equal(jback, tback, f"{name} ef back")
        _assert_bits_equal(jerr2, terr2, f"{name} ef err")
    with pytest.raises(TypeError, match="stateful"):
        tc.encode(torch.from_numpy(x[0]))


def test_get_codec_errors_match_reference():
    for bad in ("int2", "displaced:int8", "bf16-residual"):
        with pytest.raises(ValueError) as je:
            jcodecs.get_codec(bad)
        with pytest.raises(ValueError) as te:
            tcodecs.get_codec(bad)
        assert str(je.value) == str(te.value)
    assert tcodecs.get_codec(None).name == "fp32"
    assert tcodecs.get_codec("displaced").name == "displaced:int8-residual"
    assert tcodecs.CODEC_NAMES == jcodecs.CODEC_NAMES


# ------------------------------------------------------------- the mirror
SHAPE = (2, 13, 4, 6, 3)         # (B, T, H, W, C): T dim at the smoke's geometry
AXIS, K = 1, 4                   # cores (0,4) (4,7) (7,10) (10,13), core_pad 4


def _state_leaves(state):
    out = {}
    for key, v in state.items():
        if isinstance(v, dict):
            out.update({f"{key}/{d}": x for d, x in v.items()})
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan_row"])
@pytest.mark.parametrize("nan_guard", [False, True], ids=["unguarded", "guarded"])
@pytest.mark.parametrize("name", tcodecs.CODEC_NAMES)
def test_simulate_halo_forward_bit_equal(name, nan_guard, nan):
    plan = juni.plan_uniform(SHAPE[AXIS], 1, K, 0.5, 0)
    tplan = tuni.plan_uniform(SHAPE[AXIS], 1, K, 0.5, 0)
    spec = tcoll.halo_spec(tplan)
    # rank 2's core is (7, 10): its 4th core row is latent row 10, inside its window
    assert spec.core_len[2] == 3 and spec.core_pad == 4
    z = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    if nan:
        z[1, 5, 2, 3, 1] = np.nan        # inside rank 1's core and its neighbours' windows
    rest = tuple(s for i, s in enumerate(SHAPE) if i != AXIS)
    jc, tc = jcodecs.get_codec(name), tcodecs.get_codec(name)
    js = jwire.init_halo_wire_state(jc, jcoll.halo_spec(plan), rest) if jc.stateful else None
    ts = twire.init_halo_wire_state(tc, spec, rest) if tc.stateful else None
    tables = twire.HaloTables.build(tplan, "cpu")
    jz, tz = jnp.asarray(z), torch.from_numpy(z)
    for step in range(3):
        jo = jwire.simulate_halo_forward(lambda w: w * 0.5, jz, plan, AXIS, jc, js,
                                         nan_guard=nan_guard)
        to = twire.simulate_halo_forward(lambda w: w * 0.5, tz, tplan, AXIS, tc, ts,
                                         nan_guard=nan_guard, tables=tables)
        if tc.stateful:
            (jo, js), (to, ts) = jo, to
            a, b = _state_leaves(js), _state_leaves(ts)
            assert sorted(a) == sorted(b)
            for key in a:
                _assert_bits_equal(a[key], b[key], f"step {step} state {key}")
        _assert_bits_equal(jo, to, f"step {step} output")
        # the guard keeps a NaN row off the wire; without it the NaN spreads
        assert bool(torch.isfinite(to).all()) == (nan_guard or not nan)
        jz, tz = jz - 0.3 * jo, tz - 0.3 * to


def test_nan_guard_falls_back_per_message():
    x = torch.tensor([[1.0, 2.0], [3.0, float("nan")], [5.0, 6.0]])
    stale = torch.full_like(x, 9.0)
    assert torch.equal(twire._finite_rows_or(x, stale)[1], stale[1])
    assert torch.equal(twire._finite_rows_or(x, None)[[0, 2]], x[[0, 2]])
    assert float(twire._finite_rows_or(x, None)[1].abs().max()) == 0.0
    assert torch.equal(twire._finite_or(x, stale), stale)
    assert torch.equal(twire._finite_or(x[[0, 2]], None), x[[0, 2]])


def test_stateful_codec_needs_state():
    plan = tuni.plan_uniform(13, 1, 4, 0.5, 0)
    with pytest.raises(ValueError, match="init_halo_wire_state"):
        twire.simulate_halo_forward(lambda w: w, torch.zeros(SHAPE), plan, AXIS,
                                    "int8-residual")


# --------------------------------------------------------- coded stitch
@pytest.mark.parametrize("name", BASE_NAMES)
@pytest.mark.parametrize("dim", [0, 1, 2])
def test_blend_windows_coded_matches_reference(name, dim):
    rng = np.random.default_rng(dim)
    shape = [2, 9, 10, 12, 3]
    ext = shape[dim + 1]
    plan = juni.plan_uniform(ext, PATCH[dim], 3, 0.5, dim)
    tplan = tuni.plan_uniform(ext, PATCH[dim], 3, 0.5, dim)
    z = rng.normal(size=shape).astype(np.float32)
    preds = np.asarray(jspmd.stack_windows(jnp.asarray(z), plan, dim + 1)) * 1.3 + 0.1
    a = np.asarray(jspmd.blend_windows_coded(jnp.asarray(preds), plan, dim + 1, codec=name,
                                             use_kernel=False))
    ops.reset_launch_counts()
    b = tspmd.blend_windows_coded(torch.from_numpy(preds), tplan, dim + 1, codec=name)
    assert b.dtype == torch.float32 and b.shape == a.shape
    np.testing.assert_allclose(b.numpy(), a, rtol=2e-6, atol=2e-6)
    assert sum(ops.launch_counts().values()) == 0        # CPU: the plain versions
