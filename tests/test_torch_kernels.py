"""The port's kernel wrappers and plain versions against the JAX reference.

On the CPU each wrapper in ``repro_torch.kernels.ops`` takes its plain
version; these tests hold that plain version to the reference: plain
flash against ``repro.kernels.ops.flash_attention(interpret=True)`` (the
Pallas kernel run in interpret mode) and ``attention_dense``; plain blend
against ``ref.latent_blend_ref`` and ``blend_windows(use_kernel=False)``
(the Pallas blend does not run on this JAX, so it is not a reference);
plain ``int8_quantize`` bit for bit against the Pallas kernel in
interpret mode and ``IntCodec.encode``; plain ``dequant_blend`` against
the jnp decode-then-blend (the Pallas ``dequant_blend`` does not run on
this JAX either); plain ``guidance_update`` against ``guidance_update_ref``
and the Pallas kernel in interpret mode; plain flash on the positions
that put tile skipping at its edges (``ref.skip_edge_positions``); the
split-and-merge ``ref.flash_decode_plain`` (the decode kernel's
arithmetic) against the plain flash and the Pallas kernel in interpret
mode, and ``ops.decode_split``, its choice of splits.
The CUDA kernels themselves are tested in ``test_torch_kernels_cuda.py``,
which imports no JAX so that it runs on a GPU host.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.core import spmd as jspmd
from repro.core import uniform as juni
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.core import spmd as tspmd
from repro_torch.core import uniform as tuni
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

from _hypothesis_compat import given, settings, st

F32_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 softmax attention, summation order only

FLASH_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window, kv_len
    (2, 40, 40, 4, 4, 16, True, 0, False),
    (2, 40, 56, 4, 2, 16, True, 12, False),
    (1, 24, 64, 4, 1, 32, False, 0, False),
    (2, 32, 48, 4, 2, 16, True, 0, True),
    (2, 33, 33, 2, 2, 16, False, 0, True),
]


def _qkv(B, Sq, Skv, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, D)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    lens = np.array([Skv - 5 * (b + 1) for b in range(B)], np.int32)
    return q, k, v, qp, kp, lens


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_flash_matches_pallas_interpret_and_dense(case):
    B, Sq, Skv, H, KV, D, causal, window, use_len = case
    q, k, v, qp, kp, lens = _qkv(B, Sq, Skv, H, KV, D)
    kv_len = lens if use_len else None
    pallas = np.asarray(jops.flash_attention(
        *map(jnp.asarray, (q, k, v, qp, kp)), causal=causal, window=window,
        kv_len=None if kv_len is None else jnp.asarray(kv_len), interpret=True))
    dense = np.asarray(jattn.attention_dense(
        *map(jnp.asarray, (q, k, v, qp, kp)), causal, window,
        None if kv_len is None else jnp.asarray(kv_len)))
    tq, tk, tv, tqp, tkp = _t(q, k, v, qp, kp)
    out = ops.flash_attention(tq, tk, tv, tqp, tkp, causal=causal, window=window,
                              kv_len=None if kv_len is None else torch.from_numpy(kv_len))
    assert out.dtype == torch.float32 and out.shape == tq.shape
    np.testing.assert_allclose(out.numpy(), pallas, **F32_TOL)
    np.testing.assert_allclose(out.numpy(), dense, **F32_TOL)
    port_dense = tattn.attention_dense(tq, tk, tv, tqp, tkp, causal, window,
                                       None if kv_len is None else torch.from_numpy(kv_len))
    np.testing.assert_allclose(port_dense.numpy(), dense, **F32_TOL)


def test_plain_flash_keeps_dtype_and_zeroes_rows_without_keys():
    """bf16 in, bf16 out (f32 math inside, 1e-2 for the output rounding);
    a query whose every key is padding gets zeros, as the online-softmax
    kernel's ``acc / max(l, 1e-37)`` does."""
    q, k, v, qp, kp, _ = _qkv(1, 8, 8, 2, 2, 16, seed=1)
    tq, tk, tv, tqp, tkp = _t(q, k, v, qp, kp)
    out = ops.flash_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), tqp, tkp,
                              causal=False)
    assert out.dtype == torch.bfloat16
    dense = np.asarray(jattn.attention_dense(*map(jnp.asarray, (q, k, v, qp, kp)), False, 0))
    np.testing.assert_allclose(out.float().numpy(), dense, rtol=2e-2, atol=2e-2)
    tkp_pad = torch.full_like(tkp, ref.INT32_MAX)
    zero = ops.flash_attention(tq, tk, tv, tqp, tkp_pad, causal=False)
    assert float(zero.abs().max()) == 0.0


def _bf16_kernel_emulation(q, k, v, fault):
    """What the bf16 flash kernel computes, unmasked: f32 scores of bf16
    inputs, P rounded to bf16 for P.V, a bf16 output; ``fault`` breaks it
    as a wrong kernel would."""
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))       # (B, H, S, D)
    if fault == "drop_last_tile":
        kf, vf = kf[:, :, :-16], vf[:, :, :-16]
    scale = q.shape[-1] ** -0.5 * (1.1 if fault == "scale_10pct" else 1.0)
    s = torch.matmul(qf, kf.transpose(2, 3)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.bfloat16().float(), vf) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).bfloat16()


@pytest.mark.parametrize("fault", [None, "drop_last_tile", "scale_10pct"])
def test_flash_bf16_tolerance_admits_roundings_and_catches_faults(fault):
    """The bf16 kernel's limit on the card holds for its own two roundings
    and fails a kernel that drops a 16-key last tile or scales 10% off;
    1040 keys = 32 tiles of 32 + 16, at the serving head dim."""
    q, k, v, qp, kp, _ = _qkv(1, 256, 1040, 2, 2, 128, seed=3)
    tq, tk, tv = (x.bfloat16() for x in _t(q, k, v))
    tqp, tkp = _t(np.arange(256, dtype=np.int32)[None], kp)
    plain = ref.flash_attention_ref(tq, tk, tv, tqp, tkp, False, 0)
    limit = ref.flash_bf16_tolerance(tq, tk, tv, tqp, tkp, False, 0, plain)
    err = (_bf16_kernel_emulation(tq, tk, tv, fault).float() - plain.float()).abs()
    assert bool((err <= limit).all()) == (fault is None), float((err / limit).max())


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 40)])
def test_attention_chunked_matches_reference(causal, window):
    """Several kv chunks, the last one short."""
    q, k, v, qp, kp, _ = _qkv(2, 50, 150, 4, 2, 16, seed=2)
    a = np.asarray(jattn.attention_chunked(*map(jnp.asarray, (q, k, v, qp, kp)),
                                           causal, window, kv_chunk=64))
    b = tattn.attention_chunked(*_t(q, k, v, qp, kp), causal, window, kv_chunk=64)
    np.testing.assert_allclose(b.numpy(), a, **F32_TOL)
    c = tattn.attention(*_t(q, k, v, qp, kp), causal, window, kv_chunk=64)
    assert torch.equal(b, c)          # CPU tensors: attention() is attention_chunked


@pytest.mark.parametrize("K,W,E,starts", [(3, 8, 20, (0, 6, 12)), (4, 5, 11, (0, 2, 4, 6)),
                                          (2, 7, 7, (0, 0))])
def test_plain_blend_matches_reference(K, W, E, starts):
    rng = np.random.default_rng(K)
    preds = rng.normal(size=(K, W, 33)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(K, W)).astype(np.float32)
    norm = np.zeros(E, np.float32)
    for kk, s in enumerate(starts):
        norm[s:s + W] += weights[kk]
    norm[norm == 0] = 1.0
    a = np.asarray(jref.latent_blend_ref(jnp.asarray(preds), jnp.asarray(weights),
                                         jnp.asarray(norm), starts, W, E))
    b = ops.latent_blend(*_t(preds, weights, norm), starts, W, E)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim,K,r", [(0, 2, 0.5), (1, 3, 1.0), (2, 4, 0.25)])
def test_blend_windows_matches_reference_engine(dim, K, r):
    rng = np.random.default_rng(dim)
    shape = (2, 8, 8, 12, 4)
    patch = (1, 2, 2)
    plan = juni.plan_uniform(shape[dim + 1], patch[dim], K, r, dim)
    tplan = tuni.plan_uniform(shape[dim + 1], patch[dim], K, r, dim)
    wshape = list(shape)
    wshape[dim + 1] = plan.window
    preds = rng.normal(size=(K, *wshape)).astype(np.float32)
    a = np.asarray(jspmd.blend_windows(jnp.asarray(preds), plan, dim + 1, use_kernel=False))
    b = tspmd.blend_windows(torch.from_numpy(preds), tplan, dim + 1)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)


NO_LAUNCHES = {"flash_attention": 0, "flash_attention_sm90": 0, "flash_decode": 0,
               "flash_attention_bwd": 0, "flash_attention_bwd_sm90": 0,
               "flash_attention_bwd_f32": 0, "latent_blend": 0, "int8_quantize": 0,
               "dequant_blend": 0, "mamba_ssd": 0, "mamba_ssd_bwd": 0, "mamba_ssd_wide": 0,
               "mamba_ssd_wide_bwd": 0, "guidance_update": 0}


def test_cpu_tensors_leave_launch_counters_at_zero():
    ops.reset_launch_counts()
    q, k, v, qp, kp, _ = _qkv(1, 8, 8, 2, 2, 16)
    ops.flash_attention(*_t(q, k, v, qp, kp))
    preds = torch.ones((2, 4, 3))
    ops.latent_blend(preds, torch.ones(2, 4), torch.full((6,), 2.0), (0, 2), 4, 6)
    wire, scales = ops.int8_quantize(preds)
    ops.dequant_blend(wire, scales, torch.ones(2, 4), torch.full((6,), 2.0), (0, 2), 4, 6)
    ops.mamba_ssd(torch.ones((1, 5, 2, 4)), -torch.ones((1, 5, 2)), torch.ones((1, 5, 2)),
                  torch.ones((1, 5, 3)), torch.ones((1, 5, 3)), chunk=4)
    ops.mamba_ssd_bwd(torch.ones((1, 5, 2, 4)), -torch.ones((1, 5, 2)), torch.ones((1, 5, 2)),
                      torch.ones((1, 5, 3)), torch.ones((1, 5, 3)), torch.ones((1, 5, 2, 4)),
                      None, chunk=4)
    q, k, v, qp, kp, _ = _qkv(1, 8, 8, 2, 2, 128)
    ops.flash_attention_sm90(*(t.bfloat16() for t in _t(q, k, v)), *_t(qp, kp))
    q, k, v, qp, kp, lens = _qkv(2, 1, 40, 2, 2, 80)
    ops.flash_decode(*(t.bfloat16() for t in _t(q, k, v)), *_t(qp, kp),
                     kv_len=torch.from_numpy(lens))
    ops.guidance_update(preds, preds, preds, 5.0, -0.02)
    assert ops.launch_counts() == NO_LAUNCHES


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((1, 8, 2, 64), device="meta")
    p = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q, p, p)
    with pytest.raises(ValueError, match="no kernel"):
        ops.latent_blend(torch.empty((2, 4, 3), device="meta"), None, None, (0, 2), 4, 6)
    with pytest.raises(ValueError, match="no kernel"):
        ops.int8_quantize(torch.empty((2, 4, 3), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ops.dequant_blend(torch.empty((2, 4, 3), dtype=torch.int8, device="meta"), None,
                          None, None, (0, 2), 4, 6)
    with pytest.raises(ValueError, match="no kernel"):
        ops.mamba_ssd(torch.empty((1, 8, 2, 16), device="meta"), None, None, None, None)
    z = torch.empty((2, 4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.guidance_update(z, z, z, 5.0, -0.02)
    assert ops.launch_counts() == NO_LAUNCHES


def _codec_codes(x, qmax):
    """The reference codec's codes and scale of one slab: int8 directly,
    the int4 codes unpacked from their packed pairs."""
    if qmax == 127:
        w, (s,) = jcodecs.IntCodec(name="int8", bits=8.0).encode(jnp.asarray(x))
        return np.asarray(w), np.asarray(s).reshape(())
    w, (s,) = jcodecs.IntCodec(name="int4", bits=4.0).encode(jnp.asarray(x))
    p = np.asarray(w).astype(np.int32)
    codes = np.stack([((p & 0xF) ^ 8) - 8, (((p >> 4) & 0xF) ^ 8) - 8], axis=-1)
    return codes.reshape(p.shape[:-1] + (-1,))[..., :x.shape[-1]].astype(np.int8), \
        np.asarray(s).reshape(())


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("R,F", [(26, 65), (3, 200), (1, 9)])
def test_plain_int8_quantize_matches_pallas_interpret_and_codec(R, F, qmax):
    """Codes and scale of each slab bit for bit against ``IntCodec.encode``
    (int8, or the int4 codec's codes at qmax 7): slabs of very different
    ranges, one all zero (scale 1e-20 / qmax, zero codes), and values on
    rounding half-way points.  A NaN makes its slab's scale NaN, no other.

    Against the Pallas kernel in interpret mode: bit for bit wherever its
    scale is the IEEE quotient ``amax / qmax``.  On some slabs it is not:
    XLA evaluates the kernel's division by the constant qmax as
    ``amax * (1 / qmax)``, one ulp away, and codes then differ by at most
    one step.  The port follows ``IntCodec.encode``, the serving path's
    encode (``comm/codecs.py``).
    """
    rng = np.random.default_rng(R + qmax)
    x = rng.normal(size=(4, R, F)).astype(np.float32)
    x *= np.array([1.0, 3e-4, 50.0, 0.0], np.float32)[:, None, None]
    amax = np.abs(x[0]).max()
    x[0, 0, :3] = np.float32([2.5, -0.5, 1.5]) * (amax / qmax)
    # slab 2: values a reciprocal multiply would code differently
    planted = ref.plant_halfway_inputs(torch.from_numpy(x)[2], qmax)
    assert planted > 0
    wire, scales = ops.int8_quantize(torch.from_numpy(x), qmax)
    assert wire.dtype == torch.int8 and scales.dtype == torch.float32
    assert wire.shape == x.shape and scales.shape == (4,)
    for n in range(4):
        cw, cs = _codec_codes(x[n], qmax)
        assert np.array_equal(cw, wire[n].numpy())
        assert cs.view(np.uint32) == scales[n].numpy().view(np.uint32)
        pw, ps = jops.int8_quantize(jnp.asarray(x[n]), qmax=qmax, interpret=True)
        pw, ps = np.asarray(pw), np.asarray(ps).reshape(())
        if ps.view(np.uint32) == scales[n].numpy().view(np.uint32):
            assert np.array_equal(pw, wire[n].numpy())
        else:
            a = np.float32(np.abs(x[n]).max())
            assert ps == np.float32(max(a, np.float32(1e-20)) * (np.float32(1) / qmax))
            assert np.abs(pw.astype(int) - wire[n].numpy().astype(int)).max() <= 1
    assert int(wire.abs().max()) <= qmax and int(wire[3].abs().max()) == 0
    reciprocal = torch.round(torch.from_numpy(x[2]) * (1 / scales[2])).clamp(-qmax, qmax)
    assert int((reciprocal.to(torch.int8) != wire[2]).sum()) >= planted
    nan = torch.from_numpy(x.copy())
    nan[1, 0, 0] = float("nan")
    _, nan_scales = ops.int8_quantize(nan, qmax)
    assert torch.isnan(nan_scales).tolist() == [False, True, False, False]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,W,E,starts", [(3, 8, 20, (0, 6, 12)), (4, 5, 11, (0, 2, 4, 6))])
def test_plain_dequant_blend_matches_jnp(K, W, E, starts, out_dtype):
    """Against the jnp decode (``wire * scale``) then ``latent_blend_ref``:
    the same products, 1e-6 for the f32 sum order; a bf16 output within
    one bf16 rounding (2^-8 relative)."""
    rng = np.random.default_rng(K)
    wire = rng.integers(-127, 128, size=(K, W, 33)).astype(np.int8)
    scales = rng.uniform(1e-3, 0.05, size=K).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(K, W)).astype(np.float32)
    norm = np.zeros(E, np.float32)
    for kk, s in enumerate(starts):
        norm[s:s + W] += weights[kk]
    norm[norm == 0] = 1.0
    dq = jnp.asarray(wire).astype(jnp.float32) * jnp.asarray(scales)[:, None, None]
    a = np.asarray(jref.latent_blend_ref(dq, jnp.asarray(weights), jnp.asarray(norm),
                                         starts, W, E))
    b = ops.dequant_blend(*_t(wire, scales, weights, norm), starts, W, E,
                          out_dtype=out_dtype)
    assert b.dtype == out_dtype and b.shape == (E, 33)
    if out_dtype == torch.float32:
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(b.float().numpy(), a, rtol=2.0 ** -8, atol=1e-6)


def _dequant_vs_jnp(K, W, E, starts, F, seed):
    """Plain ``dequant_blend`` (f32 and bf16 out) against the jnp decode
    then ``latent_blend_ref`` on seeded codes, scales and weights."""
    rng = np.random.default_rng(seed)
    wire = rng.integers(-127, 128, size=(K, W, F)).astype(np.int8)
    scales = rng.uniform(1e-3, 0.05, size=K).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(K, W)).astype(np.float32)
    norm = rng.uniform(0.5, 2.0, size=E).astype(np.float32)
    dq = jnp.asarray(wire).astype(jnp.float32) * jnp.asarray(scales)[:, None, None]
    a = np.asarray(jref.latent_blend_ref(dq, jnp.asarray(weights), jnp.asarray(norm),
                                         tuple(starts), W, E))
    for out_dtype in (torch.float32, torch.bfloat16):
        b = ops.dequant_blend(*_t(wire, scales, weights, norm), starts, W, E,
                              out_dtype=out_dtype)
        assert b.dtype == out_dtype and b.shape == (E, F)
        tol = 1e-6 if out_dtype == torch.float32 else 2.0 ** -8
        np.testing.assert_allclose(b.float().numpy(), a, rtol=tol, atol=1e-6)


@settings(max_examples=25, deadline=None)
@given(K=st.integers(1, 32), W=st.integers(1, 12), extra=st.integers(0, 12),
       F=st.integers(1, 70), seed=st.integers(0, 2**16), data=st.data())
def test_plain_dequant_blend_edges_match_jnp(K, W, extra, F, seed, data):
    """Shapes the card's load widths branch on: any F (F % 16 != 0 and F %
    4 != 0 among them), repeated starts, K up to 32, W down to 1; 1e-6 in
    f32 (the same products), one bf16 rounding in bf16."""
    E = W + extra
    starts = data.draw(st.lists(st.integers(0, E - W), min_size=K, max_size=K))
    _dequant_vs_jnp(K, W, E, starts, F, seed)


@pytest.mark.parametrize("K,W,E,starts,F", [
    (4, 8, 13, (0, 2, 5, 5), 49920 // 16 + 6),   # F % 16 == 6, repeated starts
    (3, 6, 10, (0, 2, 4), 1001),                  # F % 4 != 0
    (32, 1, 1, (0,) * 32, 48),                    # K 32 and W 1: one row, 32 windows
])
def test_plain_dequant_blend_named_edges_match_jnp(K, W, E, starts, F):
    _dequant_vs_jnp(K, W, E, starts, F, K + F)


# ------------------------------------------------------------ guidance
GUIDANCE_SHAPES = [(4, 8, 8, 4), (1, 13, 60, 104, 16), (3, 7, 11)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GUIDANCE_SHAPES)
def test_plain_guidance_update_matches_reference_and_pallas(shape, dtype):
    """The reference test's w 5.0 and dt -0.02 on numpy inputs from a seed.
    Stated tolerance: 1e-6 in f32, one bf16 ulp in bf16 (the same f32
    operations, then one rounding to bf16).  Observed: bit-equal to
    ``guidance_update_ref``, which rounds every operation in this order;
    the Pallas kernel in interpret mode is up to 4.8e-7 off in f32 (XLA
    fuses the expression and contracts it), and in bf16 differs on 28 of
    the 1,297,920 elements of the 480p latent: by one bf16 ulp, or by a
    residue below 1e-8 where the exact result cancels to 0."""
    rng = np.random.default_rng(1)
    z, c, u = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jz, jc, ju = (jnp.asarray(x, jdt) for x in (z, c, u))
    want = np.asarray(jref.guidance_update_ref(jz, jc, ju, 5.0, -0.02), np.float32)
    pallas = np.asarray(jops.guidance_update(jz, jc, ju, w=5.0, dt=-0.02, interpret=True),
                        np.float32)
    tz, tc, tu = (torch.tensor(np.asarray(x, np.float32)).to(tdt) for x in (jz, jc, ju))
    ops.reset_launch_counts()
    out = ops.guidance_update(tz, tc, tu, 5.0, -0.02)
    assert ops.launch_counts() == NO_LAUNCHES          # CPU: the plain version
    assert out.dtype == tdt and tuple(out.shape) == shape
    assert torch.equal(out, ref.guidance_update_plain(tz, tc, tu, 5.0, -0.02))
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    else:
        ulp = np.maximum(np.abs(want), np.abs(pallas)) * 2.0 ** -7    # one bf16 ulp
        assert (np.abs(got - want) <= ulp).all()
        assert (np.abs(got - pallas) <= ulp + 1e-8).all()
    assert np.array_equal(got, want)


def test_guidance_update_refuses_mixed_inputs():
    z = torch.zeros((2, 3))
    with pytest.raises(TypeError, match="mixed dtypes"):
        ops.guidance_update(z, z.bfloat16(), z, 5.0, -0.02)
    with pytest.raises(ValueError, match="one shape"):
        ops.guidance_update(z, torch.zeros((3, 2)), z, 5.0, -0.02)


# ---------------------------------------------------------- tile skips
@pytest.mark.parametrize("case", ref.SKIP_EDGE_CASES)
def test_plain_flash_on_skip_edges_matches_reference(case):
    """The plain flash, which the kernels are held to on the card, against
    ``repro.kernels.ref.flash_attention_ref`` at D 128 on the positions
    that put tile skipping at its edges, and against the Pallas kernel in
    interpret mode.  Rows with no attendable key are zero in the port and
    the Pallas kernel; the dense oracle averages all values there (a
    softmax of equal -1e30 scores), so it is compared on the other rows."""
    B, Sq, Skv, H, KV, D = 2, 300, 333, 4, 2, 128
    q, k, v, _, _, _ = _qkv(B, Sq, Skv, H, KV, D, seed=4)
    qp, kp, causal, window = ref.skip_edge_positions(case, B, Sq, Skv, seed=5)
    jargs = [jnp.asarray(x) for x in (q, k, v, qp, kp)]
    dense = np.asarray(jref.flash_attention_ref(*jargs, causal, window))
    pallas = np.asarray(jops.flash_attention(*jargs, causal=causal, window=window,
                                             interpret=True))
    out = ops.flash_attention(*_t(q, k, v, qp, kp), causal=causal, window=window).numpy()
    has_key = ref.attention_mask(*_t(qp, kp), causal, window).any(-1).numpy()    # (B, Sq)
    if case == "causal_first_key":
        assert not has_key[:, :127].any() and has_key[:, 127:].all()
    else:
        assert has_key.all()
    np.testing.assert_allclose(out[has_key], dense[has_key], **F32_TOL)
    np.testing.assert_allclose(out, pallas, **F32_TOL)
    assert float(np.abs(out[~has_key]).max(initial=0.0)) == 0.0


def _live_positions(case, B, Sq, Skv):
    """Positions of a live-tile case: a ``ref.skip_edge_positions`` case, or
    ``random``: per batch row a random permutation of positions with a
    tenth of the keys padded, causal with a window of Skv // 4."""
    if case != "random":
        return ref.skip_edge_positions(case, B, Sq, Skv, seed=5)
    rng = np.random.default_rng(9)
    qp = np.stack([rng.permutation(Skv)[:Sq] for _ in range(B)]).astype(np.int32)
    kp = np.stack([rng.permutation(Skv) for _ in range(B)]).astype(np.int32)
    kp[rng.random(kp.shape) < 0.1] = ref.INT32_MAX
    return qp, kp, True, Skv // 4


@pytest.mark.parametrize("BM,BN", [(128, 128), (64, 32)])
@pytest.mark.parametrize("case", ref.SKIP_EDGE_CASES + ("random",))
def test_live_tiles_plain_covers_the_mask(case, BM, BN):
    """``ref.live_tiles_plain``, the list layout of the wgmma kernel's
    pre-pass, held to ``ref.attention_mask``: every attendable pair lies
    in a listed tile, a tile flagged "every pair attendable" has no
    masked pair, an unlisted tile has no attendable pair; entries in key
    order, -1 after them, the count last."""
    B, Sq, Skv = 2, 300, 333
    qp, kp, causal, window = _live_positions(case, B, Sq, Skv)
    qp, kp = _t(qp, kp)
    lists = ref.live_tiles_plain(qp, kp, BM, BN, causal, window)
    nq, nt = -(-Sq // BM), -(-Skv // BN)
    assert lists.shape == (B, nq, nt + 1) and lists.dtype == torch.int32
    mask = ref.attention_mask(qp, kp, causal, window)
    n_listed = n_clear = 0
    for b in range(B):
        for j in range(nq):
            count = int(lists[b, j, nt])
            entries = lists[b, j, :count].tolist()
            assert lists[b, j, count:nt].tolist() == [-1] * (nt - count)
            tiles = [e >> 1 for e in entries]
            assert tiles == sorted(set(tiles))
            flags = dict(zip(tiles, (e & 1 for e in entries)))
            for t in range(nt):
                block = mask[b, j * BM:(j + 1) * BM, t * BN:(t + 1) * BN]
                if t not in flags:
                    assert not bool(block.any()), (b, j, t)
                elif flags[t] == 0:
                    assert block.shape[1] == BN and bool(block.all()), (b, j, t)
                    n_clear += 1
            n_listed += count
    assert n_listed > 0
    if case == "padded_interior":
        assert n_clear > 0          # the unmasked path is reached
    if case == "causal_first_key":
        assert n_listed < B * nq * nt   # some tiles are skipped


def test_flash_live_tiles_on_the_cpu_is_the_plain_version():
    qp, kp, causal, window = ref.skip_edge_positions("permuted", 2, 300, 333, seed=5)
    qp, kp = _t(qp, kp)
    before = ops.launch_counts()
    got = ops.flash_live_tiles(qp, kp, causal=causal, window=window)
    assert torch.equal(got, ref.live_tiles_plain(qp, kp, 128, 128, causal, window))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype,D,q_len,kernel", [
    (torch.bfloat16, 128, 9, "flash_attention_sm90"),       # the video DiT, past 8 queries
    (torch.bfloat16, 128, 3120, "flash_attention_sm90"),
    (torch.bfloat16, 128, 1, "flash_decode"),               # the D-128 LMs' decode step
    (torch.bfloat16, 128, 8, "flash_decode"),
    (torch.bfloat16, 80, 4096, "flash_attention_sm90"),     # the LM prefill
    (torch.bfloat16, 80, 128, "flash_attention_sm90"),      # one full 128-row block
    (torch.bfloat16, 80, 127, "flash_attention"),
    (torch.bfloat16, 80, 1, "flash_decode"),                # the LM decode step
    (torch.bfloat16, 80, 8, "flash_decode"),                # DECODE_MAX_QUERIES
    (torch.bfloat16, 80, 9, "flash_attention"),
    (torch.bfloat16, 64, 1, "flash_decode"),
    (torch.bfloat16, 64, 4096, "flash_attention_sm90"),     # granite's training forward
    (torch.bfloat16, 64, 128, "flash_attention_sm90"),
    (torch.bfloat16, 64, 127, "flash_attention"),
    (torch.float32, 80, 1, "flash_attention"),
    (torch.float32, 128, 4096, "flash_attention"),          # f32: the 3xTF32 kernel
    (torch.float32, 80, 4096, "flash_attention"),
])
def test_flash_kernel_dispatch_rule(dtype, D, q_len, kernel):
    """bf16 at D 64, 80 and 128 with at most ``DECODE_MAX_QUERIES`` (8)
    queries go to the split-KV decode kernel; bf16 at D 128 with more, and
    bf16 at D 64 and 80 with at least ``SM90_MIN_QUERIES`` (128) queries, to
    the wgmma kernel; the rest to flash_attention.cu."""
    assert ops.SM90_MIN_QUERIES == 128 and ops.DECODE_MAX_QUERIES == 8
    assert ops.flash_kernel(dtype, D, q_len) == kernel


@pytest.mark.parametrize("kernel,dtype,D", [("flash_attention_sm90", torch.float32, 128),
                                            ("flash_attention_sm90", torch.float32, 64),
                                            ("flash_attention", torch.bfloat16, 128),
                                            ("flash_decode", torch.float32, 80),
                                            ("flash_decode", torch.bfloat16, 32),
                                            ("flash_mma", torch.bfloat16, 64)])
def test_flash_attention_refuses_a_kernel_not_built_for_the_inputs(kernel, dtype, D):
    """A forced kernel must be built for the dtype and head dim, on the CPU
    as on the card; nothing launches."""
    q, k, v, qp, kp, _ = _qkv(1, 8, 8, 2, 2, D)
    tq, tk, tv = (x.to(dtype) for x in _t(q, k, v))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="not built for|no flash kernel"):
        ops.flash_attention(tq, tk, tv, *_t(qp, kp), kernel=kernel)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype,D,kernel", [(torch.bfloat16, 64, "flash_attention_bwd_sm90"),
                                            (torch.bfloat16, 80, "flash_attention_bwd_sm90"),
                                            (torch.bfloat16, 128, None),
                                            (torch.bfloat16, 32, None),
                                            (torch.float32, 32, "flash_attention_bwd_f32"),
                                            (torch.float32, 64, "flash_attention_bwd_f32"),
                                            (torch.float32, 80, "flash_attention_bwd_f32"),
                                            (torch.float32, 128, "flash_attention_bwd_f32"),
                                            (torch.float32, 48, None)])
def test_backward_routing_by_head_dim(dtype, D, kernel):
    """bf16 at D 64 (granite) and D 80 (Zamba2) go to the wgmma + TMA
    backward (the mma.sync one is reached only by ``kernel=``, as a timing
    twin), f32 at D 32 (the reduced configs'), 64, 80 and 128 to the 3xTF32
    backward, and no backward takes the rest (the autograd route raises for
    them on the card before any launch); a forced kernel must be one of
    ``BWD_KERNELS``."""
    assert ops.bwd_kernel(dtype, D) == kernel
    if kernel is not None:
        assert kernel in ops.BWD_KERNELS and D in ops._BWD_TAKES[kernel][dtype]
    q = torch.zeros((1, 8, 2, D), dtype=dtype)
    p = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward kernel 'flash_mma'"):
        ops.flash_attention_bwd(q, q, q, q, q, None, p, p, kernel="flash_mma")


LSE_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window, padded keys, query offset
    (2, 40, 40, 4, 4, 16, True, 0, 0, 0),
    (2, 40, 56, 4, 2, 16, True, 12, 0, 16),
    (1, 24, 64, 4, 1, 32, False, 0, 9, 40),
    (2, 30, 50, 2, 2, 16, True, 0, 0, -8),          # queries 0 .. 7 attend no key
]


@pytest.mark.parametrize("case", LSE_CASES)
def test_lse_ref_matches_jax_logsumexp_of_masked_scores(case):
    """``ref.flash_attention_lse_ref`` (the log-sum-exp the forward kernels
    write and the backward kernels read) against ``jax.nn.logsumexp`` of
    the reference's scores plus ``_mask_bias``, times log2(e): causal, a
    window, padded keys; a row that attends no key is +inf (the JAX value
    there is the bias, ~-1e30)."""
    import jax

    B, Sq, Skv, H, KV, D, causal, window, pad, off = case
    q, k, _, _, kp, _ = _qkv(B, Sq, Skv, H, KV, D, seed=Sq + Skv)
    qp = np.broadcast_to(np.arange(Sq, dtype=np.int32) + off, (B, Sq)).copy()
    if pad:
        kp[:, -pad:] = ref.INT32_MAX
    G = H // KV
    s = jnp.einsum("bqkgd,bskd->bkgqs", jnp.asarray(q).reshape(B, Sq, KV, G, D),
                   jnp.asarray(k)) / np.sqrt(D)
    s = s + jattn._mask_bias(jnp.asarray(qp), jnp.asarray(kp), causal, window)[:, None, None]
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, Sq) * np.log2(np.e)
    tq, tk, tqp, tkp = _t(q, k, qp, kp)
    got = ref.flash_attention_lse_ref(tq, tk, tqp, tkp, causal, window).numpy()
    empty = ~ref.attention_mask(tqp, tkp, causal, window).any(-1).numpy()   # (B, Sq)
    empty = np.broadcast_to(empty[:, None], got.shape)
    assert got.dtype == np.float32 and got.shape == (B, H, Sq)
    assert bool(np.isposinf(got[empty]).all()) and not np.isinf(got[~empty]).any()
    np.testing.assert_allclose(got[~empty], want[~empty], rtol=1e-5, atol=1e-5)
    assert bool((want[empty] < -1e29).all())
    _, lse = ops.flash_attention(tq, tk, tk, tqp, tkp, causal=causal, window=window,
                                 return_lse=True)
    assert torch.equal(lse, torch.from_numpy(got))


def _lse_kernel_emulation(q, k, fault, tile=128):
    """What the flash forward kernels compute for the log-sum-exp, unmasked:
    f32 scores of bf16 inputs, an online max and sum in base 2 over tiles of
    ``tile`` keys, ``m sl2 + log2 l``; ``fault`` breaks it as a wrong kernel
    would (the sum's log left out, the last tile dropped)."""
    qf, kf = (x.float().transpose(1, 2) for x in (q, k))               # (B, H, S, D)
    sl2 = ref.LOG2E / q.shape[-1] ** 0.5
    s = torch.matmul(qf, kf.transpose(2, 3))
    n = s.shape[-1] - (16 if fault == "drop_last_tile" else 0)
    m = torch.full(s.shape[:-1], -np.inf)
    l = torch.zeros(s.shape[:-1])
    for a in range(0, n, tile):
        t = s[..., a:min(a + tile, n)]
        mx = torch.maximum(m, t.amax(-1))
        l = l * torch.exp2((m - mx) * sl2) + torch.exp2(t * sl2 - (mx * sl2)[..., None]).sum(-1)
        m = mx
    return m * sl2 + (0.0 if fault == "no_log_sum" else torch.log2(l))


@pytest.mark.parametrize("fault", [None, "no_log_sum", "drop_last_tile"])
def test_flash_lse_tolerance_admits_the_kernels_sums_and_catches_faults(fault):
    """The log-sum-exp's limit on the card holds for the kernels' own
    online sum over 128-key tiles and fails one that drops the sum's log or
    a 16-key last tile; 1040 keys at granite's head dim."""
    q, k, _, _, kp, _ = _qkv(1, 256, 1040, 2, 2, 64, seed=4)
    tq, tk = (x.bfloat16() for x in _t(q, k))
    tqp, tkp = _t(np.arange(256, dtype=np.int32)[None], kp)
    plain = ref.flash_attention_lse_ref(tq, tk, tqp, tkp, False, 0)
    limit = ref.flash_lse_tolerance(tq, tk, tqp, tkp, False, 0, plain)
    err = (_lse_kernel_emulation(tq, tk, fault) - plain).abs()
    assert bool((err <= limit).all()) == (fault is None), float((err / limit).max())


def test_return_lse_refuses_the_decode_kernel_and_f32_on_the_card():
    """``flash_decode`` writes no log-sum-exp: forcing it with ``return_lse``
    raises, on the CPU as on the card; nothing launches."""
    q, k, v, qp, kp, _ = _qkv(1, 2, 8, 2, 2, 64)
    tq, tk, tv = (x.bfloat16() for x in _t(q, k, v))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="writes no log-sum-exp"):
        ops.flash_attention(tq, tk, tv, *_t(qp, kp), kernel="flash_decode", return_lse=True)
    out, lse = ops.flash_attention(tq, tk, tv, *_t(qp, kp), return_lse=True)
    assert lse.shape == (1, 2, 2) and lse.dtype == torch.float32
    assert ops.launch_counts() == before


# -------------------------------------------------------- split-KV decode
def _decode_positions(case, B, Sq, Skv, rng):
    """Positions, causal, window and the split of a ``flash_decode_plain``
    case; queries sit at the last positions."""
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    causal, window, split = False, 0, 1024
    if case == "mostly_empty":               # 63 of 4096 slots valid: a decode step
        qp[:] = 62
        kp[:, 63:] = ref.INT32_MAX
    elif case == "causal_window":
        causal, window, split = True, 100, 192
    elif case == "gqa":
        causal, split = True, 128
    elif case == "empty_splits":              # splits 1 .. 6 of 64 keys hold no key
        kp[:, 64:448] = ref.INT32_MAX
        split = 64
    elif case == "ragged_split":              # 1000 keys = 5 x 192 + 40
        kp[:, rng.random(kp.shape[1]) < 0.3] = ref.INT32_MAX
        split = 192
    elif case == "row_without_key":           # batch row 1: every key padded
        kp[1] = ref.INT32_MAX
        split = 128
    return qp, kp, causal, window, split


DECODE_PLAIN_CASES = {
    # case: B, Sq, Skv, H, KV, D
    "mostly_empty": (2, 1, 4096, 4, 4, 16),
    "full_cache": (2, 1, 4096, 4, 4, 16),
    "gqa": (2, 3, 700, 8, 2, 16),
    "causal_window": (2, 4, 600, 4, 4, 32),
    "empty_splits": (2, 2, 500, 4, 2, 16),
    "ragged_split": (1, 5, 1000, 4, 4, 16),
    "row_without_key": (2, 1, 300, 2, 2, 16),
}


@pytest.mark.parametrize("case", sorted(DECODE_PLAIN_CASES))
def test_plain_flash_decode_matches_reference_and_pallas(case):
    """The decode kernel's split-and-merge (``ref.flash_decode_plain``)
    against the plain flash and the Pallas kernel in interpret mode,
    within ``F32_TOL``; a row with no attendable key is zero in all three."""
    B, Sq, Skv, H, KV, D = DECODE_PLAIN_CASES[case]
    q, k, v, _, _, _ = _qkv(B, Sq, Skv, H, KV, D, seed=len(case))
    qp, kp, causal, window, split = _decode_positions(case, B, Sq, Skv,
                                                      np.random.default_rng(3))
    tq, tk, tv, tqp, tkp = _t(q, k, v, qp, kp)
    out = ref.flash_decode_plain(tq, tk, tv, tqp, tkp, causal, window, split)
    assert out.dtype == torch.float32 and out.shape == tq.shape
    plain = ref.flash_attention_ref(tq, tk, tv, tqp, tkp, causal, window)
    pallas = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                             causal=causal, window=window, blk_k=512,
                                             interpret=True))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **F32_TOL)
    np.testing.assert_allclose(out.numpy(), pallas, **F32_TOL)
    empty = ~ref.attention_mask(tqp, tkp, causal, window).any(-1)
    assert bool(empty.any()) == (case == "row_without_key")
    assert float(out[empty].abs().sum()) == 0.0


@pytest.mark.parametrize("split", [64, 100, 4096])
def test_plain_flash_decode_is_the_same_function_at_any_split(split):
    """Splits change only the order of the sums: bf16 in, bf16 out within
    one bf16 rounding of the plain flash."""
    q, k, v, qp, kp, _ = _qkv(2, 2, 333, 4, 2, 16, seed=split)
    tq, tk, tv = (x.bfloat16() for x in _t(q, k, v))
    out = ref.flash_decode_plain(tq, tk, tv, *_t(qp, kp), True, 50, split)
    plain = ref.flash_attention_ref(tq, tk, tv, *_t(qp, kp), True, 50)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), plain.float().numpy(), rtol=2.0 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("Skv,batch_heads,resident,want", [
    (4096, 128, 528, (4, 1024)),      # the Zamba2 decode step: 4 x 32 heads, 4 blocks an SM
    (4096, 4096, 528, (1, 4096)),     # more (batch row, kv head) pairs than resident blocks
    (500, 12, 528, (8, 64)),          # at most one split a 64-key chunk; a short last split
    (63, 1, 528, (1, 64)),
    (0, 4, 528, (1, 64)),
    (65536, 8, 264, (32, 2048)),
])
def test_decode_split_fills_the_card_and_covers_every_key(Skv, batch_heads, resident, want):
    """``ops.decode_split``: as many splits as fill the resident blocks
    once, 64-key multiples, every key in exactly one split, no empty split."""
    splits, split_len = ops.decode_split(Skv, batch_heads, resident)
    assert (splits, split_len) == want
    assert split_len % 64 == 0 and splits * batch_heads <= max(resident, batch_heads)
    assert (splits - 1) * split_len < max(Skv, 1) <= splits * split_len


def _f32_from_bits(*bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


def test_round_tf32_rounds_to_nearest_ties_away_from_zero():
    """``ref.round_tf32`` keeps 10 mantissa bits as ``cvt.rna.tf32.f32``:
    below half an ulp (2^-13 of the f32 mantissa's 23 bits) rounds down,
    half an ulp rounds away from zero whatever the sign, inf and NaN pass."""
    x = _f32_from_bits(0x3F800FFF, 0x3F801000, 0x3F803000, 0xBF801000, 0xBF800FFF,
                       0x7F800000, 0xFF800000, 0x00001000, 0x3FFFF000)
    want = _f32_from_bits(0x3F800000, 0x3F802000, 0x3F804000, 0xBF802000, 0xBF800000,
                          0x7F800000, 0xFF800000, 0x00002000, 0x40000000)
    assert torch.equal(ref.round_tf32(x), want)
    assert torch.isnan(ref.round_tf32(torch.tensor([float("nan")]))).all()
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.uniform(-8, 8, 4096))
                         .astype(np.float32))
    r = ref.round_tf32(v)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - v).abs() <= 2.0 ** -11 * v.abs()).all())


def test_split_tf32_recovers_the_f32_operand():
    """``hi + lo`` of ``ref.split_tf32`` is the f32 operand to within
    2^-22 of its magnitude; both halves are TF32 values."""
    rng = np.random.default_rng(1)
    v = torch.from_numpy((rng.normal(size=8192) * 10.0 ** rng.uniform(-20, 20, 8192))
                         .astype(np.float32))
    hi, lo = ref.split_tf32(v)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -22 * v.double().abs()).all())
    assert not bool(((hi.double() - v.double()).abs() <= 2.0 ** -22 * v.double().abs()).all())


# the f32 flash pair's stated limits on the card (chip_smoke.py: FLASH_F32_TOL,
# LSE_F32_TOL, FLASH_BWD_F32_TOL), |kernel - reference| <= atol + rtol |reference|
FLASH_F32_TOL = dict(rtol=1e-4, atol=1e-4)
LSE_F32_TOL = dict(rtol=1e-4, atol=1e-4)
FLASH_BWD_F32_TOL = dict(rtol=1e-4, atol=1e-4)
TF32_FLASH_CASES = {
    # B, Sq, Skv, H, KV, D, causal, window, padded keys, kv_len
    "d32_causal_gqa": (2, 100, 150, 4, 2, 32, True, 0, 0, False),
    "d32_window16": (2, 90, 130, 4, 4, 32, True, 16, 0, False),
    "d32_padded_kv_len": (2, 70, 140, 4, 2, 32, False, 0, 6, True),
    "d80_causal": (1, 80, 110, 4, 2, 80, True, 0, 0, False),
}


def _tf32_flash_inputs(case):
    """numpy inputs of a TF32_FLASH_CASES case, the positions with kv_len
    folded in (as ``ops.flash_attention`` folds it), and the JAX reference's
    kwargs."""
    B, Sq, Skv, H, KV, D, causal, window, pad, use_len = TF32_FLASH_CASES[case]
    q, k, v, qp, kp, lens = _qkv(B, Sq, Skv, H, KV, D, seed=Sq + D)
    if pad:
        kp[:, -pad:] = ref.INT32_MAX
    kv_len = lens if use_len else None
    kp_eff = kp if kv_len is None else np.where(kp < kv_len[:, None], kp, ref.INT32_MAX)
    return (q, k, v, qp, kp, kp_eff.astype(np.int32), causal, window, kv_len)


def _share(got, want, tol):
    return float(np.max(np.abs(got - want) / (tol["atol"] + tol["rtol"] * np.abs(want))))


@pytest.mark.parametrize("case", sorted(TF32_FLASH_CASES))
def test_flash_attention_tf32_emulation_matches_jax(case):
    """The f32 flash kernel's 3xTF32 arithmetic (``ref.flash_attention_tf32``:
    key tiles of the kernel's width, P split for P.V, each tile's product
    added in f32) within ``FLASH_F32_TOL`` of the Pallas kernel in interpret
    mode and of ``attention_dense``, its log-sum-exp within ``LSE_F32_TOL``
    of ``jax.nn.logsumexp`` of the reference's masked scores (times
    log2(e)); one TF32 pass's share of the limit is printed, not
    asserted."""
    import jax

    q, k, v, qp, kp, kp_eff, causal, window, kv_len = _tf32_flash_inputs(case)
    jl = None if kv_len is None else jnp.asarray(kv_len)
    pallas = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v, qp, kp)), causal=causal,
                                             window=window, kv_len=jl, interpret=True))
    dense = np.asarray(jattn.attention_dense(*map(jnp.asarray, (q, k, v, qp, kp)), causal,
                                             window, jl))
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    s = jnp.einsum("bqkgd,bskd->bkgqs", jnp.asarray(q).reshape(B, Sq, KV, H // KV, D),
                   jnp.asarray(k)) / np.sqrt(D)
    s = s + jattn._mask_bias(jnp.asarray(qp), jnp.asarray(kp), causal, window, jl)[:, None, None]
    want_lse = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, Sq) * np.log2(np.e)
    targs = _t(q, k, v, qp, kp_eff)
    out, lse = ref.flash_attention_tf32(*targs, causal, window)
    assert out.shape == q.shape and out.dtype == torch.float32 and lse.shape == (B, H, Sq)
    for want in (pallas, dense):
        np.testing.assert_allclose(out.numpy(), want, **FLASH_F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **LSE_F32_TOL)
    one, _ = ref.flash_attention_tf32(*targs, causal, window, passes=1)
    print(f"{case}: 1xTF32 share of the limit {_share(one.numpy(), dense, FLASH_F32_TOL):.3g}; "
          f"3xTF32 {_share(out.numpy(), dense, FLASH_F32_TOL):.3g}")


@pytest.mark.parametrize("case", sorted(TF32_FLASH_CASES))
def test_flash_attention_bwd_tf32_emulation_matches_jax_vjp(case):
    """The f32 flash backward's 3xTF32 arithmetic (``ref.
    flash_attention_bwd_tf32``, fed ``ref.flash_attention_tf32``'s output
    and log-sum-exp as the kernel is fed the forward kernel's) within
    ``FLASH_BWD_F32_TOL`` of ``jax.vjp`` of ``attention_dense``, each of dq,
    dk and dv; one TF32 pass's share of the limit is printed, not
    asserted."""
    import jax

    q, k, v, qp, kp, kp_eff, causal, window, kv_len = _tf32_flash_inputs(case)
    jl = None if kv_len is None else jnp.asarray(kv_len)
    dout = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jattn.attention_dense(a, b, c, jnp.asarray(qp),
                                                           jnp.asarray(kp), causal, window, jl),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    tq, tk, tv, tqp, tkp = _t(q, k, v, qp, kp_eff)
    out, lse = ref.flash_attention_tf32(tq, tk, tv, tqp, tkp, causal, window)
    grads = ref.flash_attention_bwd_tf32(tq, tk, tv, out, torch.from_numpy(dout), lse, tqp, tkp,
                                         causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **FLASH_BWD_F32_TOL)
    one = ref.flash_attention_bwd_tf32(tq, tk, tv, out, torch.from_numpy(dout), lse, tqp, tkp,
                                       causal, window, passes=1)
    print(f"{case}: 1xTF32 share of the limit "
          + ", ".join(f"{n} {_share(g.numpy(), w, FLASH_BWD_F32_TOL):.3g}"
                      for n, g, w in zip(("dq", "dk", "dv"), one, want))
          + "; 3xTF32 " + ", ".join(f"{n} {_share(g.numpy(), w, FLASH_BWD_F32_TOL):.3g}"
                                    for n, g, w in zip(("dq", "dk", "dv"), grads, want)))


SSD_TOL = dict(rtol=5e-4, atol=5e-4)   # the reference's own SSD tolerance


def _scan_args(b, s, h, p, n, seed, steep):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a = dt * -rng.uniform(0.5, 8.0, size=(h,)).astype(np.float32)
    if steep:
        a = -rng.uniform(2.0, 6.0, size=(b, s, h)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, a, dt, B, C


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 100, 4, 16, 16, 32), (1, 150, 2, 64, 64, 64)])
def test_mamba_ssd_tf32_emulation_matches_jax_scan(b, s, h, p, n, chunk, steep):
    """The kernel's 3xTF32 arithmetic (``ref.mamba_ssd_tf32``) within the
    reference's SSD tolerance of ``gated_linear_scan(factorized=True)``;
    one TF32 pass's share of that limit is printed, not asserted."""
    from repro.models import ssm as jssm

    x, a, dt, B, C = _scan_args(b, s, h, p, n, seed=s + h + steep, steep=steep)
    want = np.asarray(jssm.gated_linear_scan(
        *map(jnp.asarray, (x, a, dt, B[:, :, None], C[:, :, None])), chunk=chunk,
        factorized=True))
    targs = _t(x, a, dt, B, C)
    got = ref.mamba_ssd_tf32(*targs, chunk=chunk)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SSD_TOL)
    limit = SSD_TOL["atol"] + SSD_TOL["rtol"] * np.abs(want)
    one = ref.mamba_ssd_tf32(*targs, chunk=chunk, passes=1).numpy()
    print(f"1xTF32 share of the limit: {float(np.max(np.abs(one - want) / limit)):.3g}; "
          f"3xTF32: {float(np.max(np.abs(got.numpy() - want) / limit)):.3g}")
