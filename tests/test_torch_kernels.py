"""The port's kernel wrappers and plain versions against the JAX reference.

On the CPU each wrapper in ``repro_torch.kernels.ops`` takes its plain
version; these tests hold that plain version to the reference: plain
flash against ``repro.kernels.ops.flash_attention(interpret=True)`` (the
Pallas kernel run in interpret mode) and ``attention_dense``; plain blend
against ``ref.latent_blend_ref`` and ``blend_windows(use_kernel=False)``
(the Pallas blend does not run on this JAX, so it is not a reference).
The CUDA kernels themselves are tested in ``test_torch_kernels_cuda.py``,
which imports no JAX so that it runs on a GPU host.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spmd as jspmd
from repro.core import uniform as juni
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.core import spmd as tspmd
from repro_torch.core import uniform as tuni
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

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


def test_cpu_tensors_leave_launch_counters_at_zero():
    ops.reset_launch_counts()
    q, k, v, qp, kp, _ = _qkv(1, 8, 8, 2, 2, 16)
    ops.flash_attention(*_t(q, k, v, qp, kp))
    preds = torch.ones((2, 4, 3))
    ops.latent_blend(preds, torch.ones(2, 4), torch.full((6,), 2.0), (0, 2), 4, 6)
    assert ops.launch_counts() == {"flash_attention": 0, "latent_blend": 0}


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((1, 8, 2, 64), device="meta")
    p = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q, p, p)
    with pytest.raises(ValueError, match="no kernel"):
        ops.latent_blend(torch.empty((2, 4, 3), device="meta"), None, None, (0, 2), 4, 6)
    assert ops.launch_counts() == {"flash_attention": 0, "latent_blend": 0}
