"""The port's CUDA kernels against their plain PyTorch versions, on the card.

No JAX here, so the file runs on a GPU host without it:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -q

Every test is marked ``cuda`` and skips without a CUDA device: a kernel
has no CPU mode.  Inputs are made with numpy from a seed.  Stated
tolerances: bf16 flash elementwise within the bound of its two roundings,
``2^-8 attention(q, k, |v|) + 2^-7 |plain|`` (P to bf16 for the
tensor-core P.V, and the bf16 output; ``ref.flash_bf16_tolerance``),
f32 flash 1e-4 (summation order only); blend, int8 quantize and
dequant-blend exact (the same f32 operations in the same order);
mamba_ssd ``5e-4 + 5e-4 |plain|``, the reference's own SSD tolerance
(f32 throughout, sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import spmd, uniform
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

FLASH_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window, kv_len
    (2, 40, 40, 4, 4, 64, True, 0, False),
    (2, 40, 56, 4, 2, 64, True, 12, False),
    (2, 130, 190, 8, 2, 64, True, 50, True),
    (2, 200, 512, 12, 12, 128, False, 0, False),     # full tiles: the unmasked path
    (1, 333, 200, 12, 12, 128, False, 0, False),     # a short last kv tile
    (2, 96, 160, 4, 4, 128, False, 0, True),         # padding inside the last tiles
    (2, 130, 301, 12, 4, 128, True, 50, True),       # masks, GQA and a 13-key last tile
    (1, 3120, 3120, 2, 2, 128, False, 0, False),     # a T window's length: a 16-key last tile
    (2, 300, 300, 4, 4, 80, True, 0, False),         # Zamba2's head dim: causal prefill
    (2, 130, 301, 8, 2, 80, True, 50, True),         # D 80 with masks, GQA, a short tile
    (3, 1, 500, 4, 4, 80, False, 0, True),           # D 80 decode: one query, kv_len
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, Sq, Skv, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    lens = np.array([Skv - 5 * (b + 1) for b in range(B)], np.int32)
    return [torch.from_numpy(x) for x in (q, k, v, qp, kp, lens)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda_device, dtype, case):
    B, Sq, Skv, H, KV, D, causal, window, use_len = case
    q, k, v, qp, kp, lens = _inputs(B, Sq, Skv, H, KV, D)
    q, k, v = (x.to(cuda_device, dtype) for x in (q, k, v))
    qp, kp, lens = (x.to(cuda_device) for x in (qp, kp, lens))
    kv_len = lens if use_len else None
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window, kv_len=kv_len)
    assert ops.flash_attention.launches == before + 1
    kp_eff = kp if kv_len is None else torch.where(kp < lens[:, None], kp, ref.INT32_MAX)
    plain = ref.flash_attention_ref(q, k, v, qp, kp_eff, causal, window)
    assert out.dtype == dtype
    if dtype == torch.bfloat16:
        limit = ref.flash_bf16_tolerance(q, k, v, qp, kp_eff, causal, window, plain)
    else:
        limit = 1e-4 + 1e-4 * plain.abs()
    err = (out.float() - plain.float()).abs()
    assert bool((err <= limit).all()), f"max err {float(err.max()):.3e}"


def test_flash_kernel_zeroes_rows_without_keys(cuda_device):
    q, k, v, qp, kp, _ = _inputs(1, 70, 70, 2, 2, 64, seed=1)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    pad = torch.full_like(kp, ref.INT32_MAX).to(cuda_device)
    out = ops.flash_attention(q, k, v, qp.to(cuda_device), pad, causal=False)
    assert float(out.float().abs().max()) == 0.0


def test_flash_kernel_refuses_what_it_has_no_kernel_for(cuda_device):
    q = torch.zeros((1, 8, 2, 32), device=cuda_device, dtype=torch.bfloat16)
    p = torch.zeros((1, 8), device=cuda_device, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q, p, p)
    q = torch.zeros((1, 8, 2, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        ops.flash_attention(q, q, q, p, p)
    plan = uniform.plan_uniform(13, 1, 4, 0.5, 0)
    tables = spmd.BlendTables.build(plan, cuda_device)
    preds = torch.zeros((4, plan.window, 8), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="not supported"):
        ops.latent_blend(preds, tables.weights, tables.normalizer, plan.starts,
                         plan.window, plan.extent)


@pytest.mark.parametrize("dim,extent", [(0, 13), (1, 30), (2, 52)])
def test_blend_kernel_matches_plain(cuda_device, dim, extent):
    plan = uniform.plan_uniform(extent, (1, 2, 2)[dim], 4, 0.5, dim)
    tables = spmd.BlendTables.build(plan, cuda_device)
    rng = np.random.default_rng(dim)
    preds = torch.from_numpy(rng.normal(size=(4, plan.window, 999)).astype(np.float32))
    preds = preds.to(cuda_device)
    before = ops.latent_blend.launches
    out = ops.latent_blend(preds, tables.weights, tables.normalizer, plan.starts,
                           plan.window, plan.extent)
    assert ops.latent_blend.launches == before + 1
    plain = ref.latent_blend_ref(preds, tables.weights, tables.normalizer, plan.starts,
                                 plan.window, plan.extent)
    assert torch.equal(out, plain)     # same f32 operations in the same order


QUANT_CASES = [
    # N, R, F, qmax: the serving path's slabs at latent (13, 30, 52), 2 requests
    (4, 3, 49920, 127),      # T-dim halo transfer: the K slabs of one round
    (4, 4, 49920, 127),      # T-dim cores, core_pad 4
    (4, 8, 21632, 127),      # H-dim cores
    (4, 3, 49920, 7),        # the int4 codes
    (3, 5, 999, 127),        # a ragged slab size
]


@pytest.mark.parametrize("N,R,F,qmax", QUANT_CASES)
def test_int8_quantize_kernel_matches_plain(cuda_device, N, R, F, qmax):
    """Codes and scales bit-equal to the plain version (the same IEEE
    division and half-to-even rounding); slab 1 is all zero (scale
    1e-20 / qmax), slab 2 carries half-way values on which a reciprocal
    multiply gives other codes, then a NaN: its scale is NaN, no other."""
    rng = np.random.default_rng(N * R + qmax)
    x = torch.from_numpy(rng.normal(size=(N, R, F)).astype(np.float32)).to(cuda_device)
    x[0] *= 40.0
    x[1] = 0.0
    assert ref.plant_halfway_inputs(x[2], qmax) > 0
    before = ops.int8_quantize.launches
    wire, scales = ops.int8_quantize(x, qmax)
    assert ops.int8_quantize.launches == before + 1
    pw, ps = ref.int8_quantize_ref(x, qmax)
    assert torch.equal(wire, pw)
    assert torch.equal(scales.view(torch.int32), ps.view(torch.int32))
    x[2, 0, 7] = float("nan")
    _, nan_scales = ops.int8_quantize(x, qmax)
    assert torch.isnan(nan_scales).tolist() == [n == 2 for n in range(N)]


@pytest.mark.parametrize("dim,extent", [(0, 13), (1, 30), (2, 52)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_dequant_blend_kernel_matches_plain(cuda_device, dim, extent, out_dtype):
    plan = uniform.plan_uniform(extent, (1, 2, 2)[dim], 4, 0.5, dim)
    tables = spmd.BlendTables.build(plan, cuda_device)
    rng = np.random.default_rng(dim)
    wire = torch.from_numpy(rng.integers(-127, 128, size=(4, plan.window, 999))
                            .astype(np.int8)).to(cuda_device)
    scales = torch.from_numpy(rng.uniform(1e-3, 0.05, size=4).astype(np.float32))
    scales = scales.to(cuda_device)
    before = ops.dequant_blend.launches
    out = ops.dequant_blend(wire, scales, tables.weights, tables.normalizer, plan.starts,
                            plan.window, plan.extent, out_dtype=out_dtype)
    assert ops.dequant_blend.launches == before + 1
    plain = ref.dequant_blend_ref(wire, scales, tables.weights, tables.normalizer,
                                  plan.starts, plan.window, plan.extent, out_dtype)
    assert out.dtype == out_dtype
    assert torch.equal(out, plain)     # same f32 operations in the same order


@pytest.mark.parametrize("dim,extent", [(0, 13), (1, 30), (2, 52)])
def test_coded_stitch_on_the_card_matches_plain(cuda_device, dim, extent):
    """``blend_windows_coded(codec="int8")`` runs both kernels on CUDA
    tensors and equals the same function on the CPU's plain versions."""
    plan = uniform.plan_uniform(extent, (1, 2, 2)[dim], 4, 0.5, dim)
    shape = [2, 13, 30, 52, 16]
    shape[dim + 1] = plan.window
    preds = torch.from_numpy(np.random.default_rng(dim).normal(size=[4] + shape)
                             .astype(np.float32))
    q0, d0 = ops.int8_quantize.launches, ops.dequant_blend.launches
    out = spmd.blend_windows_coded(preds.to(cuda_device), plan, dim + 1, codec="int8")
    assert (ops.int8_quantize.launches - q0, ops.dequant_blend.launches - d0) == (1, 1)
    plain = spmd.blend_windows_coded(preds, plan, dim + 1, codec="int8")
    assert torch.equal(out.cpu(), plain)


SSD_CASES = [
    # b, s, h, p, n, chunk
    (2, 200, 8, 16, 16, 64),
    (2, 100, 16, 32, 16, 32),        # ragged: a padded last chunk
    (1, 64, 8, 16, 16, 16),
    (2, 4000, 8, 64, 64, 64),        # Zamba2's p, n and chunk, ragged s
    (1, 300, 320, 16, 16, 32),       # more (batch, head) items than blocks
]


def _ssd_inputs(b, s, h, p, n, seed, steep=False):
    """The reference test's distributions; ``steep`` decays reach
    |cum - centre| > 60 inside a chunk, where the +-60 clip decides."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 8.0, size=(h,)).astype(np.float32)
    a = dt * A[None, None, :]
    if steep:
        a = -rng.uniform(2.0, 6.0, size=(b, s, h)).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    return [torch.from_numpy(v) for v in (x, a, dt, B, C)]


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_mamba_ssd_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk, steep):
    args = [t.to(cuda_device) for t in _ssd_inputs(b, s, h, p, n, s + h, steep)]
    before = ops.mamba_ssd.launches
    out = ops.mamba_ssd(*args, chunk=chunk)
    assert ops.mamba_ssd.launches == before + 1
    plain = ref.mamba_ssd_plain(*args, chunk=chunk)
    assert out.shape == (b, s, h, p) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    err = (out - plain).abs()
    assert bool((err <= 5e-4 + 5e-4 * plain.abs()).all()), f"max err {float(err.max()):.3e}"


def test_mamba_ssd_kernel_refuses_what_it_has_no_kernel_for(cuda_device):
    x, a, dt, B, C = (t.to(cuda_device) for t in _ssd_inputs(1, 40, 2, 16, 16, 0))
    with pytest.raises(TypeError, match="not supported"):
        ops.mamba_ssd(x.bfloat16(), a, dt, B, C)
    with pytest.raises(ValueError, match="chunk"):
        ops.mamba_ssd(x, a, dt, B, C, chunk=24)
    x8, _, _, B8, C8 = (t.to(cuda_device) for t in _ssd_inputs(1, 40, 2, 8, 8, 0))
    with pytest.raises(ValueError, match="head dim"):
        ops.mamba_ssd(x8, a, dt, B, C)
    with pytest.raises(ValueError, match="state"):
        ops.mamba_ssd(x, a, dt, B8, C8)
