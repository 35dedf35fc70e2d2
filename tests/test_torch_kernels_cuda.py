"""The port's CUDA kernels against their plain PyTorch versions, on the card.

No JAX here, so the file runs on a GPU host without it:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -q

Every test is marked ``cuda`` and skips without a CUDA device: a kernel
has no CPU mode.  Inputs are made with numpy from a seed.  Stated
tolerances: bf16 flash elementwise within the bound of its two roundings,
``2^-8 attention(q, k, |v|) + 2^-7 |plain|`` (P to bf16 for the
tensor-core P.V, and the bf16 output; ``ref.flash_bf16_tolerance``),
f32 flash 1e-4 (summation order only), blend exact (the same f32
operations in the same order).
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
