"""The port's CUDA kernels against their plain PyTorch versions, on the card.

No JAX here, so the file runs on a GPU host without it:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -q

Every test is marked ``cuda`` and skips without a CUDA device: a kernel
has no CPU mode.  Inputs are made with numpy from a seed.  Stated
tolerances: bf16 flash elementwise within the bound of its two roundings,
``2^-8 attention(q, k, |v|) + 2^-7 |plain|`` (P to bf16 for the
tensor-core P.V, and the bf16 output; ``ref.flash_bf16_tolerance``),
for the three flash kernels (``mma.sync``, ``wgmma`` + TMA and the
split-KV decode kernel, whose P stays f32), f32 flash 1e-4
(summation order only); blend, int8 quantize, dequant-blend and
guidance_update exact (the same f32 operations in the same order);
mamba_ssd and mamba_ssd_wide ``5e-4 + 5e-4 |plain|``, the reference's own
SSD tolerance (f32 throughout, sums in another order), and its states
alike; the reduced xLSTM's hidden states card against CPU ``1e-3 +
1e-3 |cpu|`` (3xTF32 scans, f32 sums in another order through 4 blocks);
mamba_ssd_bwd each gradient within ``1e-4 max|plain| + 1e-4 |plain|``
(3xTF32 products and f32 sums in another order, on the forward kernel's
states); the flash backward (bf16, D 64 and 80 on the wgmma + TMA kernel,
and forced onto mma.sync, each fed the forward's
log-sum-exp) within ``ref.flash_bwd_bf16_tolerance`` (P and dS rounded to
bf16 for the products that take them, f32 sums, the bf16 results); each
forward's log-sum-exp within ``ref.flash_lse_tolerance`` (its scores' f32
sums, its online sum of approximate exp2 terms and their f32 arguments);
the f32 flash forward (D 32 included), its log-sum-exp and the f32
backward 1e-4 + 1e-4 |plain| (3xTF32 products, which drop only lo.lo,
and f32 sums in another order); mamba_ssd_wide_bwd
as mamba_ssd_bwd, against the plain backward in float64; the train CLI's
losses card against CPU from the same weights 1e-4 relative.
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
    out, _ = _flash_checked(q, k, v, qp, kp, causal, window, kv_len)
    assert out.dtype == dtype


def _flash_launches():
    return {n: ops.WRAPPERS[n].launches for n in ops.FLASH_KERNELS}


def _flash_checked(q, k, v, qp, kp, causal, window, kv_len=None, kernel=None):
    """One launch of the flash kernel ``kernel`` (``flash_kernel``'s choice
    for q's dtype, head dim and query count if None), held to the plain
    version on the same inputs; returns (out, plain)."""
    want = kernel or ops.flash_kernel(q.dtype, q.shape[-1], q.shape[1])
    before = _flash_launches()
    out = ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window, kv_len=kv_len,
                              kernel=kernel)
    after = _flash_launches()
    assert {n: after[n] - before[n] for n in after} == {n: int(n == want) for n in after}
    kp_eff = kp if kv_len is None else torch.where(kp < kv_len[:, None], kp, ref.INT32_MAX)
    plain = ref.flash_attention_ref(q, k, v, qp, kp_eff, causal, window)
    if q.dtype == torch.bfloat16:
        limit = ref.flash_bf16_tolerance(q, k, v, qp, kp_eff, causal, window, plain)
    else:
        limit = 1e-4 + 1e-4 * plain.abs()
    err = (out.float() - plain.float()).abs()
    assert bool(torch.isfinite(out.float()).all())
    assert bool((err <= limit).all()), f"max err {float(err.max()):.3e}"
    return out, plain


# (kernel, dtype, head dim): bf16 at D 128, 80 and 64 on the wgmma kernel,
# bf16 at D 80 (Zamba2) on mma.sync too, bf16 at D 80, 64 and 128 on the
# split-KV decode kernel (the LM decode steps; forced here at any query
# count), f32 on the 3xTF32 kernel of flash_attention.cu
KERNEL_CASES = [("flash_attention_sm90", torch.bfloat16, 128),
                ("flash_attention_sm90", torch.bfloat16, 80),
                ("flash_attention_sm90", torch.bfloat16, 64),
                ("flash_attention", torch.bfloat16, 80), ("flash_attention", torch.float32, 128),
                ("flash_decode", torch.bfloat16, 80), ("flash_decode", torch.bfloat16, 64),
                ("flash_decode", torch.bfloat16, 128)]


@pytest.mark.parametrize("kernel,dtype,D", KERNEL_CASES)
@pytest.mark.parametrize("case", ref.SKIP_EDGE_CASES)
def test_flash_kernels_on_skip_edges(cuda_device, case, kernel, dtype, D):
    """Positions that put the skipping of masked key tiles at its edges
    (``ref.skip_edge_positions``): non-monotone positions, fully padded
    interior tiles, a causal tile whose only attendable pair is its first
    key against the block's last query; rows with no key are zero."""
    B, Sq, Skv, H, KV = 2, 300, 333, 4, 2
    q, k, v, _, _, _ = _inputs(B, Sq, Skv, H, KV, D, seed=4)
    qp, kp, causal, window = ref.skip_edge_positions(case, B, Sq, Skv, seed=5)
    q, k, v = (x.to(cuda_device, dtype) for x in (q, k, v))
    qp, kp = (torch.from_numpy(x).to(cuda_device) for x in (qp, kp))
    out, _ = _flash_checked(q, k, v, qp, kp, causal, window, kernel=kernel)
    empty = ~ref.attention_mask(qp, kp, causal, window).any(-1)
    assert int(empty.sum()) == (2 * 127 if case == "causal_first_key" else 0)
    if bool(empty.any()):
        assert float(out[empty].float().abs().max()) == 0.0


@pytest.mark.parametrize("kernel,dtype,D", KERNEL_CASES)
def test_flash_kernels_masked_gqa(cuda_device, kernel, dtype, D):
    """Causal + window + GQA + padded slots + kv_len, Skv 333: ragged
    against both 32- and 128-key tiles."""
    B, Sq, Skv, H, KV = 2, 200, 333, 12, 4
    q, k, v, qp, kp, _ = _inputs(B, Sq, Skv, H, KV, D, seed=6)
    q, k, v = (x.to(cuda_device, dtype) for x in (q, k, v))
    kp = kp.clone()
    kp[:, -5:] = ref.INT32_MAX
    lens = torch.tensor([Skv - 7 * (b + 1) for b in range(B)], dtype=torch.int32)
    _flash_checked(q, k, v, qp.to(cuda_device), kp.to(cuda_device), True, 96,
                   kv_len=lens.to(cuda_device), kernel=kernel)


@pytest.mark.parametrize("kernel,dtype,D", KERNEL_CASES)
def test_flash_kernels_on_a_mostly_empty_decode_cache(cuda_device, kernel, dtype, D):
    """A decode step: 4 requests, one query each at position 62, against
    a 4096-slot cache of which 63 slots are valid (kv_len)."""
    B, Skv, H = 4, 4096, 8
    q, k, v, _, kp, _ = _inputs(B, 1, Skv, H, H, D, seed=7)
    q, k, v = (x.to(cuda_device, dtype) for x in (q, k, v))
    qp = torch.full((B, 1), 62, dtype=torch.int32, device=cuda_device)
    lens = torch.full((B,), 63, dtype=torch.int32, device=cuda_device)
    _flash_checked(q, k, v, qp, kp.to(cuda_device), False, 0, kv_len=lens, kernel=kernel)


@pytest.mark.parametrize("kernel,dtype,D", KERNEL_CASES)
def test_flash_kernels_zero_a_row_without_keys(cuda_device, kernel, dtype, D):
    q, k, v, qp, kp, _ = _inputs(2, 150, 260, 4, 4, D, seed=8)
    q, k, v = (x.to(cuda_device, dtype) for x in (q, k, v))
    kp = kp.clone()
    kp[1] = ref.INT32_MAX                      # batch row 1: every key padded
    out, _ = _flash_checked(q, k, v, qp.to(cuda_device), kp.to(cuda_device), False, 0,
                            kernel=kernel)
    assert float(out[1].float().abs().max()) == 0.0 and float(out[0].float().abs().max()) > 0


@pytest.mark.parametrize("B,H,KV,D", [(4, 32, 32, 80), (2, 8, 2, 64)])
def test_flash_decode_on_a_full_cache(cuda_device, B, H, KV, D):
    """One query per request against 4096 slots, every slot valid: each of
    the splits holds keys, so the merge rescales and sums them all."""
    q, k, v, _, kp, _ = _inputs(B, 1, 4096, H, KV, D, seed=B + H)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    qp = torch.full((B, 1), 4095, dtype=torch.int32, device=cuda_device)
    _flash_checked(q, k, v, qp, kp.to(cuda_device), True, 0, kernel="flash_decode")


@pytest.mark.parametrize("G,KV", [(3, 8), (5, 8), (6, 8), (16, 8)])
@pytest.mark.parametrize("valid", [63, 4096])
def test_flash_decode_d128_at_the_configs_groups(cuda_device, G, KV, valid):
    """bf16 D 128, one query per request (the routing's own choice, no
    kernel forced), at the group sizes of the D-128 LMs (granite-moe's 3,
    minitron's 3, internvl2's 6, llama4's 5, llama3's 16 query heads a kv
    head): a ragged cache (63 of 4096 slots valid) and a full one."""
    B, Skv = 4, 4096
    assert ops.flash_kernel(torch.bfloat16, 128, 1) == "flash_decode"
    q, k, v, _, kp, _ = _inputs(B, 1, Skv, G * KV, KV, 128, seed=G * 10 + valid)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    qp = torch.full((B, 1), valid - 1, dtype=torch.int32, device=cuda_device)
    lens = torch.full((B,), valid, dtype=torch.int32, device=cuda_device)
    _flash_checked(q, k, v, qp, kp.to(cuda_device), False, 0, kv_len=lens)


@pytest.mark.parametrize("valid", [63, 4096])
def test_flash_decode_two_calls_are_bit_equal(cuda_device, valid):
    """The merge runs in split order whichever block finishes last."""
    B, Skv, H = 4, 4096, 32
    q, k, v, _, kp, _ = _inputs(B, 1, Skv, H, H, 80, seed=valid)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    qp = torch.full((B, 1), valid - 1, dtype=torch.int32, device=cuda_device)
    lens = torch.full((B,), valid, dtype=torch.int32, device=cuda_device)
    kp = kp.to(cuda_device)
    a = ops.flash_decode(q, k, v, qp, kp, causal=False, kv_len=lens)
    b = ops.flash_decode(q, k, v, qp, kp, causal=False, kv_len=lens)
    assert torch.equal(a, b)


@pytest.mark.parametrize("Sq", [1, 2, 4, 5, 8, 9, 17])
def test_flash_decode_at_query_counts_around_its_row_passes(cuda_device, Sq):
    """GQA (4 query heads a kv head), causal with a window: Sq * 4 rows go
    through passes of 16 (5, 9 and 17 queries leave a part pass); 9 and 17
    queries are above DECODE_MAX_QUERIES, forced."""
    q, k, v, qp, kp, _ = _inputs(2, Sq, 900, 16, 4, 80, seed=Sq)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    _flash_checked(q, k, v, qp.to(cuda_device), kp.to(cuda_device), True, 300,
                   kernel="flash_decode")


def test_flash_decode_with_one_split(cuda_device):
    """More (batch row, kv head) pairs than resident blocks: one split, so
    every block is the last of its (batch row, kv head) and merges its own
    partial."""
    B, KV = 8, 80
    assert ops.decode_split(300, B * KV, ops._decode_resident(cuda_device, 64))[0] == 1
    q, k, v, qp, kp, lens = _inputs(B, 1, 300, KV, KV, 64, seed=3)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    _flash_checked(q, k, v, qp.to(cuda_device), kp.to(cuda_device), False, 0,
                   kv_len=lens.to(cuda_device), kernel="flash_decode")


@pytest.mark.parametrize("over", [1, 7])
def test_flash_decode_takes_kv_len_past_the_cache(cuda_device, over):
    """A decode step at ``position >= S_max`` (the reference clamps the
    cache write and keeps ``kv_len = position + 1``): kv_len above Skv
    masks nothing, so every slot the query's position allows is attended,
    as in the plain version."""
    B, Skv, H = 4, 512, 32
    q, k, v, _, kp, _ = _inputs(B, 1, Skv, H, H, 80, seed=20 + over)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    qp = torch.full((B, 1), Skv - 1 + over, dtype=torch.int32, device=cuda_device)
    lens = torch.full((B,), Skv + over, dtype=torch.int32, device=cuda_device)
    _flash_checked(q, k, v, qp, kp.to(cuda_device), False, 0, kv_len=lens,
                   kernel="flash_decode")


def test_flash_decode_positions_off_a_16_byte_boundary(cuda_device):
    """Key positions that start 4 bytes past a 16-byte boundary are read
    with scalar loads; the result is the same function."""
    B, Skv = 3, 1000
    q, k, v, qp, _, lens = _inputs(B, 2, Skv, 4, 4, 80, seed=12)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    base = torch.arange(Skv + 1, dtype=torch.int32, device=cuda_device) - 1
    kp = base[None, 1:].expand(B, Skv)
    assert kp.data_ptr() % 16 == 4
    _flash_checked(q, k, v, qp.to(cuda_device), kp, True, 0, kv_len=lens.to(cuda_device),
                   kernel="flash_decode")


SM90_CASES = [
    # B, Sq, Skv, H, KV, causal, window: the wgmma kernel at its shapes
    (1, 3120, 3120, 2, 2, False, 0),     # a T window's self-attention
    (2, 3120, 512, 2, 2, False, 0),      # cross-attention to the text context
    (2, 200, 700, 8, 2, False, 0),       # Sq != Skv, ragged, GQA
    (2, 333, 517, 6, 3, True, 0),        # causal, ragged both ways
    (3, 1, 300, 4, 4, False, 0),         # one query
    (1, 130, 1, 4, 4, False, 0),         # one key
    (1, 1000, 1000, 4, 4, True, 0),      # a causal prefill
]


@pytest.mark.parametrize("D", [128, 80, 64])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,causal,window", SM90_CASES)
def test_sm90_flash_kernel_matches_plain(cuda_device, B, Sq, Skv, H, KV, causal, window, D):
    q, k, v, qp, kp, _ = _inputs(B, Sq, Skv, H, KV, D, seed=Sq + Skv)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    _flash_checked(q, k, v, qp.to(cuda_device), kp.to(cuda_device), causal, window,
                   kernel="flash_attention_sm90")


@pytest.mark.parametrize("Skv", [63361, 63960])
def test_sm90_flash_kernel_takes_any_key_count(cuda_device, Skv):
    """Past the 63,360 keys that a live-tile list in shared memory allowed:
    63,960 is the 161-frame latent's token count (41 x 30 x 52).  256
    queries at the last positions, causal, so the plain version's score
    slab stays (H, 256, Skv)."""
    q, k, v, qp, kp, _ = _inputs(1, 256, Skv, 2, 2, 128, seed=Skv)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    _flash_checked(q, k, v, qp.to(cuda_device), kp.to(cuda_device), True, 0,
                   kernel="flash_attention_sm90")


def test_sm90_d80_reads_the_16_column_box(cuda_device):
    """V is zero outside dims 64-79, so the whole output comes from the
    16-column box's P.V product (its 32-byte-swizzle descriptor); and Q, K
    are zero in dims 0-63, so the scores come from its Q.K^T k-step."""
    q, k, v, qp, kp, _ = _inputs(2, 300, 333, 4, 2, 80, seed=11)
    v[..., :64] = 0.0
    q[..., :64] = 0.0
    k[..., :64] = 0.0
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    out, _ = _flash_checked(q, k, v, qp.to(cuda_device), kp.to(cuda_device), True, 0,
                            kernel="flash_attention_sm90")
    assert float(out[..., :64].float().abs().max()) == 0.0
    assert float(out[..., 64:].float().abs().max()) > 0.1


def test_sm90_flash_kernel_refuses_other_types_and_dims(cuda_device):
    p = torch.zeros((1, 8), device=cuda_device, dtype=torch.int32)
    for dtype, D in ((torch.float32, 128), (torch.bfloat16, 32), (torch.float32, 64)):
        q = torch.zeros((1, 8, 2, D), device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError, match="flash_attention_sm90 is not built for"):
            ops.flash_attention_sm90(q, q, q, p, p)


@pytest.mark.parametrize("case", ref.SKIP_EDGE_CASES + ("vdm_10s_keys",))
def test_sm90_live_tile_pre_pass_equals_plain(cuda_device, case):
    """The wgmma kernel's pre-pass writes exactly ``ref.live_tiles_plain``'s
    lists: the entries, their flags and order, the -1 after them and the
    count."""
    if case == "vdm_10s_keys":
        Sq, Skv = 256, 63960
        qp = np.arange(Skv - Sq, Skv, dtype=np.int32)[None].repeat(2, 0)
        kp = np.arange(Skv, dtype=np.int32)[None].repeat(2, 0)
        kp[1, 5000:9000] = ref.INT32_MAX
        causal, window = True, 40000
    else:
        qp, kp, causal, window = ref.skip_edge_positions(case, 2, 300, 333, seed=5)
    qp, kp = (torch.from_numpy(x).to(cuda_device) for x in (qp, kp))
    lists = ops.flash_live_tiles(qp, kp, causal=causal, window=window)
    plain = ref.live_tiles_plain(qp, kp, 128, 128, causal, window)
    assert lists.dtype == torch.int32 and torch.equal(lists, plain)


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
    (5, 3, 333, 7),          # M % 4 != 0 with the int4 codes
    (4, 6, 199680, 127),     # 480p T-dim cores, 4.8 MB slabs
    (66, 3, 4000, 127),      # 2 blocks a slab on a 132-SM card
    (600, 4, 1000, 127),     # more slabs than blocks: each block takes whole slabs in turn
    (140, 1, 70001, 127),    # and slabs of 280 KB, more than a block stages
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


def _quant_equal(x, qmax):
    """One counted launch, codes and scales bit-equal to the plain version;
    returns the kernel's scales."""
    before = ops.int8_quantize.launches
    wire, scales = ops.int8_quantize(x, qmax)
    assert ops.int8_quantize.launches == before + 1
    pw, ps = ref.int8_quantize_ref(x, qmax)
    assert torch.equal(wire, pw)
    assert torch.equal(scales.view(torch.int32), ps.view(torch.int32))
    return scales


QUANT_EDGE_SHAPES = [(4, 3, 49920, 127), (3, 5, 999, 7), (4, 6, 199680, 127)]


@pytest.mark.parametrize("N,R,F,qmax", QUANT_EDGE_SHAPES)
def test_int8_quantize_slab_max_in_the_last_block_share(cuda_device, N, R, F, qmax):
    """Each slab's only max-abs lies in the last 64th of the slab (inside
    the last of the slab's blocks), or is its last element: a scale taken
    from any block's own share alone gives other codes."""
    rng = np.random.default_rng(F + qmax)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(N, R, F)).astype(np.float32))
    flat = x.view(N, -1)
    M = flat.shape[1]
    for n in range(N):
        flat[n, M - 1 if n == N - 1 else M - 1 - M // 64 - n] = -(3.0 + n)
    _quant_equal(x.to(cuda_device), qmax)


@pytest.mark.parametrize("N,R,F,qmax", QUANT_EDGE_SHAPES)
def test_int8_quantize_nan_in_the_last_element_of_a_slab(cuda_device, N, R, F, qmax):
    rng = np.random.default_rng(F)
    x = torch.from_numpy(rng.normal(size=(N, R, F)).astype(np.float32)).to(cuda_device)
    x[1, -1, -1] = float("nan")
    _, scales = ops.int8_quantize(x, qmax)
    assert torch.isnan(scales).tolist() == [n == 1 for n in range(N)]


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("N,R,F", [(3, 5, 999), (4, 3, 49920)])
def test_int8_quantize_slabs_off_a_16_byte_boundary(cuda_device, offset, N, R, F):
    """x starts 4, 8 or 12 bytes past a 16-byte boundary: every slab's
    head and tail are scalar accesses, the codes start off a word."""
    rng = np.random.default_rng(offset)
    base = torch.from_numpy(rng.normal(size=N * R * F + 4).astype(np.float32)).to(cuda_device)
    x = base[offset:offset + N * R * F].view(N, R, F)
    assert x.data_ptr() % 16 == 4 * offset
    _quant_equal(x, 127)


def _blend_tables(K, W, E, starts, seed):
    rng = np.random.default_rng(seed)
    weights = torch.from_numpy(rng.uniform(0.1, 1.0, size=(K, W)).astype(np.float32))
    norm = torch.from_numpy(rng.uniform(0.5, 2.0, size=E).astype(np.float32))
    return weights, norm


_K32_STARTS = tuple(int(s) for s in np.sort(np.random.default_rng(32).integers(0, 49, 32)))
BLEND_EDGE_CASES = {
    # name: K, W, E, starts, F
    "f_not_multiple_of_4": (4, 8, 13, (0, 2, 5, 5), 1001),
    "f_3": (4, 8, 13, (0, 2, 5, 5), 3),
    "repeated_starts": (5, 6, 10, (0, 0, 3, 3, 4), 1000),
    "one_window": (1, 7, 7, (0,), 996),
    "k32": (32, 16, 64, _K32_STARTS, 2000),
    "k32_f_not_multiple_of_4": (32, 16, 64, _K32_STARTS, 999),
    "k32_one_row": (32, 1, 1, (0,) * 32, 64),
}


@pytest.mark.parametrize("case", sorted(BLEND_EDGE_CASES))
def test_blend_kernel_on_cover_edges(cuda_device, case):
    """Shapes the serving path does not give: F % 4 != 0 (4-byte loads),
    repeated starts (a row covered by several windows at one offset), K = 32
    (a row covered by up to 32 windows: the cover list at its size).
    Bit-equal to the plain version."""
    K, W, E, starts, F = BLEND_EDGE_CASES[case]
    weights, norm = _blend_tables(K, W, E, starts, len(case))
    preds = torch.from_numpy(np.random.default_rng(F).normal(size=(K, W, F))
                             .astype(np.float32))
    args = [t.to(cuda_device) for t in (preds, weights, norm)]
    before = ops.latent_blend.launches
    out = ops.latent_blend(*args, starts, W, E)
    assert ops.latent_blend.launches == before + 1
    assert torch.equal(out, ref.latent_blend_ref(*args, starts, W, E))


def test_blend_kernel_at_the_480p_t_dim(cuda_device):
    """The vdm_5s latent's T dim (K 4, W 12, E 21, F 199,680), bit-equal."""
    plan = uniform.plan_uniform(21, 1, 4, 0.5, 0)
    assert (plan.window, plan.extent) == (12, 21)
    tables = spmd.BlendTables.build(plan, cuda_device)
    preds = torch.from_numpy(np.random.default_rng(21).normal(size=(4, 12, 199680))
                             .astype(np.float32)).to(cuda_device)
    args = (preds, tables.weights, tables.normalizer, plan.starts, plan.window, plan.extent)
    assert torch.equal(ops.latent_blend(*args), ref.latent_blend_ref(*args))


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


DEQUANT_CASES = {
    # name: latent extent of the dim, dim, F, byte offset of the wire's start
    "serving_dim0": (13, 0, 49920, 0),        # the smoke's latent, 2 requests: 4 codes a thread
    "serving_dim1": (30, 1, 21632, 0),
    "serving_dim2": (52, 2, 12480, 0),
    "480p_dim0": (21, 0, 199680, 0),          # vdm_5s's T dim: 16 codes a thread
    "480p_ragged_warp": (21, 0, 199760, 0),   # 16 codes; a row ends 5 runs into a warp
    "odd_f": (13, 0, 1001, 0),                # one code a thread
    "f_mod16_4": (13, 0, 49924, 0),           # 4 codes a thread
    "wire_off_16_bytes": (21, 0, 199680, 4),  # 480p, but the wire starts 4 bytes in: 4 codes
    "wire_off_4_bytes": (30, 1, 21632, 1),    # one code a thread
}


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DEQUANT_CASES))
def test_dequant_blend_kernel_at_its_load_widths(cuda_device, case, out_dtype):
    """Bit-equal to the plain version at the serving dims (4 codes a
    thread), the 480p T dim (16 codes a thread, stores staged a warp at a
    time), and where F, the wire's start or a row's end in mid-warp change
    the load width or the staged store."""
    extent, dim, F, offset = DEQUANT_CASES[case]
    plan = uniform.plan_uniform(extent, (1, 2, 2)[dim], 4, 0.5, dim)
    tables = spmd.BlendTables.build(plan, cuda_device)
    rng = np.random.default_rng(F + offset)
    n = 4 * plan.window * F
    flat = torch.from_numpy(rng.integers(-127, 128, size=n + 16).astype(np.int8))
    wire = flat.to(cuda_device)[offset:offset + n].view(4, plan.window, F)
    assert wire.data_ptr() % 16 == offset
    scales = torch.from_numpy(rng.uniform(1e-3, 0.05, size=4).astype(np.float32))
    args = (wire, scales.to(cuda_device), tables.weights, tables.normalizer, plan.starts,
            plan.window, plan.extent)
    before = ops.dequant_blend.launches
    out = ops.dequant_blend(*args, out_dtype=out_dtype)
    assert ops.dequant_blend.launches == before + 1
    assert out.dtype == out_dtype
    assert torch.equal(out, ref.dequant_blend_ref(*args, out_dtype))


@pytest.mark.parametrize("case", sorted(BLEND_EDGE_CASES))
def test_dequant_blend_kernel_on_cover_edges(cuda_device, case):
    """latent_blend's cover edges (F % 4 != 0, repeated starts, K = 32,
    one row under 32 windows) on int8 codes, f32 and bf16, bit-equal."""
    K, W, E, starts, F = BLEND_EDGE_CASES[case]
    weights, norm = _blend_tables(K, W, E, starts, len(case))
    rng = np.random.default_rng(F)
    wire = torch.from_numpy(rng.integers(-127, 128, size=(K, W, F)).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(1e-3, 0.05, size=K).astype(np.float32))
    args = [t.to(cuda_device) for t in (wire, scales, weights, norm)]
    for out_dtype in (torch.float32, torch.bfloat16):
        out = ops.dequant_blend(*args, starts, W, E, out_dtype=out_dtype)
        assert torch.equal(out, ref.dequant_blend_ref(*args, starts, W, E, out_dtype))


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
    (2, 4096, 80, 64, 64, 64),       # Zamba2-2.7B's prefill, whole
    (1, 130, 4, 48, 32, 32),         # p 48: a narrower last slice if slices are 32 wide
    (2048, 40, 2, 16, 16, 16),       # more tasks than resident blocks: blocks take several
]

# (chunk, p, n) the FMA kernel's shared-memory check took that no other
# accepted shape exceeds in all three: every accepted shape is under one
SSD_WIDEST = [(64, 128, 128), (80, 80, 128), (80, 112, 112), (80, 128, 96), (96, 32, 128),
              (96, 64, 112), (96, 96, 96), (96, 128, 80), (112, 16, 112), (112, 48, 96),
              (112, 80, 80), (112, 128, 64), (128, 32, 80), (128, 80, 64), (128, 112, 48),
              (128, 128, 32)]


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


@pytest.mark.parametrize("chunk,p,n", SSD_WIDEST)
def test_mamba_ssd_kernel_takes_every_shape_the_fma_kernel_took(cuda_device, chunk, p, n):
    args = [t.to(cuda_device) for t in _ssd_inputs(1, 2 * chunk + 5, 3, p, n, chunk + p + n)]
    out = ops.mamba_ssd(*args, chunk=chunk)
    plain = ref.mamba_ssd_plain(*args, chunk=chunk)
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


# the backward: b, s, h, p, n, chunk, steep
SSD_BWD_CASES = [
    (2, 200, 8, 16, 16, 64, False),
    (2, 100, 16, 32, 16, 32, False),    # ragged: a padded last chunk
    (1, 64, 8, 16, 16, 16, False),
    (2, 300, 6, 64, 64, 64, False),     # Zamba2's p, n and chunk, ragged s
    (2, 300, 6, 64, 64, 64, True),      # the clip bites
    (1, 150, 4, 16, 16, 32, True),
    (2, 2048, 80, 64, 64, 64, False),   # Zamba2-2.7B's training microbatch
    # more blocks than the card holds at once (pass (c): 3 chunks x 64 rows
    # x 2 head groups, the second of 4 heads), so a head group's share of
    # dB / dC not started afresh, or a carry not reset, shows
    (64, 40, 12, 16, 16, 16, False),
]


def _ssd_bwd_close(got, want):
    """Each gradient within 1e-4 of its plain version's max-abs, plus
    1e-4 of the element (3xTF32 products and f32 sums in another order;
    the kernel reads the forward kernel's 3xTF32 states)."""
    for name, g, w in zip(("dx", "dlog_decay", "dscale", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        err = (g - w).abs()
        lim = 1e-4 * float(w.abs().max()) + 1e-4 * w.abs()
        assert bool((err <= lim).all()), f"{name}: max err {float(err.max()):.3e}"


@pytest.mark.parametrize("b,s,h,p,n,chunk,steep", SSD_BWD_CASES)
def test_mamba_ssd_states_entry_writes_the_plain_states(cuda_device, b, s, h, p, n, chunk,
                                                        steep):
    args = [t.to(cuda_device) for t in _ssd_inputs(b, s, h, p, n, s + h, steep)]
    y, states = ops.mamba_ssd(*args, chunk=chunk, return_states=True)
    want_y, want = ref.mamba_ssd_plain(*args, chunk=chunk, return_states=True)
    assert torch.equal(y, ops.mamba_ssd(*args, chunk=chunk))      # the serving entry's y
    assert states.shape == want.shape == (b, -(-s // chunk), h, n, p)
    err = (states - want).abs()
    assert bool((err <= 5e-4 + 5e-4 * want.abs()).all()), f"max err {float(err.max()):.3e}"


@pytest.mark.parametrize("b,s,h,p,n,chunk,steep", SSD_BWD_CASES)
def test_mamba_ssd_bwd_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk, steep):
    args = [t.to(cuda_device) for t in _ssd_inputs(b, s, h, p, n, s + h, steep)]
    dy = torch.randn((b, s, h, p), generator=torch.Generator("cuda").manual_seed(s),
                     device=cuda_device)
    _, states = ops.mamba_ssd(*args, chunk=chunk, return_states=True)
    before = ops.mamba_ssd_bwd.launches
    got = ops.mamba_ssd_bwd(*args, dy, states, chunk=chunk)
    assert ops.mamba_ssd_bwd.launches == before + 1
    _ssd_bwd_close(got, ref.mamba_ssd_bwd_plain(*args, dy, chunk=chunk))
    again = ops.mamba_ssd_bwd(*args, dy, states, chunk=chunk)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))      # deterministic


def _fma_kernel_smem_bytes(Q, n, p):
    """Shared memory the f32-FMA backward (the kernel before the 3xTF32
    redesign) took at (chunk Q, n, p); it refused the shapes above 232448."""
    return 4 * (2 * Q * (p + 1) + 2 * Q * (n + 1) + 2 * n * (p + 1) + Q * (Q + 1)
                + 2 * Q * (max(p, n) + 1) + 16 * Q + 264)


def test_mamba_ssd_bwd_takes_every_shape_the_fma_kernel_took(cuda_device):
    """Every (chunk, p, n) the f32-FMA backward took fits the redesigned
    kernel's blocks, and the three that take the most shared memory run
    within the tolerance."""
    from repro_torch.kernels import build

    lib = build.library("mamba_ssd_bwd")
    sizes = range(16, 129, 16)
    took = [(Q, p, n) for Q in sizes for p in sizes for n in sizes
            if _fma_kernel_smem_bytes(Q, n, p) <= 232448]
    need = {s: lib.mamba_ssd_bwd_smem_bytes(s[2], s[1], s[0]) for s in took}
    assert len(took) == 315 and max(need.values()) <= 232448
    for chunk, p, n in sorted(need, key=need.get)[-3:]:
        args = [t.to(cuda_device) for t in _ssd_inputs(1, 2 * chunk + 5, 3, p, n, chunk + p)]
        dy = torch.randn((1, 2 * chunk + 5, 3, p), generator=torch.Generator("cuda").manual_seed(p),
                         device=cuda_device)
        _, states = ops.mamba_ssd(*args, chunk=chunk, return_states=True)
        _ssd_bwd_close(ops.mamba_ssd_bwd(*args, dy, states, chunk=chunk),
                       ref.mamba_ssd_bwd_plain(*args, dy, chunk=chunk))


def test_mamba_ssd_autograd_runs_both_kernels(cuda_device):
    """``ops.mamba_ssd_autograd`` under autograd: the forward's
    state-writing entry and the backward kernel each launch once, and the
    gradients equal autograd's of the plain scan."""
    args = [t.to(cuda_device) for t in _ssd_inputs(2, 150, 4, 16, 16, 3, True)]
    leaves = [t.clone().requires_grad_() for t in args]
    before = (ops.mamba_ssd.launches, ops.mamba_ssd_bwd.launches)
    out = ops.mamba_ssd_autograd(*leaves, chunk=32)
    dy = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves, dy)
    assert (ops.mamba_ssd.launches, ops.mamba_ssd_bwd.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ref.mamba_ssd_plain(*plain, chunk=32), plain, dy)
    _ssd_bwd_close(grads, want)


def test_mamba_ssd_bwd_refuses_what_it_has_no_kernel_for(cuda_device):
    x, a, dt, B, C = (t.to(cuda_device) for t in _ssd_inputs(1, 40, 2, 16, 16, 0))
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.mamba_ssd(x.requires_grad_(), a, dt, B, C)
    x = x.detach()
    with pytest.raises(ValueError, match="states"):
        ops.mamba_ssd_bwd(x, a, dt, B, C, torch.zeros_like(x), None)
    xw, aw, dw, Bw, Cw = (t.to(cuda_device) for t in _ssd_inputs(1, 40, 2, 128, 128, 0))
    with pytest.raises(ValueError, match="227 KB"):
        ops.mamba_ssd_autograd(xw.requires_grad_(), aw, dw, Bw, Cw, chunk=128)


GUIDANCE_SHAPES = [(4, 8, 8, 4), (1, 13, 60, 104, 16), (3, 7, 11)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GUIDANCE_SHAPES)
def test_guidance_update_kernel_is_bit_equal_to_plain(cuda_device, shape, dtype):
    """The reference test's w 5.0 and dt -0.02; the 480p latent, a small
    one and a ragged one (a scalar tail after the 16-byte vectors)."""
    rng = np.random.default_rng(2)
    z, c, u = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    before = ops.guidance_update.launches
    out = ops.guidance_update(z, c, u, 5.0, -0.02)
    assert ops.guidance_update.launches == before + 1
    assert out.dtype == dtype and out.shape == z.shape
    assert torch.equal(out, ref.guidance_update_plain(z, c, u, 5.0, -0.02))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_guidance_update_kernel_on_unaligned_buffers(cuda_device, dtype):
    """Contiguous views that start off a 16-byte boundary take the
    scalar path, bit-equal all the same."""
    rng = np.random.default_rng(3)
    z, c, u = (torch.from_numpy(rng.normal(size=1001).astype(np.float32))
               .to(cuda_device, dtype)[1:] for _ in range(3))
    assert z.data_ptr() % 16 != 0
    out = ops.guidance_update(z, c, u, 5.0, -0.02)
    assert torch.equal(out, ref.guidance_update_plain(z, c, u, 5.0, -0.02))


def test_guidance_update_kernel_refuses_mixed_inputs(cuda_device):
    z = torch.zeros((4, 6), device=cuda_device)
    before = ops.guidance_update.launches
    with pytest.raises(TypeError, match="mixed dtypes"):
        ops.guidance_update(z, z.bfloat16(), z, 5.0, -0.02)
    with pytest.raises(ValueError, match="one shape"):
        ops.guidance_update(z, z[:, :3], z, 5.0, -0.02)
    with pytest.raises(ValueError, match="contiguous"):
        ops.guidance_update(z.t(), z.t().contiguous(), z.t().contiguous(), 5.0, -0.02)
    with pytest.raises(TypeError, match="not supported"):
        ops.guidance_update(z.half(), z.half(), z.half(), 5.0, -0.02)
    assert ops.guidance_update.launches == before


# the flash backward: B, Sq, Skv, H, KV, D, causal, window, padded keys
BWD_CASES = [
    (2, 40, 40, 4, 4, 64, True, 0, 0),              # below 128 queries: flash_attention.cu's lse
    (2, 130, 190, 8, 2, 64, True, 50, 5),           # GQA, window, a ragged tile
    (2, 77, 150, 4, 1, 64, False, 0, 9),            # one kv head, no causal mask
    (1, 512, 512, 8, 2, 64, True, 0, 0),            # whole tiles: the unmasked path
    (2, 300, 300, 4, 2, 80, True, 0, 0),            # Zamba2's head dim: the split boxes
    (2, 100, 333, 8, 2, 80, True, 96, 5),           # D 80 below 128 queries, GQA, window
    (2, 77, 150, 4, 1, 80, False, 0, 9),            # D 80, one kv head, no causal mask
    (2, 130, 190, 8, 2, 80, True, 50, 5),           # D 80 GQA, a ragged tile
    (1, 512, 512, 8, 2, 80, True, 0, 0),            # D 80 whole tiles
]


def _bwd_inputs(cuda_device, B, Sq, Skv, H, KV, D, pad, seed=0):
    q, k, v, qp, kp, _ = _inputs(B, Sq, Skv, H, KV, D, seed=seed)
    do = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(B, Sq, H, D)).astype(np.float32))
    q, k, v, do = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v, do))
    qp, kp = qp.to(cuda_device), kp.to(cuda_device)
    if pad:
        kp[:, -pad:] = ref.INT32_MAX
    return q, k, v, do, qp, kp


def _bwd_checked(q, k, v, out, lse, do, qp, kp, causal, window):
    """One launch of the backward kernel ``ops.bwd_kernel`` names, held to the
    plain backward; returns the gradients."""
    kernel = ops.bwd_kernel(q.dtype, q.shape[-1])
    before = ops.launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, qp, kp, causal=causal, window=window)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {n: int(n == kernel) for n in after}
    plain = ref.flash_attention_bwd_ref(q, k, v, out, do, qp, kp, causal, window)
    limits = ref.flash_bwd_bf16_tolerance(q, k, v, out, do, qp, kp, causal, window, plain)
    for name, g, p, lim in zip(("dq", "dk", "dv"), got, plain, limits):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all()), name
        err = (g.float() - p.float()).abs()
        assert bool((err <= lim).all()), f"{name}: {float((err / lim).max()):.3f} of the limit"
    return got


def _forward(q, k, v, qp, kp, causal, window):
    with torch.no_grad():
        return ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window,
                                   return_lse=True)


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda_device, case):
    B, Sq, Skv, H, KV, D, causal, window, pad = case
    q, k, v, do, qp, kp = _bwd_inputs(cuda_device, B, Sq, Skv, H, KV, D, pad)
    out, lse = _forward(q, k, v, qp, kp, causal, window)
    got = _bwd_checked(q, k, v, out, lse, do, qp, kp, causal, window)
    again = ops.flash_attention_bwd(q, k, v, out, do, lse, qp, kp, causal=causal,
                                    window=window)
    for a, b in zip(got, again):                      # deterministic: no atomics
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("case", ref.SKIP_EDGE_CASES)
def test_flash_backward_kernel_on_skip_edges(cuda_device, case, D):
    """Positions in any order, padded interior tiles, and queries that
    attend no key (zero gradients), at both head dims of the wgmma
    backward."""
    qp, kp, causal, window = ref.skip_edge_positions(case, 2, 300, 333, seed=5)
    q, k, v, do, _, _ = _bwd_inputs(cuda_device, 2, 300, 333, 4, 2, D, 0, seed=5)
    qp, kp = torch.from_numpy(qp).to(cuda_device), torch.from_numpy(kp).to(cuda_device)
    out, lse = _forward(q, k, v, qp, kp, causal, window)
    dq, _, _ = _bwd_checked(q, k, v, out, lse, do, qp, kp, causal, window)
    if case == "causal_first_key":
        assert float(dq[:, :127].float().abs().max()) == 0.0


@pytest.mark.parametrize("D", [64, 80])
def test_forced_mma_backward_still_matches_plain(cuda_device, D):
    """``flash_attention_bwd.cu`` (mma.sync), on no path and kept as the
    wgmma backward's timing twin, reached through ``kernel=``: within the
    stated limit and deterministic at both head dims."""
    q, k, v, do, qp, kp = _bwd_inputs(cuda_device, 2, 300, 333, 8, 2, D, 5, seed=D)
    out, lse = _forward(q, k, v, qp, kp, True, 96)
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, out, do, lse, qp, kp, causal=True, window=96,
                                  kernel="flash_attention_bwd")
    assert ops.flash_attention_bwd.launches == before + 1
    plain = ref.flash_attention_bwd_ref(q, k, v, out, do, qp, kp, True, 96)
    limits = ref.flash_bwd_bf16_tolerance(q, k, v, out, do, qp, kp, True, 96, plain)
    for g, w, lim in zip(got, plain, limits):
        assert bool(((g.float() - w.float()).abs() <= lim).all())
    again = ops.flash_attention_bwd(q, k, v, out, do, lse, qp, kp, causal=True, window=96,
                                    kernel="flash_attention_bwd")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


LSE_WRITERS = [("flash_attention_sm90", 64, 300), ("flash_attention_sm90", 80, 300),
               ("flash_attention_sm90", 128, 300), ("flash_attention", 64, 100),
               ("flash_attention", 80, 100)]


@pytest.mark.parametrize("kernel,D,Sq", LSE_WRITERS)
@pytest.mark.parametrize("edge", [None, "causal_first_key"])
def test_forward_log_sum_exp_matches_plain(cuda_device, kernel, D, Sq, edge):
    """Each writer's log-sum-exp against ``ref.flash_attention_lse_ref``
    within ``ref.flash_lse_tolerance``, causal with a window and padded keys
    (or queries that attend no key, +inf in both); its output against the
    plain flash."""
    q, k, v, qp, kp, _ = _inputs(2, Sq, 333, 8, 2, D, seed=D + Sq)
    q, k, v = (x.to(cuda_device, torch.bfloat16) for x in (q, k, v))
    qp, kp = qp.to(cuda_device), kp.to(cuda_device)
    causal, window = True, 96
    kp[:, -5:] = ref.INT32_MAX
    if edge is not None:                            # queries 0 .. 126 attend no key
        q = q.repeat(1, 3, 1, 1)[:, :300].contiguous()
        qp, kp, causal, window = ref.skip_edge_positions(edge, 2, 300, 333, seed=5)
        qp, kp = torch.from_numpy(qp).to(cuda_device), torch.from_numpy(kp).to(cuda_device)
    out, lse = ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window, kernel=kernel,
                                   return_lse=True)
    plain_out = ref.flash_attention_ref(q, k, v, qp, kp, causal, window)
    limit = ref.flash_bf16_tolerance(q, k, v, qp, kp, causal, window, plain_out)
    assert bool(((out.float() - plain_out.float()).abs() <= limit).all())
    plain = ref.flash_attention_lse_ref(q, k, qp, kp, causal, window)
    empty = torch.isinf(plain)
    assert lse.shape == plain.shape and torch.equal(torch.isposinf(lse), empty)
    assert bool(empty.any()) == (edge is not None)
    lim = ref.flash_lse_tolerance(q, k, qp, kp, causal, window, plain)
    err = (lse - plain).abs()[~empty]
    assert bool((err <= lim[~empty]).all()), float((err / lim[~empty]).max())


@pytest.mark.parametrize("D", [64, 80])
def test_flash_autograd_function_runs_both_kernels(cuda_device, D):
    """Gradcheck-style agreement of ``ops.flash_attention_autograd``: its
    output is the wgmma forward's and its gradients are the wgmma + TMA
    backward's on that output and log-sum-exp, bit for bit; those are within
    the stated limit of the plain backward.  Under ``no_grad`` the
    dispatcher of the models launches the forward alone.  Granite's head
    dim and Zamba2's."""
    from repro_torch.models.attention import attention

    q, k, v, do, qp, kp = _bwd_inputs(cuda_device, 2, 256, 256, 8, 2, D, 0, seed=3)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = ops.launch_counts()
    out = attention(*leaves, qp, kp, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n in ("flash_attention_sm90", "flash_attention_bwd_sm90")) for n in after}
    with torch.no_grad():
        direct, lse = ops.flash_attention(q, k, v, qp, kp, causal=True, return_lse=True)
        assert torch.equal(attention(*leaves, qp, kp, causal=True), direct)
    assert torch.equal(out.detach(), direct)
    want = _bwd_checked(q, k, v, direct, lse, do, qp, kp, True, 0)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_tma_kernels_launch_from_a_fresh_thread(cuda_device):
    """The wgmma kernels encode their tensor maps with the driver, which
    needs a current context.  A thread that has made no CUDA runtime call
    yet has none (autograd's backward thread, when the flash backward is
    its first CUDA work), so each launcher makes it current first.  Each
    kernel runs on a thread of its own and gives what it gives here."""
    import threading

    q, k, v, do, qp, kp = _bwd_inputs(cuda_device, 2, 256, 256, 8, 2, 64, 0, seed=3)
    out, lse = _forward(q, k, v, qp, kp, True, 0)
    grads = ops.flash_attention_bwd(q, k, v, out, do, lse, qp, kp, causal=True)
    got = {}

    def run(name, fn):
        try:
            got[name] = fn()
        except Exception as e:                         # re-raised below, on this thread
            got[name] = e

    for name, fn in (("forward", lambda: _forward(q, k, v, qp, kp, True, 0)),
                     ("backward", lambda: ops.flash_attention_bwd(q, k, v, out, do, lse, qp,
                                                                  kp, causal=True))):
        worker = threading.Thread(target=run, args=(name, fn))
        worker.start()
        worker.join()
        if isinstance(got[name], Exception):
            raise got[name]
    torch.cuda.synchronize()
    for a, b in zip(got["forward"] + got["backward"], (out, lse) + tuple(grads)):
        assert torch.equal(a, b)


def test_flash_backward_refuses_what_it_has_no_kernel_for(cuda_device):
    p = torch.zeros((1, 8), device=cuda_device, dtype=torch.int32)
    for dtype, D in ((torch.float32, 48), (torch.bfloat16, 128), (torch.bfloat16, 32)):
        q = torch.zeros((1, 8, 2, D), device=cuda_device, dtype=dtype, requires_grad=True)
        with pytest.raises(ValueError, match="no backward kernel"):
            ops.flash_attention_autograd(q, q, q, p, p)
        lse = torch.zeros((1, 2, 8), device=cuda_device)
        with pytest.raises(ValueError, match="no kernel for"):
            ops.flash_attention_bwd(*(x.detach() for x in (q, q, q, q, q)), lse, p, p)
    q = torch.zeros((1, 8, 2, 32), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for"):   # the wgmma backward: D 64 and 80
        ops.flash_attention_bwd_sm90(q, q, q, q, q, torch.zeros((1, 2, 8), device=cuda_device),
                                     p, p)
    q = torch.zeros((1, 8, 2, 80), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_bwd(q, q, q, q, q, None, p, p)


def test_gated_linear_scan_under_grad_runs_the_backward_kernel(cuda_device):
    """The model's scan on the card: under grad with an input that requires
    grad it goes through ``MambaSSD`` (the state-writing forward, then
    ``mamba_ssd_bwd``); under ``no_grad`` through the serving entry alone."""
    from repro_torch.models import ssm

    x, a, dt, B, C = (t.to(cuda_device) for t in _ssd_inputs(1, 100, 4, 16, 16, 9))
    x.requires_grad_()
    before = (ops.mamba_ssd.launches, ops.mamba_ssd_bwd.launches)
    y = ssm.gated_linear_scan(x, a, dt, B[:, :, None], C[:, :, None], chunk=32)
    (dx,) = torch.autograd.grad(y.sum(), (x,))
    assert (ops.mamba_ssd.launches, ops.mamba_ssd_bwd.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    plain = ref.mamba_ssd_bwd_plain(x.detach(), a, dt, B, C, torch.ones_like(y), chunk=32)[0]
    assert bool(((dx - plain).abs() <= 1e-4 * plain.abs().max() + 1e-4 * plain.abs()).all())
    with torch.no_grad():
        ssm.gated_linear_scan(x, a, dt, B[:, :, None], C[:, :, None], chunk=32)
    assert (ops.mamba_ssd.launches, ops.mamba_ssd_bwd.launches) == (before[0] + 2,
                                                                   before[1] + 1)


def _moe_case(dtype, device, seed=0):
    """A MoE layer at a reduced width (d 256, d_ff 128, 40 experts padded
    to 48, top 8), its weights and input drawn with numpy."""
    rng = np.random.default_rng(seed)
    d, f, E, pad = 256, 128, 40, 8
    params = {"router": {"w": rng.normal(0, d ** -0.5, size=(d, E + pad))},
              "wi": {"w": rng.normal(0, d ** -0.5, size=(E + pad, d, f))},
              "wg": {"w": rng.normal(0, d ** -0.5, size=(E + pad, d, f))},
              "wo": {"w": rng.normal(0, f ** -0.5, size=(E + pad, f, d))}}
    params = {n: {"w": torch.from_numpy(v["w"].astype(np.float32)).to(
        device, torch.float32 if n == "router" else dtype)} for n, v in params.items()}
    x = torch.from_numpy(rng.normal(size=(2, 64, d)).astype(np.float32)).to(device, dtype)
    r = torch.from_numpy(rng.normal(size=(2, 64, d)).astype(np.float32)).to(device)
    return params, x, r, E


def _moe_run(params, x, r, E):
    """The layer's output, aux loss and the gradients of sum(y * r) + aux."""
    from repro_torch.models import moe

    leaves = {n: v["w"].clone().requires_grad_() for n, v in params.items()}
    xg = x.clone().requires_grad_()
    y, aux = moe.moe_apply({n: {"w": w} for n, w in leaves.items()}, xg, E, 8)
    ((y.float() * r).sum() + aux).backward()
    return [y.detach(), aux.detach(), xg.grad] + [leaves[n].grad for n in sorted(leaves)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_on_the_card_is_deterministic_and_matches_the_cpu(cuda_device, dtype):
    """Forward and backward twice on the card, bit-equal (gathers only, no
    float atomics); against the CPU on the same weights: f32 within 2e-4 +
    2e-4 |cpu| (the same products, sums in another order); bf16 within 2e-2
    + 2e-2 |cpu| (the expert products' f32 sums in another order, then the
    hidden state's one rounding to bf16 between two products)."""
    params, x, r, E = _moe_case(dtype, cuda_device)
    a, b = _moe_run(params, x, r, E), _moe_run(params, x, r, E)
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    cpu = _moe_run({n: {"w": v["w"].cpu()} for n, v in params.items()}, x.cpu(), r.cpu(), E)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(a, cpu):
        assert bool(torch.isfinite(got.float()).all())
        err = (got.float().cpu() - want.float()).abs()
        assert bool((err <= tol + tol * want.float().abs()).all()), float(err.max())


# the grouped, wide-head scan (mamba_ssd_wide.cu): b, s, h, g, p, n, chunk, steep
SSD_WIDE_CASES = [
    (2, 300, 4, 4, 64, 64, 128, False),     # g = h, a ragged last chunk
    (1, 1000, 4, 2, 256, 256, 128, True),   # g < h (head i reads group i // 2), steep, ragged
    (2, 200, 4, 4, 1, 128, 64, False),      # p = 1: the mLSTM's normaliser
    (2, 300, 6, 3, 100, 48, 48, False),     # a ragged p tile (36 of 64), a half state slab
    (1, 130, 2, 1, 30, 16, 16, True),       # one group at a p mamba_ssd does not take
    (2, 40, 2, 2, 128, 128, 128, False),    # the reduced xLSTM's scan
    (1, 512, 4, 4, 1024, 1024, 128, False), # xlstm-1.3b's widths
    (1, 200, 2, 1, 64, 1040, 64, False),    # n past a cluster's 8 x 128 rows: two clusters
    (1, 256, 2, 2, 130, 256, 128, False),   # p just past a 128-column strip
    (2, 160, 16, 8, 256, 128, 32, False),   # 64 clusters of 8 blocks: more than the card holds
    (1, 300, 4, 2, 2, 256, 128, True),      # p = 2 on the narrow path, g < h, steep
    (1, 200, 2, 2, 4, 1040, 32, False),     # p = 4, the narrow path's two clusters
]


def _wide_inputs(b, s, h, g, p, n, seed, steep=False):
    """mLSTM-like inputs: log_decay = logsigmoid(f) with f around the
    forget-gate bias (3 ... 6), scale = exp(clip(i, -10, 10)), B scaled by
    1 / sqrt(n); ``steep`` decays (-2 ... -6 per token) reach the clip."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p))
    f = rng.normal(size=(b, s, h)) + np.linspace(3.0, 6.0, h)
    a = -rng.uniform(2.0, 6.0, size=(b, s, h)) if steep else -np.logaddexp(0.0, -f)
    dt = np.exp(np.clip(rng.normal(size=(b, s, h)), -10, 10))
    B = rng.normal(size=(b, s, g, n)) / np.sqrt(n)
    C = rng.normal(size=(b, s, g, n))
    return [torch.from_numpy(v.astype(np.float32)) for v in (x, a, dt, B, C)]


@pytest.mark.parametrize("b,s,h,g,p,n,chunk,steep", SSD_WIDE_CASES)
def test_mamba_ssd_wide_kernel_matches_plain(cuda_device, b, s, h, g, p, n, chunk, steep):
    """Within the reference's SSD tolerance 5e-4 + 5e-4 |plain| (3xTF32
    products, f32 sums in another order) of the plain version evaluated in
    float64 (in f32 the plain scan's own in-chunk sums of steep decays at
    chunk 128 round its clipped weights apart by more than that); two calls
    bit-equal (no atomics)."""
    args = [t.to(cuda_device) for t in _wide_inputs(b, s, h, g, p, n, s + p, steep)]
    before = ops.mamba_ssd_wide.launches
    out = ops.mamba_ssd_wide(*args, chunk=chunk)
    assert ops.mamba_ssd_wide.launches == before + 1
    plain = ref.ssd_scan(*(t.double() for t in args), chunk)
    assert out.shape == (b, s, h, p) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    err = (out - plain).abs()
    assert bool((err <= 5e-4 + 5e-4 * plain.abs()).all()), f"max err {float(err.max()):.3e}"
    assert torch.equal(out, ops.mamba_ssd_wide(*args, chunk=chunk))


@pytest.mark.parametrize("b,s,h,g,p,n,chunk,steep", [
    (1, 1000, 4, 2, 256, 256, 128, True),   # the scan, g < h, steep, ragged
    (2, 300, 6, 3, 100, 1040, 48, False),   # two clusters, a ragged p strip
    (2, 200, 4, 4, 1, 128, 64, False),      # the narrow path (the normaliser)
])
def test_mamba_ssd_wide_states_match_plain(cuda_device, b, s, h, g, p, n, chunk, steep):
    """``return_states``: the state entering each chunk, f32 ``(b, chunks, h,
    n, p)``, within the SSD tolerance of the plain scan's in float64; y
    bit-equal to the call without states; one launch each."""
    args = [t.to(cuda_device) for t in _wide_inputs(b, s, h, g, p, n, s + n, steep)]
    before = ops.mamba_ssd_wide.launches
    y, states = ops.mamba_ssd_wide(*args, chunk=chunk, return_states=True)
    assert ops.mamba_ssd_wide.launches == before + 1
    _, plain = ref.ssd_scan(*(t.double() for t in args), chunk, True, True)
    assert states.shape == (b, -(-s // chunk), h, n, p) and states.dtype == torch.float32
    err = (states - plain).abs()
    assert bool((err <= 5e-4 + 5e-4 * plain.abs()).all()), f"max err {float(err.max()):.3e}"
    assert torch.equal(y, ops.mamba_ssd_wide(*args, chunk=chunk))


def test_mamba_ssd_wide_refuses_what_it_has_no_kernel_for(cuda_device):
    x, a, dt, B, C = (t.to(cuda_device) for t in _wide_inputs(1, 40, 4, 2, 16, 16, 0))
    with pytest.raises(TypeError, match="not supported"):
        ops.mamba_ssd_wide(x.bfloat16(), a, dt, B, C)
    with pytest.raises(ValueError, match="chunk"):
        ops.mamba_ssd_wide(x, a, dt, B, C, chunk=24)
    _, _, _, B3, C3 = (t.to(cuda_device) for t in _wide_inputs(1, 40, 4, 3, 16, 16, 0))
    with pytest.raises(ValueError, match="dividing h"):
        ops.mamba_ssd_wide(x, a, dt, B3, C3)
    _, _, _, B8, C8 = (t.to(cuda_device) for t in _wide_inputs(1, 40, 4, 2, 16, 8, 0))
    with pytest.raises(ValueError, match="state n"):
        ops.mamba_ssd_wide(x, a, dt, B8, C8)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.mamba_ssd_wide(x.clone().requires_grad_(), a, dt, B, C)


def test_gated_linear_scan_routes_each_shape_to_its_kernel(cuda_device):
    """Zamba2's shape launches mamba_ssd, the mLSTM's two scans
    mamba_ssd_wide; a wide shape under grad runs mamba_ssd_wide's
    state-writing call and, in the backward pass, mamba_ssd_wide_bwd; nothing
    falls back to the plain scan."""
    from repro_torch.models.ssm import gated_linear_scan

    zx, za, zdt, zB, zC = (t.to(cuda_device) for t in _ssd_inputs(1, 100, 4, 64, 64, 1))
    before = ops.launch_counts()
    gated_linear_scan(zx, za, zdt, zB[:, :, None], zC[:, :, None], chunk=64)
    x, a, dt, B, C = (t.to(cuda_device) for t in _wide_inputs(1, 100, 4, 4, 128, 128, 2))
    gated_linear_scan(x, a, dt, B, C, chunk=128)
    gated_linear_scan(x[..., :1], a, dt, B, C, chunk=128)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **{k: 0 for k in after}, "mamba_ssd": 1, "mamba_ssd_wide": 2}
    with pytest.raises(NotImplementedError, match="factorized=False"):
        gated_linear_scan(x, a, dt, B, C, chunk=128, factorized=False)
    assert ops.launch_counts() == after
    xg = x.clone().requires_grad_()
    gated_linear_scan(xg, a, dt, B, C, chunk=128).sum().backward()
    grown = ops.launch_counts()
    assert {k: grown[k] - after[k] for k in grown} == {
        **{k: 0 for k in grown}, "mamba_ssd_wide": 1, "mamba_ssd_wide_bwd": 1}
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


def test_reduced_xlstm_on_the_card_matches_the_cpu(cuda_device):
    """The reduced xLSTM (f32) on the card against the CPU on the same
    weights: the forward's hidden states within 1e-3 + 1e-3 |cpu| (3xTF32
    scans, f32 sums in another order through 4 blocks), 4 mamba_ssd_wide
    launches (2 mLSTM blocks x 2 scans), and 4 decode steps with none."""
    from repro_torch import configs, models
    from repro_torch.models.dit import _map_tree

    cfg = configs.get_config("xlstm-1.3b").reduced()
    card, cpu = models.build(cfg, cuda_device), models.build(cfg, "cpu")
    params = card.init(0)
    params_cpu = _map_tree(lambda t: t.cpu(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 150)))
    before = ops.mamba_ssd_wide.launches
    got, _ = card.forward(params, {"tokens": tok.to(cuda_device)})
    assert ops.mamba_ssd_wide.launches == before + 4
    want, _ = cpu.forward(params_cpu, {"tokens": tok})
    err = (got.cpu() - want).abs()
    assert bool((err <= 1e-3 + 1e-3 * want.abs()).all()), float(err.max())
    cache, counts = card.init_cache(2, 4), ops.launch_counts()
    for t in range(4):
        card.decode(params, tok[:, t:t + 1].to(cuda_device), cache,
                    torch.full((2,), t, device=cuda_device))
    assert ops.launch_counts() == counts


# ------------------------------------- f32 at head dim 32 and its backward
F32_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window, padded keys
    (2, 16, 16, 4, 4, 32, True, 0, 0),              # the train CLI's reduced layer
    (2, 77, 90, 4, 2, 32, True, 16, 5),             # GQA, reduced danube's window 16, padding
    (2, 64, 64, 4, 1, 32, False, 0, 7),             # one kv head, no causal mask
    (1, 200, 333, 8, 2, 64, True, 96, 5),           # the other head dims of the f32 kernels
    (1, 130, 150, 4, 2, 80, True, 0, 3),
    (1, 100, 120, 4, 4, 128, False, 0, 0),
    (2, 512, 512, 32, 32, 80, True, 0, 0),          # Zamba2's heads in f32, causal
    (2, 2048, 2048, 4, 4, 32, True, 0, 0),          # the CLI's layer at a training length
]


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_flash_forward_and_backward_match_plain(cuda_device, case):
    """f32 flash at D 32 (and the f32 backward at every head dim it takes):
    the forward with and without the log-sum-exp the same output, within
    1e-4 + 1e-4 |plain| of ``ref.flash_attention_ref``, its log-sum-exp
    within 1e-4 + 1e-4 |plain| of ``ref.flash_attention_lse_ref`` (+inf on
    exactly the rows with no key), the backward within 1e-4 + 1e-4 |plain|
    of ``ref.flash_attention_bwd_ref`` (3xTF32 products, f32 sums in
    another order), two backward calls bit-equal; one launch each of
    flash_attention and flash_attention_bwd_f32."""
    B, Sq, Skv, H, KV, D, causal, window, pad = case
    q, k, v, qp, kp, _ = _inputs(B, Sq, Skv, H, KV, D, seed=3)
    do = torch.from_numpy(np.random.default_rng(4).normal(size=(B, Sq, H, D)).astype(np.float32))
    q, k, v, do, qp, kp = (t.to(cuda_device) for t in (q, k, v, do, qp, kp))
    if pad:
        kp[:, -pad:] = ref.INT32_MAX
    before = ops.launch_counts()
    out, lse = ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window,
                                   return_lse=True)
    grads = ops.flash_attention_bwd(q, k, v, out, do, lse, qp, kp, causal=causal, window=window)
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n in ("flash_attention", "flash_attention_bwd_f32")) for n in after}
    assert torch.equal(out, ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window))
    plain = ref.flash_attention_ref(q, k, v, qp, kp, causal, window)
    assert bool(((out - plain).abs() <= 1e-4 + 1e-4 * plain.abs()).all())
    want = ref.flash_attention_lse_ref(q, k, qp, kp, causal, window)
    empty = torch.isinf(want)
    assert torch.equal(torch.isposinf(lse), empty)
    assert bool(((lse - want).abs()[~empty] <= 1e-4 + 1e-4 * want.abs()[~empty]).all())
    for name, g, p in zip(("dq", "dk", "dv"), grads,
                          ref.flash_attention_bwd_ref(q, k, v, out, do, qp, kp, causal, window)):
        err = (g - p).abs()
        assert bool((err <= 1e-4 + 1e-4 * p.abs()).all()), f"{name}: {float(err.max()):.3e}"
    again = ops.flash_attention_bwd(q, k, v, out, do, lse, qp, kp, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


WIDE_BWD_CASES = [
    (2, 300, 4, 4, 64, 64, 128, False),     # g = h, a ragged last chunk
    (1, 1000, 4, 2, 256, 256, 128, True),   # g < h, steep (the clip's gradient mask), ragged
    (2, 200, 4, 4, 1, 128, 64, False),      # p = 1: the mLSTM's normaliser
    (2, 300, 6, 3, 100, 48, 48, False),     # ragged p and n tiles, 4-byte copies
    (1, 130, 2, 1, 30, 16, 16, True),       # one group, chunk 16
    (2, 40, 2, 2, 128, 128, 128, False),    # the reduced xLSTM's scan
    (2, 300, 4, 2, 64, 144, 128, True),     # n 144: a cluster of two blocks, the second ragged
    (1, 200, 2, 2, 129, 64, 64, False),     # p 129: two strips, the second one column wide
    (1, 300, 4, 2, 2, 256, 128, True),      # p = 2 on the narrow path, g < h, steep
    (2, 200, 2, 2, 4, 144, 32, False),      # p = 4 on the narrow path, a two-block cluster
    (2, 200, 3, 1, 3, 144, 32, True),       # p = 3: narrow<4>, one column masked, steep
    (2, 512, 2, 2, 256, 1024, 128, False),  # n 1024: a cluster of 8 blocks, two strips
    (1, 200, 2, 2, 64, 1040, 32, False),    # n 1040: two clusters, their shares of dx summed
    (1, 200, 2, 2, 4, 1040, 32, False),     # the same on the narrow path
]


@pytest.mark.parametrize("b,s,h,g,p,n,chunk,steep", WIDE_BWD_CASES)
def test_mamba_ssd_wide_bwd_kernel_matches_plain(cuda_device, b, s, h, g, p, n, chunk, steep):
    """Each gradient within ``1e-4 max|plain| + 1e-4 |plain|`` of
    ``ref.ssd_scan_bwd`` evaluated in float64 (mamba_ssd_bwd's tolerance:
    3xTF32 products and f32 sums in another order), on the forward kernel's
    states; the states within the forward's 5e-4 + 5e-4 |plain|; two calls
    bit-equal."""
    args = [t.to(cuda_device) for t in _wide_inputs(b, s, h, g, p, n, s + p + 1, steep)]
    dy = torch.from_numpy(np.random.default_rng(s).normal(size=(b, s, h, p)).astype(
        np.float32)).to(cuda_device)
    before = ops.launch_counts()
    y, states = ops.mamba_ssd_wide(*args, chunk=chunk, return_states=True)
    got = ops.mamba_ssd_wide_bwd(*args, dy, states, chunk=chunk)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **{k: 0 for k in after}, "mamba_ssd_wide": 1, "mamba_ssd_wide_bwd": 1}
    assert torch.equal(y, ops.mamba_ssd_wide(*args, chunk=chunk))
    _, want_states = ref.ssd_scan(*(t.double() for t in args), chunk, True, True)
    assert bool(((states - want_states).abs() <= 5e-4 + 5e-4 * want_states.abs()).all())
    want = ref.ssd_scan_bwd(*(t.double() for t in args), dy.double(), chunk)
    for name, gv, w in zip(("dx", "dlog_decay", "dscale", "dB", "dC"), got, want):
        assert gv.shape == w.shape and bool(torch.isfinite(gv).all()), name
        err = (gv - w).abs()
        assert bool((err <= 1e-4 * (w.abs().max() + w.abs())).all()), \
            f"{name}: {float((err / (1e-4 * (w.abs().max() + w.abs()))).max()):.3f} of the limit"
    again = ops.mamba_ssd_wide_bwd(*args, dy, states, chunk=chunk)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.parametrize("b,s,h,g,p,n,chunk,steep", [
    (1, 300, 4, 2, 64, 144, 128, True), (2, 200, 2, 2, 1, 256, 64, False),
    (1, 200, 2, 2, 64, 1040, 32, False)])
def test_mamba_ssd_wide_bwd_without_dx_leaves_the_rest_bit_equal(cuda_device, b, s, h, g, p,
                                                                    n, chunk, steep):
    """``need_dx=False`` (the normaliser's constant x) returns None for dx
    and the other four gradients bit-equal to the call with dx, on the
    sweep, the narrow launch and past one cluster (n 1040)."""
    args = [t.to(cuda_device) for t in _wide_inputs(b, s, h, g, p, n, s + n, steep)]
    dy = torch.from_numpy(np.random.default_rng(n).normal(size=(b, s, h, p)).astype(
        np.float32)).to(cuda_device)
    _, states = ops.mamba_ssd_wide(*args, chunk=chunk, return_states=True)
    full = ops.mamba_ssd_wide_bwd(*args, dy, states, chunk=chunk)
    before = ops.mamba_ssd_wide_bwd.launches
    part = ops.mamba_ssd_wide_bwd(*args, dy, states, chunk=chunk, need_dx=False)
    assert ops.mamba_ssd_wide_bwd.launches == before + 1
    assert part[0] is None and full[0] is not None
    assert all(torch.equal(u, v) for u, v in zip(full[1:], part[1:]))


def test_mamba_ssd_wide_bwd_refuses_what_it_has_no_kernel_for(cuda_device):
    x, a, dt, B, C = (t.to(cuda_device) for t in _wide_inputs(1, 40, 4, 2, 16, 16, 0))
    _, states = ops.mamba_ssd_wide(x, a, dt, B, C, chunk=16, return_states=True)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="states must be"):
        ops.mamba_ssd_wide_bwd(x, a, dt, B, C, x, states[:, :1], chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ops.mamba_ssd_wide_autograd(x.requires_grad_(), a, dt, B, C, chunk=24)
    assert ops.launch_counts() == before


TRAIN_CLI_ARCHS = ("granite-3-2b", "zamba2-2.7b", "xlstm-1.3b")
TRAIN_CLI_TOL = 1e-4    # each step's loss, card against CPU: f32, sums in another order


def _smoke():
    """``chip_smoke`` (JAX-free), for its ``cpu_drawn_init``: the card's and
    the CPU's generators differ, so both CLI runs draw their weights on the
    CPU."""
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")



@pytest.mark.parametrize("arch", TRAIN_CLI_ARCHS)
def test_train_cli_on_the_card(cuda_device, tmp_path, arch):
    """``launch.train.main`` on the card (the arguments of
    ``test_torch_checkpoint.test_train_cli_on_the_cpu``) for one arch of the
    dense, hybrid and xLSTM families: the f32 flash kernels at head dim 32
    launched (the scans' kernels too where the family has them), each
    step's loss within TRAIN_CLI_TOL relative of the CPU run from the same
    weights."""
    from repro_torch.launch import train as train_cli

    losses, counts = {}, {}
    for dev in ("cuda", "cpu"):
        before = ops.launch_counts()
        with _smoke().cpu_drawn_init():
            rep = train_cli.main(["--arch", arch, "--steps", "4", "--batch", "2", "--seq",
                                  "16", "--ckpt-every", "2", "--ckpt-dir",
                                  str(tmp_path / dev), "--device", dev])
        after = ops.launch_counts()
        counts[dev] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert rep.final_step == 4 and rep.restarts == 0
        losses[dev] = [rep.losses[i] for i in range(4)]
    assert counts["cpu"] == {}
    want = {"xlstm-1.3b": {"mamba_ssd_wide", "mamba_ssd_wide_bwd"},
            "zamba2-2.7b": {"flash_attention", "flash_attention_bwd_f32", "mamba_ssd",
                            "mamba_ssd_bwd"},
            "granite-3-2b": {"flash_attention", "flash_attention_bwd_f32"}}[arch]
    assert set(counts["cuda"]) == want
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=TRAIN_CLI_TOL)
