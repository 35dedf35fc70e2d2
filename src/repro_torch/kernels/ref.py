"""Plain PyTorch versions of the port's kernels.

They serve CPU tensors (``kernels/ops.py`` picks them only there) and are
what ``chip_smoke.py`` holds each CUDA kernel against on the card.  They
compute in float32 whatever the input type, like the TPU kernels did.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

NEG_INF = -1.0e30
INT32_MAX = 2**31 - 1          # marks a padded kv slot: always masked


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                   window: int) -> torch.Tensor:
    """(B, Sq, Skv) bool: True where query ``i`` may attend key ``j``."""
    qp = q_pos[:, :, None].long()
    kp = kv_pos[:, None, :].long()
    ok = kp < INT32_MAX
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok.expand(qp.shape[0], qp.shape[1], kp.shape[2])


def flash_attention_ref(q, k, v, q_positions, kv_positions,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention with the flash kernel's semantics.

    q ``(B, Sq, H, D)``, k/v ``(B, Skv, KV, D)``; query head ``h`` reads kv
    head ``h // (H // KV)``.  Scores, softmax and the value sum are f32;
    the output is cast to q's dtype.  A query row with no key it may
    attend yields zeros (the online-softmax kernel's ``acc / max(l, 1e-37)``).
    One batch element at a time, so the score matrix stays one
    ``(H, Sq, Skv)`` slab.
    """
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    out = torch.empty_like(q)
    ok_all = attention_mask(q_positions, kv_positions, causal, window)
    for b in range(B):
        qb = q[b].float().transpose(0, 1)                          # (H, Sq, D)
        kb = k[b].float().transpose(0, 1).repeat_interleave(G, 0)  # (H, Skv, D)
        vb = v[b].float().transpose(0, 1).repeat_interleave(G, 0)
        s = torch.matmul(qb, kb.transpose(1, 2)) / math.sqrt(D)
        ok = ok_all[b][None]
        s = torch.where(ok, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * ok
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
        out[b] = (torch.matmul(p, vb) / l).transpose(0, 1).to(q.dtype)
    return out


def flash_decode_plain(q, k, v, q_positions, kv_positions, causal: bool = True,
                       window: int = 0, split: int = 1024) -> torch.Tensor:
    """The flash function as ``csrc/flash_decode.cu`` computes it: the keys
    cut into splits of ``split`` keys (the last may be short), a partial
    per split and query row (m, the largest unscaled score among the keys
    it attends; l = sum exp((s - m) / sqrt(D)); acc = the same weights
    times v), then the partials merged in split order: ``M`` the largest m
    of the splits that attend a key, ``out = sum acc_s e^((m_s - M) /
    sqrt(D)) / max(sum l_s e^(...), 1e-37)``.  A split with no attendable
    key adds nothing, so a row with none is zero.  f32, cast to q's
    dtype; shapes and masks as ``flash_attention_ref``."""
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], H // k.shape[2]
    if Skv == 0:
        return torch.zeros_like(q)
    c = 1.0 / math.sqrt(D)
    ok = attention_mask(q_positions, kv_positions, causal, window)[:, None]   # (B, 1, Sq, Skv)
    kf = k.float().transpose(1, 2).repeat_interleave(G, 1)                    # (B, H, Skv, D)
    vf = v.float().transpose(1, 2).repeat_interleave(G, 1)
    s = torch.matmul(q.float().transpose(1, 2), kf.transpose(2, 3))           # (B, H, Sq, Skv)
    parts = []
    for a in range(0, Skv, split):
        ss, oks = s[..., a:a + split], ok[..., a:a + split]
        m = torch.where(oks, ss, -math.inf).amax(-1)                          # (B, H, Sq)
        p = torch.where(oks, torch.exp((ss - m[..., None]) * c), 0.0)
        parts.append((oks.any(-1).expand_as(m), m, p.sum(-1),
                      torch.matmul(p, vf[:, :, a:a + split])))
    M = torch.stack([torch.where(has, m, -math.inf) for has, m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    o = torch.zeros(M.shape + (D,), dtype=torch.float32, device=q.device)
    for has, m, l, acc in parts:                    # in split order
        f = torch.where(has, torch.exp((m - M) * c), 0.0)
        L = L + l * f
        o = o + acc * f[..., None]
    return (o / L.clamp_min(1e-37)[..., None]).transpose(1, 2).to(q.dtype)


def flash_bf16_tolerance(q, k, v, q_positions, kv_positions, causal: bool,
                         window: int, plain: torch.Tensor) -> torch.Tensor:
    """Per-element limit on ``|bf16 kernel - plain|`` for the same inputs.

    The bf16 kernel differs from the plain version in two roundings: its
    probabilities P go to bf16 for the tensor-core P.V product (relative
    error <= 2^-8 each, so <= 2^-8 * sum_j p_j |v_j| / l in the output),
    and both outputs are rounded to bf16 (<= 2^-8 |out| each).  Hence
    ``|kernel - plain| <= 2^-8 * attention(q, k, |v|) + 2^-7 * |plain|``;
    the factor 1.01 and 1e-6 cover the f32 arithmetic around them.
    """
    mean_abs_v = flash_attention_ref(q.float(), k.float(), v.float().abs(), q_positions,
                                     kv_positions, causal, window)
    return 1.01 * (2.0 ** -8 * mean_abs_v + 2.0 ** -7 * plain.float().abs()) + 1e-6


LOG2E = 1.4426950408889634


def flash_attention_lse_ref(q, k, q_positions, kv_positions, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp, as the flash forward kernels write it
    for the backward (``csrc/flash_attention_sm90.cu``, ``csrc/
    flash_attention.cu``) and both backward kernels read it: f32 ``(B, H,
    Sq)``.

    The one convention: log2 units of the scaled scores, ``lse_i = log2
    sum_j exp(q_i.k_j / sqrt(D))`` over the keys row i attends (masks as
    ``attention_mask``), i.e. the natural log-sum-exp times log2(e), so
    that ``P_ij = exp2(q_i.k_j log2(e) / sqrt(D) - lse_i)``; ``+inf`` on a
    row that attends no key, whose P is then 0.  f32, one batch row at a
    time."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    ok_all = attention_mask(q_positions, kv_positions, causal, window)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for b in range(B):
        qb = q[b].float().transpose(0, 1)                          # (H, Sq, D)
        kb = k[b].float().transpose(0, 1).repeat_interleave(G, 0)  # (H, Skv, D)
        s = torch.matmul(qb, kb.transpose(1, 2)) / math.sqrt(D)
        ok = ok_all[b][None]
        s = torch.where(ok, s, -math.inf)
        lse[b] = torch.where(ok.any(-1), torch.logsumexp(s, -1) * LOG2E, math.inf)
    return lse


def flash_lse_tolerance(q, k, q_positions, kv_positions, causal: bool, window: int,
                        plain: torch.Tensor) -> torch.Tensor:
    """Per-row limit ``(B, H, Sq)`` on ``|kernel log-sum-exp - plain|`` (log2
    units, ``plain`` from ``flash_attention_lse_ref``); rows that attend no
    key must be +inf in both, exactly.

    Derived as ``flash_bf16_tolerance`` derives the output's.  A kernel's
    value differs from the plain one through (a) its scores, f32 sums of D
    bf16 products on the tensor cores (<= 2^-16 of ``sum_d |q_d k_jd|``, the
    bound ``flash_bwd_bf16_tolerance`` takes for D-term sums), which move a
    log-sum-exp by at most ``log2(e) / sqrt(D)`` times the largest such
    error over the attended keys; (b) its sum ``l`` of approximate exp2
    terms (relative error <= 2^-21), added in f32 (<= n 2^-24 for the n
    attended keys) and rescaled once a key tile by an approximate exp2 and
    a product (<= 2^-20 a tile, T tiles of 32 keys bounding the kernels'
    32- and 128-key tiles), which moves ``log2 l`` by its relative error
    over ln 2; (c) the f32 arguments of those exp2s, rounded at the size of
    the largest scaled score M of the row (<= 2^-23 M each, the terms' and
    the T rescales'), and the final ``m log2(e) / sqrt(D) + log2 l`` (one
    rounding, <= 2^-22 |lse|, and ``lg2.approx``'s 2^-22).  Hence
    ``|lse - plain| <= 2^-16 log2(e)/sqrt(D) max_j sum_d |q_d k_jd| +
    (2^-21 + n 2^-24 + T 2^-20) / ln 2 + (T + 1) 2^-23 M + 2^-22 (1 +
    |plain|)``; the factor 1.01 and 1e-6 cover the f32 arithmetic of the
    plain version.
    """
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    sl2 = LOG2E / math.sqrt(D)
    T = -(-k.shape[1] // 32)
    ok_all = attention_mask(q_positions, kv_positions, causal, window)
    lim = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for b in range(B):
        qb = q[b].float().transpose(0, 1)
        kb = k[b].float().transpose(0, 1).repeat_interleave(G, 0)
        ok = ok_all[b][None]
        n = ok.sum(-1).float()
        abs_dot = torch.where(ok, torch.matmul(qb.abs(), kb.abs().transpose(1, 2)), 0.0)
        M = torch.where(ok, torch.matmul(qb, kb.transpose(1, 2)).abs() * sl2, 0.0).amax(-1)
        lim[b] = (2.0 ** -16 * sl2 * abs_dot.amax(-1)
                  + (2.0 ** -21 + n * 2.0 ** -24 + T * 2.0 ** -20) / math.log(2.0)
                  + (T + 1) * 2.0 ** -23 * M)
    finite = torch.where(torch.isfinite(plain), plain.abs(), 0.0)
    return 1.01 * (lim + 2.0 ** -22 * (1.0 + finite)) + 1e-6


def _softmax_grad_rows(q, k, v, out, dout, ok, b: int, G: int):
    """Batch row ``b`` of the flash function's softmax gradient, f32, each
    ``(H, Sq, Skv)``: ``P`` (the forward's probabilities, zero on masked
    pairs and on rows with no attendable key), ``dP = dO V^T``, ``Delta =
    rowsum(dO o O)`` ``(H, Sq, 1)`` and ``dS = P o (dP - Delta)``; plus the
    head-major f32 ``q``, ``k``, ``dO`` (k repeated over the G heads of
    its group)."""
    D = q.shape[-1]
    qb = q[b].float().transpose(0, 1)                          # (H, Sq, D)
    kb = k[b].float().transpose(0, 1).repeat_interleave(G, 0)  # (H, Skv, D)
    vb = v[b].float().transpose(0, 1).repeat_interleave(G, 0)
    dob = dout[b].float().transpose(0, 1)
    s = torch.where(ok[b][None], torch.matmul(qb, kb.transpose(1, 2)) / math.sqrt(D), NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * ok[b][None]
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    dp = torch.matmul(dob, vb.transpose(1, 2))
    delta = (dob * out[b].float().transpose(0, 1)).sum(-1, keepdim=True)
    return p, dp, delta, p * (dp - delta), qb, kb, dob


def flash_attention_bwd_ref(q, k, v, out, dout, q_positions, kv_positions,
                            causal: bool = True, window: int = 0):
    """Gradients ``(dq, dk, dv)`` of ``flash_attention_ref`` for the output
    gradient ``dout``, by the softmax-gradient algebra (not autograd), so
    that the backward kernel has an independent check: with ``P`` the
    forward's probabilities (masks as ``attention_mask``: int32-max marks a
    padded key; a row with no attendable key has ``P = 0`` and gets zero
    gradients), ``Delta_i = sum_d dO_id O_id`` from the given forward output
    ``out``, ``dP = dO V^T`` and ``dS = P o (dP - Delta)``:
    ``dQ = dS K / sqrt(D)``, ``dK = dS^T Q / sqrt(D)``, ``dV = P^T dO``;
    with GQA, dK and dV sum over the G query heads of a group.  f32 inside,
    results in the dtypes of q, k and v; one batch row at a time."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    ok = attention_mask(q_positions, kv_positions, causal, window)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        p, _, _, ds, qb, kb, dob = _softmax_grad_rows(q, k, v, out, dout, ok, b, G)
        dq[b] = (torch.matmul(ds, kb) * scale).transpose(0, 1).to(q.dtype)
        dkh = torch.matmul(ds.transpose(1, 2), qb) * scale               # (H, Skv, D)
        dvh = torch.matmul(p.transpose(1, 2), dob)
        dk[b] = dkh.view(KV, G, Skv, D).sum(1).transpose(0, 1).to(k.dtype)
        dv[b] = dvh.view(KV, G, Skv, D).sum(1).transpose(0, 1).to(v.dtype)
    return dq, dk, dv


def flash_bwd_bf16_tolerance(q, k, v, out, dout, q_positions, kv_positions, causal: bool,
                             window: int, plain):
    """Per-element limits ``(dq, dk, dv)`` on ``|bf16 kernel - plain|`` for
    the backward of the same inputs (``plain``: ``flash_attention_bwd_ref``'s
    three results).

    Derived as ``flash_bf16_tolerance`` derives the forward's.  The kernel
    multiplies bf16 inputs on the tensor cores with f32 sums and rounds two
    operands to bf16 on the way: ``P`` for ``dV = P^T dO`` and ``dS`` for
    ``dQ = dS K`` and ``dK = dS^T Q`` (relative error <= 2^-8 each).  Its f32
    sums of n terms add at most ``n 2^-24`` of their absolute sum (n the keys
    for dQ, the G x queries for dK and dV), and its ``dS`` carries the f32
    error of ``dP`` and ``Delta`` (D-term sums, <= 2^-16 of ``|dO| |V|^T``
    and of ``rowsum |dO o O|``, which also covers ``P``'s log-sum-exp,
    written by the forward kernel within ``flash_lse_tolerance``).  Both
    results are rounded to bf16 (<= 2^-8 each).  Hence
    ``|dQ - plain| <= (2^-8 + Skv 2^-24) sqrt(D)^-1 |dS|' |K| + 2^-7 |plain|``,
    ``|dK - plain| <= (2^-8 + G Sq 2^-24) sqrt(D)^-1 |dS|'^T |Q| + ...`` and
    ``|dV - plain| <= (2^-8 + G Sq 2^-24) P^T |dO| + ...``, with ``|dS|' =
    |dS| + 2^-16 P o (|dO| |V|^T + rowsum |dO o O|)``; the factor 1.01 and
    1e-6 cover the f32 arithmetic of the plain version.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    ok = attention_mask(q_positions, kv_positions, causal, window)
    lim = [torch.empty(t.shape, dtype=torch.float32, device=t.device) for t in (q, k, v)]
    f_q, f_kv = 2.0 ** -8 + Skv * 2.0 ** -24, 2.0 ** -8 + G * Sq * 2.0 ** -24
    for b in range(B):
        p, _, _, ds, qb, kb, dob = _softmax_grad_rows(q, k, v, out, dout, ok, b, G)
        vb = v[b].float().abs().transpose(0, 1).repeat_interleave(G, 0)
        dob_abs = dob.abs()
        dob_o = (dob_abs * out[b].float().abs().transpose(0, 1)).sum(-1, keepdim=True)
        ds = ds.abs() + 2.0 ** -16 * p * (torch.matmul(dob_abs, vb.transpose(1, 2)) + dob_o)
        lim[0][b] = (f_q * scale * torch.matmul(ds, kb.abs())).transpose(0, 1)
        dkh = f_kv * scale * torch.matmul(ds.transpose(1, 2), qb.abs())
        dvh = f_kv * torch.matmul(p.transpose(1, 2), dob_abs)
        lim[1][b] = dkh.view(KV, G, Skv, D).sum(1).transpose(0, 1)
        lim[2][b] = dvh.view(KV, G, Skv, D).sum(1).transpose(0, 1)
    return tuple(1.01 * (l + 2.0 ** -7 * g.float().abs()) + 1e-6 for l, g in zip(lim, plain))


def live_tiles_plain(q_pos: torch.Tensor, kv_pos: torch.Tensor, BM: int, BN: int,
                     causal: bool, window: int) -> torch.Tensor:
    """The key tiles a flash kernel visits, in the layout of the wgmma
    kernel's pre-pass (``csrc/flash_common.cuh: live_tiles``): int32
    ``(B, ceil(Sq / BM), ntiles + 1)`` with ``ntiles = ceil(Skv / BN)``.
    Row ``(b, j)`` lists the tiles of BN keys that queries ``j*BM ..``
    of batch row b must visit, in key order: ``2 * tile`` when every pair
    of the tile is attendable (BN valid keys, and each inside the causal
    and window limits of every query of the block), ``2 * tile + 1`` when
    some pair may be masked; then -1, and the count at ``[ntiles]``.

    A tile is listed unless it has no attendable pair judged from the
    block's smallest and largest query positions and the tile's smallest
    and largest valid key positions: no key other than int32-max, or,
    causally, its smallest key above the largest query, or, with a window,
    its largest key at or below the smallest query minus the window.
    """
    qp, kp = q_pos.long(), kv_pos.long()
    B, Sq = qp.shape
    Skv = kp.shape[1]
    nq, nt = -(-Sq // BM), -(-Skv // BN)
    big = torch.iinfo(torch.int64).max
    rows = torch.nn.functional.pad(qp, (0, nq * BM - Sq), value=INT32_MAX).view(B, nq, BM)
    has_row = (torch.arange(nq * BM, device=qp.device) < Sq).view(1, nq, BM)
    qlo = torch.where(has_row, rows, big).amin(-1, keepdim=True)          # (B, nq, 1)
    qhi = torch.where(has_row, rows, -big).amax(-1, keepdim=True)
    keys = torch.nn.functional.pad(kp, (0, nt * BN - Skv), value=INT32_MAX).view(B, 1, nt, BN)
    valid = keys != INT32_MAX
    nvalid = valid.sum(-1)                                                # (B, 1, nt)
    kmin = torch.where(valid, keys, big).amin(-1)
    kmax = torch.where(valid, keys, -big).amax(-1)
    live = (nvalid > 0).expand(B, nq, nt)
    clear = (nvalid == BN).expand(B, nq, nt)
    if causal:
        live = live & (kmin <= qhi)
        clear = clear & (kmax <= qlo)
    if window > 0:
        live = live & (kmax > qlo - window)
        clear = clear & (kmin > qhi - window)
    tiles = torch.arange(nt, device=qp.device)
    entry = torch.where(live, 2 * tiles + (~clear).long(), big)
    entry = entry.sort(dim=-1).values               # the live entries first, in key order
    entry = torch.where(entry == big, -1, entry)
    return torch.cat([entry, live.sum(-1, keepdim=True)], -1).to(torch.int32)


SKIP_EDGE_CASES = ("permuted", "reversed_runs", "padded_interior", "causal_first_key")


def skip_edge_positions(case: str, B: int, Sq: int, Skv: int, seed: int = 0):
    """Positions that put a flash kernel's skipping of masked key tiles at
    its edges; returns int32 numpy ``(q_pos (B, Sq), kv_pos (B, Skv))``,
    ``causal`` and ``window``.  A kernel may skip a tile only when no pair
    in it is attendable, judged from positions, never from indices:

    - ``permuted``: random, non-monotone positions per batch row, causal
      with a window of Skv // 3;
    - ``reversed_runs``: ascending positions reversed inside every run of
      16, so a tile's first key is not its smallest position (causal);
    - ``padded_interior``: keys 128 .. 383 padded (int32-max), so whole
      interior tiles of 32 and of 128 keys hold no key (no mask);
    - ``causal_first_key``: queries at 0 .. Sq-1, keys at 127 ..
      Skv+126, causal with a window of 1, so each query attends exactly
      the key at its own position: for blocks of 64 or 128 queries and
      tiles of 32 or 128 keys some tile's only attendable pair is its
      first key against the block's last query, and queries 0 .. 126
      attend nothing (their rows must be zero).
    """
    rng = np.random.default_rng(seed)
    if case == "permuted":
        qp = np.stack([rng.permutation(Skv)[:Sq] for _ in range(B)])
        kp = np.stack([rng.permutation(Skv) for _ in range(B)])
        causal, window = True, Skv // 3
    elif case == "reversed_runs":
        def runs(a):
            out = a.copy()
            for i in range(0, len(a), 16):
                out[i:i + 16] = a[i:i + 16][::-1]
            return out
        qp = np.broadcast_to(runs(np.arange(Skv - Sq, Skv)), (B, Sq))
        kp = np.broadcast_to(runs(np.arange(Skv)), (B, Skv))
        causal, window = True, 0
    elif case == "padded_interior":
        qp = np.broadcast_to(np.arange(Skv - Sq, Skv), (B, Sq))
        kp = np.broadcast_to(np.arange(Skv), (B, Skv)).copy()
        kp[:, 128:384] = INT32_MAX
        causal, window = False, 0
    elif case == "causal_first_key":
        qp = np.broadcast_to(np.arange(Sq), (B, Sq))
        kp = np.broadcast_to(np.arange(Skv) + 127, (B, Skv))
        causal, window = True, 1
    else:
        raise ValueError(f"unknown skip-edge case {case!r} (one of {SKIP_EDGE_CASES})")
    return (np.ascontiguousarray(qp, np.int32), np.ascontiguousarray(kp, np.int32),
            causal, window)


def latent_blend_ref(preds: torch.Tensor, weights: torch.Tensor,
                     normalizer: torch.Tensor, starts: Sequence[int],
                     window: int, extent: int) -> torch.Tensor:
    """Position-aware reconstruction (paper Eqs. 15-17) as K slice-adds.

    ``out[x, f] = sum_k W_k[x - s_k] * preds[k, x - s_k, f] / Z[x]`` with
    an f32 accumulator, cast back to preds' dtype.
    """
    K, W, F = preds.shape
    acc = torch.zeros((extent, F), dtype=torch.float32, device=preds.device)
    for kk in range(K):
        s = int(starts[kk])
        acc[s:s + window] += preds[kk].float() * weights[kk][:, None]
    return (acc / normalizer[:, None]).to(preds.dtype)


def guidance_update_plain(z: torch.Tensor, cond: torch.Tensor, uncond: torch.Tensor,
                          w: float, dt: float) -> torch.Tensor:
    """Fused CFG combine + Euler step: ``z + dt * (u + w * (c - u))`` in f32,
    one rounding per operation in that order, cast back to z's dtype (the
    reference's ``guidance_update_ref``)."""
    u = uncond.float()
    pred = u + (cond.float() - u) * w
    return (z.float() + pred * dt).to(z.dtype)


def int8_quantize_ref(x: torch.Tensor, qmax: int = 127):
    """Per-slab max-abs quantize of ``x`` ``(N, R, F)`` f32: returns the
    int8 wire ``(N, R, F)`` and the N f32 scales.

    ``scale_n = max(max|x_n|, 1e-20) / qmax`` (a NaN in the slab makes it
    NaN), then ``clip(round_half_even(x_n / scale_n), -qmax, qmax)``:
    ``IntCodec.encode`` per slab.  Both divisions are tensor by tensor, so
    the card divides too (PyTorch multiplies by the reciprocal of a host
    scalar divisor on CUDA, which would round differently).
    """
    amax = x.abs().amax(dim=(1, 2))
    floor = torch.tensor(1e-20, dtype=torch.float32, device=x.device)
    scale = torch.maximum(amax, floor) / torch.tensor(float(qmax), device=x.device)
    q = torch.round(x / scale[:, None, None]).clamp(-qmax, qmax)
    return q.to(torch.int8), scale


def dequant_blend_ref(wire: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
                      normalizer: torch.Tensor, starts: Sequence[int], window: int,
                      extent: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``latent_blend_ref`` of the dequantized windows, in one f32 pass:
    ``out[x, f] = sum_k W_k[x - s_k] * (scale_k * wire[k, x - s_k, f]) / Z[x]``
    in k order, cast to ``out_dtype``."""
    K, W, F = wire.shape
    acc = torch.zeros((extent, F), dtype=torch.float32, device=wire.device)
    for kk in range(K):
        s = int(starts[kk])
        acc[s:s + window] += wire[kk].float() * scales[kk] * weights[kk][:, None]
    return (acc / normalizer[:, None]).to(out_dtype)


def plant_halfway_inputs(slab: torch.Tensor, qmax: int) -> int:
    """Overwrite the head of the contiguous f32 ``slab`` with values whose
    quotient by the slab's scale rounds to another code than their product
    with the scale's reciprocal (they sit at or within a few ulps of a
    code's half-way point), so a quantize kernel that multiplies by the
    reciprocal instead of dividing gets other codes.  ``slab[0]`` becomes
    the slab's max-abs, raised in 1% steps until such values exist.
    Returns how many were planted (at most ``slab.numel() - 1``)."""
    f = np.float32
    flat = slab.view(-1)
    a = float(flat.abs().max())
    for step in range(100):
        amax = f(a * (1 + 0.01 * step))
        s = f(max(amax, f(1e-20))) / f(qmax)
        base = ((np.arange(-qmax, qmax, dtype=np.float64) + 0.5) * np.float64(s)).astype(f)
        cands, lo, hi = [base], base, base
        for _ in range(4):
            lo, hi = np.nextafter(lo, f(-np.inf)), np.nextafter(hi, f(np.inf))
            cands += [lo, hi]
        x = np.concatenate(cands)
        x = x[np.abs(x) <= amax]
        x = x[np.clip(np.rint(x / s), -qmax, qmax) != np.clip(np.rint(x * (f(1) / s)), -qmax, qmax)]
        x = x[:flat.numel() - 1]
        if len(x):
            break
    else:
        raise ValueError("no half-way inputs found")
    flat[0] = float(amax)
    flat[1:1 + len(x)] = torch.from_numpy(x).to(flat.device)
    return len(x)


def ssd_scan(x, log_decay, scale, B, C, chunk: int = 64,
             factorized: bool = True, return_states: bool = False):
    """Chunked scan of the gated linear recurrence, in f32 (a port of
    ``repro/models/ssm.py:gated_linear_scan``, the same formulas in the
    same order)::

        S_t = exp(log_decay_t) S_{t-1} + scale_t * B_t (x) x_t
        y_t = C_t . S_t

    x ``(b, s, h, p)``, log_decay and scale ``(b, s, h)``, B and C
    ``(b, s, g, n)`` with ``g | h``; returns f32 ``(b, s, h, p)`` (f64 for
    an f64 x: the same formulas in double, what the card's checks hold the
    grouped scan kernel to where f32 rounding of the in-chunk sums decides
    the result).
    ``factorized=True`` splits ``exp(cum_i - cum_j)`` at the per-chunk
    centre, ``exp(clip(cum_i - c)) * exp(clip(c - cum_j))`` with the
    exponents clipped to +-60, so the ``(i, j)`` coupling is the
    group-level C.B Gram; ``factorized=False`` is the textbook form with
    the per-head decay matrix.  The inter-chunk ``pscan`` is a loop over
    chunks.  A ragged last chunk is padded with zero decay and input.
    ``return_states`` also returns the state entering each chunk, f32
    ``(b, nc, h, n, p)`` (what ``mamba_ssd``'s state-writing entry writes).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        log_decay = torch.nn.functional.pad(log_decay, (0, 0, 0, pad))
        scale = torch.nn.functional.pad(scale, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xq = x.reshape(b, nc, chunk, g, rep, p).to(ct)
    dtq = scale.reshape(b, nc, chunk, g, rep).to(ct)
    Bq = B.reshape(b, nc, chunk, g, n).to(ct)
    Cq = C.reshape(b, nc, chunk, g, n).to(ct)
    a = log_decay.reshape(b, nc, chunk, g, rep).to(ct)
    cum = torch.cumsum(a, dim=2)                    # within-chunk cumulative
    total = cum[:, :, -1]                           # (b, nc, g, rep)

    lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    cb = torch.einsum("bcign,bcjgn->bcijg", Cq, Bq)                  # (b, nc, Q, Q, g)
    if factorized:
        center = 0.5 * (cum.amax(dim=2, keepdim=True) + cum.amin(dim=2, keepdim=True))
        a_i = torch.exp(torch.clamp(cum - center, -60.0, 60.0))
        b_j = torch.exp(torch.clamp(center - cum, -60.0, 60.0))
        cb = torch.where(lmask[None, None, :, :, None], cb, 0.0)
        v = xq * (dtq * b_j)[..., None]                              # (b, nc, Q, g, r, p)
        y_intra = torch.einsum("bcijg,bcjgrp->bcigrp", cb, v) * a_i[..., None]
    else:
        diff = cum[:, :, :, None] - cum[:, :, None, :]               # (b, nc, i, j, g, r)
        decay = torch.where(lmask[None, None, :, :, None, None], torch.exp(diff), 0.0)
        dx = dtq[..., None] * xq
        y_intra = torch.einsum("bcijgr,bcijg,bcjgrp->bcigrp", decay, cb, dx)

    # chunk summaries: S_c = sum_j exp(total - cum_j) dt_j B_j (x) x_j
    w = torch.exp(total[:, :, None] - cum)                           # (b, nc, Q, g, rep)
    state_c = torch.einsum("bcjgn,bcjgr,bcjgrp->bcgrnp", Bq, w * dtq, xq)
    # inter-chunk recurrence: the state entering chunk c
    S = torch.zeros((b, g, rep, n, p), dtype=ct, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(S)
        S = torch.exp(total[:, c])[..., None, None] * S + state_c[:, c]
    S_in = torch.stack(s_in, dim=1)                                  # (b, nc, g, rep, n, p)
    y_inter = torch.einsum("bcign,bcgrnp->bcigrp", Cq, S_in) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :s]
    if return_states:
        return y, S_in.reshape(b, nc, h, n, p)
    return y


def mamba_ssd_plain(x, log_decay, scale, B, C, chunk: int = 64,
                    return_states: bool = False):
    """The ``mamba_ssd`` kernel's function: ``ssd_scan(factorized=True)``
    with B and C ``(b, s, n)`` given one group axis; y in x's dtype
    (and, with ``return_states``, the f32 states entering each chunk,
    ``(b, nc, h, n, p)``)."""
    out = ssd_scan(x, log_decay, scale, B[:, :, None, :], C[:, :, None, :], chunk, True,
                   return_states)
    if return_states:
        return out[0].to(x.dtype), out[1]
    return out.to(x.dtype)


def ssd_scan_bwd(x, log_decay, scale, B, C, dy, chunk: int = 64):
    """Gradients ``(dx, dlog_decay, dscale, dB, dC)`` of
    ``ssd_scan(factorized=True)`` at the output gradient ``dy``, B and C
    ``(b, s, g, n)`` in g groups with ``g | h`` (head i reads group ``i //
    (h / g)``), in the inputs' shapes: the chunked formulas ``mamba_ssd_bwd``
    and ``mamba_ssd_wide_bwd`` compute, in their order; f32 (f64 for an f64
    x: the same formulas in double, what the card's checks hold the grouped
    backward kernel to).  dB and dC sum the shares of a group's heads in
    head order; every other gradient is per head.  The function
    differentiated is autograd's of ``ssd_scan``: the +-60 clamp passes no
    gradient outside its range, the centre ``(max cum + min cum) / 2``
    passes its gradient to the tied maxima and minima in equal shares, and
    the padding of a ragged last chunk takes no gradient.

    Per (batch, head) and chunk, with ``ai = exp(clip(cum - c))``, ``bj =
    exp(clip(c - cum))``, ``u = dt bj``, ``w = exp(total - cum)``, ``z = w
    dt``, ``ec = exp(cum)``, ``G`` the causal C.B^T of the head's group,
    ``S`` the state entering the chunk and ``dS`` the gradient of the state
    leaving it (a sweep over the chunks in reverse carries it)::

        P = G^T (ai dy),  R = B dS,  dx = u P + z R
        dG = (ai dy)(u x)^T on j <= i
        dC = dG B + ec (dy S^T),  dB = dG^T C + z (x dS^T)   (summed over heads)
        dS <- exp(total) dS + C^T (ec dy)

    then the scalars' chain to dt and to ``cum`` (through ai, bj, w, ec,
    exp(total) and the centre), and ``dlog_decay`` is the reverse cumulative
    sum of ``dcum`` within the chunk."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[-1]
    if h % g or C.shape != B.shape:
        raise ValueError(f"ssd_scan_bwd: B {tuple(B.shape)} and C {tuple(C.shape)} must be "
                         f"(b, s, g, n) with g dividing h {h}")
    rep = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    F = torch.nn.functional
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32

    def chunked(t):                     # (b, s, k, ...) -> (b, nc, k, Q, ...)
        t = F.pad(t.to(ct), (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(b, nc, chunk, *t.shape[2:])
        return t.permute(0, 1, 3, 2, *range(4, t.dim()))

    def per_head(t):                    # (b, s, h, ...) -> (b, nc, g, rep, Q, ...)
        t = chunked(t)
        return t.reshape(b, nc, g, rep, *t.shape[3:])

    xq, dyq = per_head(x), per_head(dy)                      # (b, nc, g, rep, Q, p)
    a, dt = per_head(log_decay), per_head(scale)             # (b, nc, g, rep, Q)
    Bh = chunked(B)[:, :, :, None]                           # (b, nc, g, 1, Q, n)
    Ch = chunked(C)[:, :, :, None]
    cum = torch.cumsum(a, dim=-1)
    total = cum[..., -1]
    mx = cum.amax(dim=-1, keepdim=True)
    mn = cum.amin(dim=-1, keepdim=True)
    center = 0.5 * (mx + mn)
    ea, eb = cum - center, center - cum
    ma = (ea >= -60.0) & (ea <= 60.0)
    mb = (eb >= -60.0) & (eb <= 60.0)
    ai = torch.exp(torch.clamp(ea, -60.0, 60.0))
    bj = torch.exp(torch.clamp(eb, -60.0, 60.0))
    w = torch.exp(total[..., None] - cum)
    ec, et = torch.exp(cum), torch.exp(total)
    u, z = dt * bj, w * dt
    tie_max = (cum == mx).to(ct)
    tie_max = tie_max / tie_max.sum(-1, keepdim=True)
    tie_min = (cum == mn).to(ct)
    tie_min = tie_min / tie_min.sum(-1, keepdim=True)
    lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    G = torch.where(lmask, Ch @ Bh.transpose(-1, -2), 0.0)                # (b, nc, g, 1, Q, Q)
    # the forward's states entering each chunk
    S = torch.zeros((b, g, rep, n, p), dtype=ct, device=x.device)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = et[:, c, ..., None, None] * S + Bh[:, c].transpose(-1, -2) @ (z[:, c, ..., None]
                                                                          * xq[:, c])
    dS = torch.zeros_like(S)
    dxs, das, ddts, dBs, dCs = [], [], [], [], []

    def group_sum(t):                   # (b, g, rep, Q, n) -> (b, Q, g, n), heads in order
        acc = t[:, :, 0]
        for r in range(1, rep):
            acc = acc + t[:, :, r]
        return acc.transpose(1, 2)

    for c in reversed(range(nc)):
        X, DY, Sc = xq[:, c], dyq[:, c], S_in[c]
        V = u[:, c, ..., None] * X
        AD = ai[:, c, ..., None] * DY
        dai = (DY * (G[:, c] @ V)).sum(-1)
        dec = (DY * (Ch[:, c] @ Sc)).sum(-1)
        P = G[:, c].transpose(-1, -2) @ AD
        R = Bh[:, c] @ dS
        dxs.append(u[:, c, ..., None] * P + z[:, c, ..., None] * R)
        du, dz = (X * P).sum(-1), (X * R).sum(-1)
        dG = torch.where(lmask, AD @ V.transpose(-1, -2), 0.0)
        dCs.append(group_sum(dG @ Bh[:, c] + ec[:, c, ..., None] * (DY @ Sc.transpose(-1, -2))))
        dBs.append(group_sum(dG.transpose(-1, -2) @ Ch[:, c]
                             + z[:, c, ..., None] * (X @ dS.transpose(-1, -2))))
        det = (dS * Sc).sum((-1, -2))
        dS = et[:, c, ..., None, None] * dS + Ch[:, c].transpose(-1, -2) @ (ec[:, c, ..., None]
                                                                            * DY)
        # the scalars: dt, then cum through ai, bj, w, ec, exp(total) and the centre
        aic, bjc, wc = ai[:, c], bj[:, c], w[:, c]
        ddts.append(bjc * du + wc * dz)
        dbj, dw = dt[:, c] * du, dt[:, c] * dz
        ga, gb = dai * aic * ma[:, c], dbj * bjc * mb[:, c]
        dcum = ga - gb - dw * wc + dec * ec[:, c]
        dcen = (gb - ga).sum(-1, keepdim=True)
        dcum[..., -1] += (dw * wc).sum(-1) + det * et[:, c]
        dcum = dcum + 0.5 * dcen * (tie_max[:, c] + tie_min[:, c])
        das.append(torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1]))

    def tokens(parts, heads=True):      # per-chunk parts, last chunk first -> (b, s, ...)
        t = torch.stack(parts[::-1], dim=1)
        if heads:                       # (b, nc, g, rep, Q, ...) -> (b, nc, Q, h, ...)
            t = t.reshape(b, nc, h, *t.shape[4:]).transpose(2, 3)
        return t.reshape(b, nc * chunk, *t.shape[3:])[:, :s]

    return (tokens(dxs), tokens(das), tokens(ddts), tokens(dBs, False), tokens(dCs, False))


def mamba_ssd_bwd_plain(x, log_decay, scale, B, C, dy, chunk: int = 64):
    """The ``mamba_ssd_bwd`` kernel's function: ``ssd_scan_bwd`` with B
    and C ``(b, s, n)``; f32 ``(dx, dlog_decay, dscale, dB, dC)``.  It
    derives the states itself (the kernel reads the forward's)."""
    dx, da, ddt, dB, dC = ssd_scan_bwd(x, log_decay, scale, B[:, :, None, :],
                                       C[:, :, None, :], dy, chunk)
    return dx, da, ddt, dB[:, :, 0], dC[:, :, 0]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``; inf and NaN pass."""
    t = t.float().contiguous()
    bits = (t.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(t), bits.view(torch.float32), t)


def split_tf32(t: torch.Tensor):
    """``(hi, lo)`` with ``hi = round_tf32(t)`` and ``lo = round_tf32(t -
    hi)``: ``hi + lo`` is ``t`` to within 2^-22 of ``|t|``."""
    hi = round_tf32(t)
    return hi, round_tf32(t.float() - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the tensor cores take it from f32 operands split by
    ``split_tf32``: 3 passes ``lo.hi + hi.lo + hi.hi`` (3xTF32), or 1
    pass ``hi.hi``; each product exact in f32, sums in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def flash_f32_tile(head_dim: int) -> int:
    """The f32 flash kernels' tile (``csrc/flash_attention.cu``: f32_tile,
    ``csrc/flash_attention_bwd_f32.cu``: tile): the query rows of a block
    and the keys of a staged tile, 64 up to head dim 64 and 32 above."""
    return 64 if head_dim <= 64 else 32


def flash_f32_bwd_query_tile(head_dim: int) -> int:
    """The queries of a staged tile in the f32 backward's dK / dV pass
    (``csrc/flash_attention_bwd_f32.cu``: qtile): 64 at head dim 32, 32 at
    64 and 80, 16 at 128."""
    return {32: 64, 128: 16}.get(head_dim, 32)


def flash_attention_tf32(q, k, v, q_positions, kv_positions, causal: bool = True,
                         window: int = 0, passes: int = 3):
    """The f32 flash kernel's arithmetic on the CPU (``csrc/
    flash_attention.cu``'s f32 kernel): ``(out, lse)``, the function of
    ``flash_attention_ref`` and ``flash_attention_lse_ref``.  S = Q K^T in
    ``tf32_matmul`` of ``passes``; an online softmax in base 2 on unscaled
    scores over key tiles of ``flash_f32_tile`` keys (masked scores
    ``NEG_INF``, zero weight); each tile's P split for ``P V`` in
    ``tf32_matmul`` into a zeroed sum, added to the running output after
    its rescale; ``out = O / max(l, 1e-37)``, ``lse = m log2(e) / sqrt(D) +
    log2 l`` (``+inf`` on a row that attends no key).  f32, out in q's
    dtype."""
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], H // k.shape[2]
    T = flash_f32_tile(D)
    sl2 = LOG2E / math.sqrt(D)
    ok = attention_mask(q_positions, kv_positions, causal, window)[:, None]   # (B, 1, Sq, Skv)
    qf = q.float().transpose(1, 2)                                            # (B, H, Sq, D)
    kf = k.float().transpose(1, 2).repeat_interleave(G, 1)                    # (B, H, Skv, D)
    vf = v.float().transpose(1, 2).repeat_interleave(G, 1)
    s = torch.where(ok, tf32_matmul(qf, kf.transpose(2, 3), passes), NEG_INF)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for a in range(0, Skv, T):
        st, okt = s[..., a:a + T], ok[..., a:a + T]
        mx = torch.maximum(m, st.amax(-1))
        corr = torch.exp2((m - mx) * sl2)
        p = torch.where(okt, torch.exp2(st * sl2 - (mx * sl2)[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + tf32_matmul(p, vf[:, :, a:a + T], passes)
        m = mx
    out = (o / l.clamp_min(1e-37)[..., None]).transpose(1, 2).to(q.dtype)
    lse = torch.where(l > 0, m * sl2 + torch.log2(l), math.inf)
    return out, lse


def flash_attention_bwd_tf32(q, k, v, out, dout, lse, q_positions, kv_positions,
                             causal: bool = True, window: int = 0, passes: int = 3):
    """The f32 flash backward's arithmetic on the CPU (``csrc/
    flash_attention_bwd_f32.cu``): ``(dq, dk, dv)``, the function of
    ``flash_attention_bwd_ref``, with P from the forward's log-sum-exp
    ``lse`` (``exp2(s log2(e) / sqrt(D) - lse)``, zero where masked),
    ``Delta = rowsum(dO o O)`` in f32, and every product (S = Q K^T, dP = dO
    V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) in ``tf32_matmul`` of
    ``passes``; dV and dK summed over the G heads of a group in order and,
    for each, its query tiles of ``flash_f32_bwd_query_tile`` rows, dQ over
    key tiles of ``flash_f32_tile`` keys, each tile's product added in f32.
    Results in the dtypes of q, k and v."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, T, TQ = H // KV, flash_f32_tile(D), flash_f32_bwd_query_tile(D)
    scale = 1.0 / math.sqrt(D)
    ok = attention_mask(q_positions, kv_positions, causal, window)[:, None]
    qf, dof, of = (t.float().transpose(1, 2) for t in (q, dout, out))         # (B, H, Sq, D)
    kf = k.float().transpose(1, 2).repeat_interleave(G, 1)                    # (B, H, Skv, D)
    vf = v.float().transpose(1, 2).repeat_interleave(G, 1)
    delta = (dof * of).sum(-1, keepdim=True)
    s = tf32_matmul(qf, kf.transpose(2, 3), passes)
    p = torch.where(ok, torch.exp2(s * (LOG2E * scale) - lse.float()[..., None]), 0.0)
    ds = p * (tf32_matmul(dof, vf.transpose(2, 3), passes) - delta)
    dq = torch.zeros_like(qf)
    for a in range(0, Skv, T):
        dq = dq + tf32_matmul(ds[..., a:a + T], kf[:, :, a:a + T], passes)
    dk = torch.zeros((B, KV, Skv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    grouped = [t.reshape((B, KV, G) + t.shape[2:]) for t in (p, ds, qf, dof)]
    for hh in range(G):
        pg, dsg, qg, dog = (t[:, :, hh] for t in grouped)
        for a in range(0, Sq, TQ):
            dv = dv + tf32_matmul(pg[..., a:a + TQ, :].transpose(2, 3), dog[:, :, a:a + TQ],
                                  passes)
            dk = dk + tf32_matmul(dsg[..., a:a + TQ, :].transpose(2, 3), qg[:, :, a:a + TQ],
                                  passes)
    return ((dq * scale).transpose(1, 2).to(q.dtype), (dk * scale).transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def mamba_ssd_tf32(x, log_decay, scale, B, C, chunk: int = 64,
                   passes: int = 3) -> torch.Tensor:
    """The ``mamba_ssd`` kernel's arithmetic on the CPU: the function of
    ``mamba_ssd_plain`` with each of its four products (the causal Gram
    C.B^T, G.x with G scaled by ``dt_j exp(clip(c - cum_j))``, C.S, and
    ``B^T (exp(total - cum_j) dt_j x_j)``) in ``tf32_matmul`` of
    ``passes``, in the kernel's order of scalings.  f32 out."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    F = torch.nn.functional
    xq = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    a = F.pad(log_decay.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    dt = F.pad(scale.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    Bq = F.pad(B.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    Cq = F.pad(C.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, n)
    cum = torch.cumsum(a, dim=-1)                                    # (b, h, nc, Q)
    total = cum[..., -1]
    center = 0.5 * (cum.amax(dim=-1, keepdim=True) + cum.amin(dim=-1, keepdim=True))
    ai = torch.exp(torch.clamp(cum - center, -60.0, 60.0))
    dtb = dt * torch.exp(torch.clamp(center - cum, -60.0, 60.0))
    wj = torch.exp(total[..., None] - cum) * dt
    ec = torch.exp(cum)
    lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    gram = torch.where(lmask, tf32_matmul(Cq, Bq.transpose(-1, -2), passes), 0.0)
    S = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        gd = gram[:, None, c] * dtb[:, :, c, None, :]               # (b, h, Q, Q)
        yi = tf32_matmul(gd, xq[:, :, c], passes)
        yS = tf32_matmul(Cq[:, None, c], S, passes)
        ys.append(ai[:, :, c, :, None] * yi + ec[:, :, c, :, None] * yS)
        wx = wj[:, :, c, :, None] * xq[:, :, c]                      # (b, h, Q, p)
        S = (torch.exp(total[:, :, c])[..., None, None] * S
             + tf32_matmul(Bq[:, None, c].transpose(-1, -2), wx, passes))
    y = torch.stack(ys, dim=2).permute(0, 2, 3, 1, 4).reshape(b, nc * chunk, h, p)
    return y[:, :s]


# mamba_ssd_wide.cu's scan: state rows a block (its slice of n), blocks a
# cluster, n of one k-group of C.S, tokens of one k-group of the state
# update and of the in-chunk term; p up to WIDE_NARROW_P runs its narrow
# path (f32 FMA)
WIDE_SLICE, WIDE_CLUSTER, WIDE_KGROUP, WIDE_SLAB, WIDE_NARROW_P = 128, 8, 16, 32, 4


def mamba_ssd_wide_tf32(x, log_decay, scale, B, C, chunk: int = 128, passes: int = 3,
                        return_states: bool = False):
    """The ``mamba_ssd_wide`` kernel's passes and arithmetic on the CPU:
    the function of ``ssd_scan`` (B and C ``(b, s, g, n)``, ``g | h``) with
    every product in ``tf32_matmul`` of ``passes`` over one k-group, each
    operand split once as the kernel stages it, and the sums in the
    kernel's order.  f32 ``y`` (and, with ``return_states``, the f32 state
    entering each chunk, ``(b, ceil(s / chunk), h, n, p)``).

    The prep's scalars: the in-chunk prefix sums and the centre in double,
    then the exps in f32 (``ai``, ``dtb``, ``wj``, ``ec``); the causal Gram
    ``G = tril(C B^T)``.  Per chunk, with S the state entering it, for each
    slice r of ``WIDE_SLICE`` state rows (a block):

    (a) ``C.S`` over the slice, as k-groups of ``WIDE_KGROUP`` rows summed
        in order (the block's partial);
    (b) ``S <- exp(total) S``, then ``+= (wj B)^T x`` a slab of
        ``WIDE_SLAB`` tokens at a time (``wj B`` rounded to f32 before its
        split);
    (c) the in-chunk term ``(G dtb) x`` a slab at a time (``G dtb`` rounded
        to f32), and ``y = ai (G dtb x) + ec sum_r partial_r``, the partials
        of a cluster of ``WIDE_CLUSTER`` slices summed in rank order; past
        one cluster, each cluster's y (the first one's with the in-chunk
        term) summed in cluster order.

    For p up to ``WIDE_NARROW_P`` the narrow path, in f32 without TF32
    (``passes`` has no effect): per slice and token the partial of
    ``ai C_i . R_i + ec C_i . S`` with ``R_i = sum_{j<=i} dtb_j x_j B_j``
    (the in-chunk term in prefix form, no Gram), the slices summed in rank
    order; ``S <- exp(total) S + sum_j wj_j x_j B_j``.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    F = torch.nn.functional

    def mm(u, v):
        return tf32_matmul(u, v, passes)

    xq = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, h, p).transpose(2, 3)
    a = F.pad(log_decay.double(), (0, 0, 0, pad)).reshape(b, nc, chunk, h).transpose(2, 3)
    dt = F.pad(scale.float(), (0, 0, 0, pad)).reshape(b, nc, chunk, h).transpose(2, 3)
    Bq = F.pad(B.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, g, n).transpose(2, 3)
    Cq = F.pad(C.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, chunk, g, n).transpose(2, 3)
    Bh = Bq.repeat_interleave(rep, dim=2)                 # (b, nc, h, Q, n): a head's group
    Ch = Cq.repeat_interleave(rep, dim=2)
    cum = torch.cumsum(a, dim=-1)                         # (b, nc, h, Q), double
    total = cum[..., -1:]
    center = 0.5 * (cum.amax(-1, keepdim=True) + cum.amin(-1, keepdim=True))
    ai = torch.exp(torch.clamp((cum - center).float(), -60.0, 60.0))
    dtb = dt * torch.exp(torch.clamp((center - cum).float(), -60.0, 60.0))
    wj = torch.exp((total - cum).float()) * dt
    ec = torch.exp(cum.float())
    et = ec[..., -1]                                      # exp(total)
    slices = [(r0, min(r0 + WIDE_SLICE, n)) for r0 in range(0, n, WIDE_SLICE)]
    clusters = [slices[i:i + WIDE_CLUSTER] for i in range(0, len(slices), WIDE_CLUSTER)]
    def narrow_chunk(c, S):             # p <= WIDE_NARROW_P: y of chunk c, the next state
        X, Cc, Bc = xq[:, c], Ch[:, c], Bh[:, c]
        R = torch.cumsum((dtb[:, c, ..., None] * X)[..., None, :] * Bc[..., None], dim=2)
        v = (ai[:, c, :, :, None, None] * (Cc[..., None] * R)
             + ec[:, c, :, :, None, None] * (Cc[..., None] * S[:, :, None]))
        yc = None
        for cl in clusters:
            part = None
            for r0, r1 in cl:
                d = v[..., r0:r1, :].sum(-2)
                part = d if part is None else part + d
            yc = part if yc is None else yc + part
        dS = ((wj[:, c, ..., None] * X)[..., None, :] * Bc[..., None]).sum(2)
        return yc, et[:, c, :, None, None] * S + dS

    def wide_chunk(c, S):
        X, Cc, Bc = xq[:, c], Ch[:, c], Bh[:, c]
        gd = gram[:, c] * dtb[:, c, :, None, :]           # (b, h, Q, Q), rounded to f32
        yi = None
        for j0, j1 in slabs:
            d = mm(gd[..., j0:j1], X[..., j0:j1, :])
            yi = d if yi is None else yi + d
        yc = None
        for ci, cl in enumerate(clusters):
            part = None
            for r0, r1 in cl:                             # a block: its slice's k-groups
                acc = None
                for k0 in range(r0, r1, WIDE_KGROUP):
                    k1 = min(k0 + WIDE_KGROUP, r1)
                    d = mm(Cc[..., k0:k1], S[..., k0:k1, :])
                    acc = d if acc is None else acc + d
                part = acc if part is None else part + acc
            yk = ec[:, c, :, :, None] * part
            if ci == 0:
                yk = ai[:, c, :, :, None] * yi + yk
            yc = yk if yc is None else yc + yk
        S = et[:, c, :, None, None] * S
        wB = wj[:, c, :, :, None] * Bc                    # (b, h, Q, n), rounded to f32
        for j0, j1 in slabs:
            S = S + mm(wB[..., j0:j1, :].transpose(-1, -2), X[..., j0:j1, :])
        return yc, S

    if p > WIDE_NARROW_P:
        lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
        gram = torch.where(lmask, mm(Cq, Bq.transpose(-1, -2)), 0.0).repeat_interleave(rep, 2)
        slabs = [(j0, min(j0 + WIDE_SLAB, chunk)) for j0 in range(0, chunk, WIDE_SLAB)]
    S = torch.zeros((b, h, n, p), dtype=torch.float32)
    ys, states = [], []
    for c in range(nc):
        states.append(S)
        yc, S = (narrow_chunk if p <= WIDE_NARROW_P else wide_chunk)(c, S)
        ys.append(yc)
    y = torch.stack(ys, dim=1).transpose(2, 3).reshape(b, nc * chunk, h, p)[:, :s]
    if return_states:
        return y, torch.stack(states, dim=1)
    return y


def mamba_ssd_bwd_tf32(x, log_decay, scale, B, C, dy, chunk: int = 64,
                       passes: int = 3):
    """The ``mamba_ssd_bwd`` kernel's pass split and arithmetic on the CPU:
    the function of ``mamba_ssd_bwd_plain`` (B and C ``(b, s, n)``; f32
    ``(dx, dlog_decay, dscale, dB, dC)``), with every product in
    ``tf32_matmul`` of ``passes``.  Per (batch, chunk, head), with the
    scalars of ``ssd_scan_bwd`` and S the forward's state entering the
    chunk (derived here by ``ssd_scan``):

    (a) the local term ``L = C^T (ec dy)``;
    (b) the carry, a sweep over the chunks in reverse: ``dS`` (the gradient
        of the state leaving chunk c) is 0 at the last chunk and
        ``exp(total_{c+1}) dS_{c+1} + L_{c+1}`` before it;
    (c) the chunk-local rest: ``M = dy x^T`` and ``G = C B^T`` on ``j <= i``;
        ``dG = ai_i u_j M``, ``A2 = ai_i u_j G``; ``dx = A2^T dy + z (B dS)``;
        ``E = dy S^T``, ``F = x dS^T``; each head's ``dC = dG B + ec E`` and
        ``dB = dG^T C + z F``; and the scalars' reductions from those
        (``dai = sum_j G u M``, ``du = sum_i G ai M``, ``dec = sum C E``,
        ``dz = sum B F``, ``<dS, S>``), then the chain of ``ssd_scan_bwd``.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    F = torch.nn.functional

    def per_head(t):                    # (b, s, h, ...) -> (b, nc, h, Q, ...)
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(b, nc, chunk, *t.shape[2:])
        return t.permute(0, 1, 3, 2, *range(4, t.dim()))

    def mm(u, v):
        return tf32_matmul(u, v, passes)

    xq, dyq = per_head(x), per_head(dy)                      # (b, nc, h, Q, p)
    a, dt = per_head(log_decay), per_head(scale)             # (b, nc, h, Q)
    Bq = F.pad(B.float(), (0, 0, 0, pad)).reshape(b, nc, 1, chunk, n)
    Cq = F.pad(C.float(), (0, 0, 0, pad)).reshape(b, nc, 1, chunk, n)
    cum = torch.cumsum(a, dim=-1)
    total = cum[..., -1]
    mx = cum.amax(dim=-1, keepdim=True)
    mn = cum.amin(dim=-1, keepdim=True)
    center = 0.5 * (mx + mn)
    ea, eb = cum - center, center - cum
    ma = (ea >= -60.0) & (ea <= 60.0)
    mb = (eb >= -60.0) & (eb <= 60.0)
    ai = torch.exp(torch.clamp(ea, -60.0, 60.0))
    bj = torch.exp(torch.clamp(eb, -60.0, 60.0))
    w = torch.exp(total[..., None] - cum)
    ec, et = torch.exp(cum), torch.exp(total)
    u, z = dt * bj, w * dt
    tie_max = (cum == mx).float()
    tie_max = tie_max / tie_max.sum(-1, keepdim=True)
    tie_min = (cum == mn).float()
    tie_min = tie_min / tie_min.sum(-1, keepdim=True)
    _, S = ssd_scan(x, log_decay, scale, B[:, :, None], C[:, :, None], chunk, True, True)
    S = S.reshape(b, nc, h, n, p)
    # (a) and (b)
    L = mm(Cq.transpose(-1, -2), ec[..., None] * dyq)                    # (b, nc, h, n, p)
    dS = torch.zeros_like(L)
    for c in range(nc - 2, -1, -1):
        dS[:, c] = et[:, c + 1, :, None, None] * dS[:, c + 1] + L[:, c + 1]
    # (c)
    lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    G = torch.where(lmask, mm(Cq, Bq.transpose(-1, -2)), 0.0)            # (b, nc, 1, Q, Q)
    M = torch.where(lmask, mm(dyq, xq.transpose(-1, -2)), 0.0)           # (b, nc, h, Q, Q)
    # ai_i u_j <= dt_j on j <= i; above the diagonal it may overflow, so it
    # is never formed there
    au = torch.where(lmask, ai[..., :, None] * u[..., None, :], 0.0)
    dG, A2 = au * M, au * G
    dai = (G * u[..., None, :] * M).sum(-1)
    du = (G * ai[..., :, None] * M).sum(-2)
    dx = mm(A2.transpose(-1, -2), dyq) + z[..., None] * mm(Bq, dS)
    E = mm(dyq, S.transpose(-1, -2))
    Fm = mm(xq, dS.transpose(-1, -2))
    dC = (mm(dG, Bq) + ec[..., None] * E).sum(2)                          # (b, nc, Q, n)
    dB = (mm(dG.transpose(-1, -2), Cq) + z[..., None] * Fm).sum(2)
    dec, dz = (Cq * E).sum(-1), (Bq * Fm).sum(-1)
    det = (dS * S).sum((-1, -2))
    # the scalars' chain (ssd_scan_bwd's)
    ddt = bj * du + w * dz
    dbj, dw = dt * du, dt * dz
    ga, gb = dai * ai * ma, dbj * bj * mb
    dcum = ga - gb - dw * w + dec * ec
    dcen = (gb - ga).sum(-1, keepdim=True)
    dcum[..., -1] += (dw * w).sum(-1) + det * et
    dcum = dcum + 0.5 * dcen * (tie_max + tie_min)
    da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])

    def tokens(t):                      # (b, nc, h, Q, ...) -> (b, s, h, ...)
        t = t.transpose(2, 3)
        return t.reshape(b, nc * chunk, *t.shape[3:])[:, :s]

    return (tokens(dx), tokens(da), tokens(ddt), dB.reshape(b, nc * chunk, n)[:, :s],
            dC.reshape(b, nc * chunk, n)[:, :s])


# mamba_ssd_wide_bwd.cu: state rows a sweep block (its slice of n), most
# blocks a cluster, state rows of a k-group of B dS, tokens of a slab of the
# update, K of a dbc step (p for E and F, tokens for dG B and dG^T C)
WIDE_BWD_KGROUP, WIDE_BWD_SLAB, WIDE_BWD_DBC_K = 16, 32, 32


def mamba_ssd_wide_bwd_tf32(x, log_decay, scale, B, C, dy, chunk: int = 128, passes: int = 3,
                            need_dx: bool = True):
    """The ``mamba_ssd_wide_bwd`` kernel's passes and arithmetic on the CPU:
    the function of ``ssd_scan_bwd`` (B and C ``(b, s, g, n)``, ``g | h``;
    f32 ``(dx, dlog_decay, dscale, dB, dC)``, dx None without
    ``need_dx``) with every tensor-core product in ``tf32_matmul`` of
    ``passes`` over one k-group, the operands as the kernel splits them and
    the sums in its order.  The states are the forward kernel's
    (``mamba_ssd_wide_tf32``).

    The prep's scalars as the forward's (the prefix sums and the centre in
    double, the exps in f32) and the causal Gram ``G``.  qq: ``M = dy x^T``,
    ``dG = (ai_i u_j) M`` and ``A2 = (ai_i u_j) G`` on ``j <= i``, ``dai``,
    ``du``, and with dx the in-chunk term ``A2^T dy``.  The sweep over the
    chunks in reverse, ``dS`` the gradient of the state leaving chunk c:

    (a) ``<dS, S>``, and ``dS`` kept for dbc;
    (b) with dx, each slice's partial ``B dS`` over ``WIDE_SLICE`` state rows
        in k-groups of ``WIDE_BWD_KGROUP`` summed in order, the partials of
        a cluster (``ceil(n / WIDE_SLICE)`` slices, at most
        ``WIDE_CLUSTER``) summed in rank order, and ``dx = A2^T dy + z
        sum_0 (+ z sum_1 ...)`` cluster by cluster;
    (c) ``dS <- exp(total) dS``, then ``+= (ec C)^T dy`` a slab of
        ``WIDE_BWD_SLAB`` tokens at a time (``ec C`` rounded to f32).

    For p up to ``WIDE_NARROW_P`` (b) and (c) in f32 without TF32: ``B dS``
    and ``C^T (ec dy)``.  dbc, per group, the heads in order: ``E = dy
    S^T`` (``F = x dS^T``) in k-groups of ``WIDE_BWD_DBC_K`` columns of p,
    ``sum += ec E`` (``z F``), ``dec = sum C E`` (``dz = sum B F``), then
    ``sum += dG B`` (``dG^T C``) a k-group of ``WIDE_BWD_DBC_K`` tokens at a
    time.  Then the scalars' chain of ``ssd_scan_bwd``.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    F = torch.nn.functional

    def mm(u, v):
        return tf32_matmul(u, v, passes)

    def per_head(t):                    # (b, s, h, ...) -> (b, nc, h, Q, ...)
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(b, nc, chunk, *t.shape[2:])
        return t.permute(0, 1, 3, 2, *range(4, t.dim()))

    xq, dyq = per_head(x.float()), per_head(dy.float())         # (b, nc, h, Q, p)
    a, dt = per_head(log_decay.double()), per_head(scale.float())
    Bq, Cq = per_head(B.float()), per_head(C.float())           # (b, nc, g, Q, n)
    Bh, Ch = Bq.repeat_interleave(rep, 2), Cq.repeat_interleave(rep, 2)
    cum = torch.cumsum(a, dim=-1)                               # double
    total = cum[..., -1]
    mx = cum.amax(-1, keepdim=True)
    mn = cum.amin(-1, keepdim=True)
    center = 0.5 * (mx + mn)
    ea, eb = (cum - center).float(), (center - cum).float()
    ai = torch.exp(torch.clamp(ea, -60.0, 60.0))
    bj = torch.exp(torch.clamp(eb, -60.0, 60.0))
    w = torch.exp((total[..., None] - cum).float())
    ec, et = torch.exp(cum.float()), torch.exp(total.float())
    u, z = dt * bj, w * dt
    ma = ((ea >= -60.0) & (ea <= 60.0)).float()
    mb = ((eb >= -60.0) & (eb <= 60.0)).float()
    tmax, tmin = (cum == mx).float(), (cum == mn).float()
    tw = 0.5 / tmax.sum(-1, keepdim=True) * tmax + 0.5 / tmin.sum(-1, keepdim=True) * tmin
    lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    G = torch.where(lmask, mm(Cq, Bq.transpose(-1, -2)), 0.0).repeat_interleave(rep, 2)
    _, S = mamba_ssd_wide_tf32(x, log_decay, scale, B, C, chunk, passes, return_states=True)
    # qq
    M = mm(dyq, xq.transpose(-1, -2))
    au = torch.where(lmask, ai[..., :, None] * u[..., None, :], 0.0)
    dG, A2 = torch.where(lmask, au * M, 0.0), torch.where(lmask, au * G, 0.0)
    dai = (G * u[..., None, :] * M).sum(-1)
    du = (G * ai[..., :, None] * M).sum(-2)
    dx = mm(A2.transpose(-1, -2), dyq) if need_dx else None
    # the sweep
    narrow = p <= WIDE_NARROW_P
    slices = [(r0, min(r0 + WIDE_SLICE, n)) for r0 in range(0, n, WIDE_SLICE)]
    csize = min(WIDE_CLUSTER, len(slices))
    clusters = [slices[i:i + csize] for i in range(0, len(slices), csize)]
    slabs = [(j0, min(j0 + WIDE_BWD_SLAB, chunk)) for j0 in range(0, chunk, WIDE_BWD_SLAB)]
    dS = torch.zeros((b, h, n, p), dtype=torch.float32)
    dS_out, det = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dS_out[c], det[c] = dS, (dS * S[:, c]).sum((-1, -2))
        Bc, Cc, Y = Bh[:, c], Ch[:, c], dyq[:, c]
        if need_dx:
            dxc = dx[:, c]
            for cl in clusters:
                part = None
                for r0, r1 in cl:              # a block: its slice's partial
                    if narrow:
                        acc = Bc[..., r0:r1] @ dS[..., r0:r1, :]
                    else:
                        acc = None
                        for k0 in range(r0, r1, WIDE_BWD_KGROUP):
                            k1 = min(k0 + WIDE_BWD_KGROUP, r1)
                            d = mm(Bc[..., k0:k1], dS[..., k0:k1, :])
                            acc = d if acc is None else acc + d
                    part = acc if part is None else part + acc
                dxc = dxc + z[:, c, ..., None] * part
            dx[:, c] = dxc
        dS = et[:, c, :, None, None] * dS
        eC = ec[:, c, ..., None] * Cc                           # (b, h, Q, n), rounded to f32
        if narrow:
            dS = dS + eC.transpose(-1, -2) @ Y
        else:
            for j0, j1 in slabs:
                dS = dS + mm(eC[..., j0:j1, :].transpose(-1, -2), Y[..., j0:j1, :])
    dS_out, det = torch.stack(dS_out, 1), torch.stack(det, 1)   # (b, nc, h, n, p), (b, nc, h)

    # dbc: a group's heads in order
    def dbc(A, St, scl, dGm, mat, other):
        E = None
        for k0 in range(0, p, WIDE_BWD_DBC_K):
            k1 = min(k0 + WIDE_BWD_DBC_K, p)
            d = mm(A[..., k0:k1], St[..., k0:k1].transpose(-1, -2))
            E = d if E is None else E + d
        dot = (mat * E).sum(-1)
        E, dGm, scl = (t.reshape(b, nc, g, rep, *t.shape[3:]) for t in (E, dGm, scl))
        acc = torch.zeros((b, nc, g, chunk, n), dtype=torch.float32)
        for r in range(rep):
            acc = acc + scl[:, :, :, r, :, None] * E[:, :, :, r]
            for j0 in range(0, chunk, WIDE_BWD_DBC_K):
                j1 = min(j0 + WIDE_BWD_DBC_K, chunk)
                acc = acc + mm(dGm[:, :, :, r, :, j0:j1], other[..., j0:j1, :])
        return acc, dot

    dCq, dec = dbc(dyq, S, ec, dG, Ch, Bq)
    dBq, dz = dbc(xq, dS_out, z, dG.transpose(-1, -2), Bh, Cq)
    # the scalars' chain (ssd_scan_bwd's)
    ddt = bj * du + w * dz
    dbj, dw = dt * du, dt * dz
    ga, gb = dai * ai * ma, dbj * bj * mb
    dcum = ga - gb - dw * w + dec * ec
    cen = (gb - ga).sum(-1, keepdim=True)
    dcum[..., -1] += (dw * w).sum(-1) + det * et
    dcum = dcum + cen * tw
    da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])

    def tokens(t):                      # (b, nc, k, Q, ...) -> (b, s, k, ...)
        t = t.transpose(2, 3)
        return t.reshape(b, nc * chunk, *t.shape[3:])[:, :s]

    return (tokens(dx) if need_dx else None, tokens(da), tokens(ddt), tokens(dBq),
            tokens(dCq))


def mamba_ssd_ref(x, log_decay, scale, B, C) -> torch.Tensor:
    """The textbook SSD oracle of the reference's tests
    (``repro/kernels/ref.py:mamba_ssd_ref``): ``factorized=False`` at
    chunk 32, groups 1, f32 out."""
    return ssd_scan(x, log_decay, scale, B[:, :, None, :], C[:, :, None, :],
                    chunk=32, factorized=False)
