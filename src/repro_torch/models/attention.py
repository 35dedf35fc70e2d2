"""Attention: the plain dense and chunked versions, the dispatcher, and
the LM's GQA block with its one-token decode.

``attention_dense`` and ``attention_chunked`` are plain PyTorch ports of
``repro/models/attention.py`` (same masks, same f32 math).  ``attention``
sends CUDA tensors to the hand-written flash kernel
(``kernels/ops.flash_attention``) and CPU tensors to ``attention_chunked``,
as the reference DiT does (``repro/models/dit.py:_attn``).  A CUDA call
that needs a gradient (grad mode on, an input that requires grad: a
training step) goes through ``ops.flash_attention_autograd``, whose
backward is the hand-written backward kernel; a call under ``no_grad``
(serving) launches the forward alone.  ``gqa_apply``
and ``decode_attention`` go through ``attention`` too: the reference's
``decode_attention`` calls ``attention_chunked`` directly, and the
dispatcher computes the same function.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import NEG_INF, attention_mask
from .layers import apply_rope, dense, dense_init


def _mask_bias(q_pos, kv_pos, causal: bool, window: int, kv_len=None):
    """(B, Sq, Skv) additive bias: 0 where attendable, NEG_INF elsewhere."""
    ok = attention_mask(q_pos, kv_pos, causal, window)
    if kv_len is not None:
        ok = ok & (kv_pos[:, None, :] < kv_len[:, None, None])
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def attention_dense(q, k, v, q_positions, kv_positions, causal: bool = True,
                    window: int = 0, kv_len=None) -> torch.Tensor:
    """Reference attention, O(Sq*Skv) memory.  q (B,Sq,H,D), k/v (B,Skv,KV,D)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / math.sqrt(D)
    bias = _mask_bias(q_positions, kv_positions, causal, window, kv_len)
    scores = scores + bias[:, None, None, :, :]
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention_chunked(q, k, v, q_positions, kv_positions, causal: bool = True,
                      window: int = 0, kv_len=None,
                      kv_chunk: int = 2048) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the flash recurrence)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if Skv <= kv_chunk:
        return attention_dense(q, k, v, q_positions, kv_positions, causal,
                               window, kv_len)
    qg = q.reshape(B, Sq, KV, G, D).float()
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, kv_chunk):
        # the reference pads a short last chunk with int32-max slots; the
        # two differ only on a query row that has no key to attend
        k_i = k[:, c0:c0 + kv_chunk].float()
        v_i = v[:, c0:c0 + kv_chunk].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_i) * scale
        bias = _mask_bias(q_positions, kv_positions[:, c0:c0 + kv_chunk],
                          causal, window, kv_len)
        s = s + bias[:, None, None, :, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, v_i)
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def attention(q, k, v, q_positions, kv_positions, causal: bool = True,
              window: int = 0, kv_len=None, kv_chunk: int = 2048) -> torch.Tensor:
    """Flash kernel for CUDA tensors (with its backward kernel when a
    gradient is needed), ``attention_chunked`` for CPU ones."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return kernel_ops.flash_attention_autograd(
                q, k, v, q_positions, kv_positions, causal=causal, window=window,
                kv_len=kv_len)
        return kernel_ops.flash_attention(
            q, k, v, q_positions, kv_positions, causal=causal, window=window,
            kv_len=kv_len,
        )
    return attention_chunked(q, k, v, q_positions, kv_positions, causal,
                             window, kv_len, kv_chunk)


def gqa_init(d_model: int, num_heads: int, num_kv_heads: int, head_dim: int,
             generator: torch.Generator, dtype=torch.bfloat16,
             out_dim: Optional[int] = None, device: Optional[torch.device] = None):
    """``{"q"|"k"|"v"|"o": {"w": (in, out)}}``, the reference's tree."""
    def w(i, o):
        return {"w": dense_init(i, o, generator, dtype, device=device)}

    return {"q": w(d_model, num_heads * head_dim), "k": w(d_model, num_kv_heads * head_dim),
            "v": w(d_model, num_kv_heads * head_dim),
            "o": w(num_heads * head_dim, out_dim or d_model)}


def gqa_apply(params, x: torch.Tensor, positions: torch.Tensor, rope_theta: float,
              num_heads: int, num_kv_heads: int, head_dim: int, causal: bool = True,
              window: int = 0, kv_source: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None, use_rope: bool = True,
              kv_chunk: int = 2048) -> torch.Tensor:
    """Self- or cross-attention block: projections, RoPE, attention, out
    projection.  x ``(B, S, d)``, positions ``(B, S)``."""
    B, S, _ = x.shape
    src = x if kv_source is None else kv_source
    Skv = src.shape[1]
    q = dense(params["q"]["w"], x).reshape(B, S, num_heads, head_dim)
    k = dense(params["k"]["w"], src).reshape(B, Skv, num_kv_heads, head_dim)
    v = dense(params["v"]["w"], src).reshape(B, Skv, num_kv_heads, head_dim)
    if kv_positions is None:
        kv_positions = positions if kv_source is None else (
            torch.arange(Skv, device=x.device)[None, :].expand(B, Skv))
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kv_positions, rope_theta)
    out = attention(q, k, v, positions, kv_positions, causal=causal, window=window,
                    kv_chunk=kv_chunk)
    return dense(params["o"]["w"], out.reshape(B, S, num_heads * head_dim))


def decode_attention(params, x_t: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, position: torch.Tensor, rope_theta: float,
                     num_heads: int, num_kv_heads: int, head_dim: int, window: int = 0,
                     use_rope: bool = True, kv_chunk: int = 8192):
    """One-token decode: project, write k/v at ``position``, attend.

    x_t ``(B, 1, d)``, caches ``(B, S_max, KV, D)``, position ``(B,)``.
    Returns ``(out (B, 1, d), cache_k, cache_v)``.  Unlike the reference,
    which returns new arrays, the caches are updated in place and returned
    as they are.  A position outside ``[0, S_max)`` writes the slot the
    reference's ``dynamic_update_slice`` writes (a negative one counted
    from the end, then clamped into the cache).  The query attends every slot below ``position + 1``
    (the full-cache branch); the reference's sliding-window branch
    (``0 < window < S_max``) is not ported and raises (ROADMAP Queue 1
    item 12).
    """
    B = x_t.shape[0]
    S_max = cache_k.shape[1]
    if 0 < window < S_max:
        raise NotImplementedError(
            "decode_attention: the sliding-window branch is not ported yet "
            "(ROADMAP Queue 1 item 12)")
    q = dense(params["q"]["w"], x_t).reshape(B, 1, num_heads, head_dim)
    k = dense(params["k"]["w"], x_t).reshape(B, 1, num_kv_heads, head_dim)
    v = dense(params["v"]["w"], x_t).reshape(B, 1, num_kv_heads, head_dim)
    pos2d = position[:, None]
    if use_rope:
        q = apply_rope(q, pos2d, rope_theta)
        k = apply_rope(k, pos2d, rope_theta)
    # the reference writes with dynamic_update_slice, which takes a
    # negative start from the end and clamps it into the cache: position
    # S_max or past writes the last slot, -1 the last, -S_max - 1 the
    # first; kv_len stays position + 1
    rows = torch.arange(B, device=x_t.device)
    slots = position.long()
    slots = torch.where(slots < 0, slots + S_max, slots).clamp(0, S_max - 1)
    cache_k[rows, slots] = k[:, 0]
    cache_v[rows, slots] = v[:, 0]
    kv_pos = torch.arange(S_max, device=x_t.device)[None, :].expand(B, S_max)
    out = attention(q, cache_k, cache_v, pos2d, kv_pos, causal=False, window=window,
                    kv_len=position + 1, kv_chunk=kv_chunk)
    y = dense(params["o"]["w"], out.reshape(B, 1, num_heads * head_dim))
    return y, cache_k, cache_v
