"""Attention: the plain dense and chunked versions, and the dispatcher.

``attention_dense`` and ``attention_chunked`` are plain PyTorch ports of
``repro/models/attention.py`` (same masks, same f32 math).  ``attention``
sends CUDA tensors to the hand-written flash kernel
(``kernels/ops.flash_attention``) and CPU tensors to ``attention_chunked``,
as the reference DiT does (``repro/models/dit.py:_attn``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import NEG_INF, attention_mask


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
    """Flash kernel for CUDA tensors, ``attention_chunked`` for CPU ones."""
    if q.is_cuda:
        return kernel_ops.flash_attention(
            q, k, v, q_positions, kv_positions, causal=causal, window=window,
            kv_len=kv_len,
        )
    return attention_chunked(q, k, v, q_positions, kv_positions, causal,
                             window, kv_len, kv_chunk)
