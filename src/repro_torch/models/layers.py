"""Building blocks of the DiT, as plain functions on tensors.

Dense weights keep the reference's ``(in, out)`` layout: ``dense`` is
``x @ w``, so weights carried over from the JAX package need no
transpose.  Matmuls accumulate in f32 and cast back to the input's
dtype (``repro/models/layers.py:dense``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(in_dim: int, out_dim: int, generator: torch.Generator,
               dtype=torch.bfloat16, scale: float = 1.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Fan-in truncated normal ``(in, out)``: N(0, 1) cut at +-2, times
    ``sqrt(scale / fan_in) / 0.87962566`` (flax's stddev correction)."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (w * (math.sqrt(scale / in_dim) / 0.87962566)).to(dtype)


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an f32 accumulator, cast to ``x``'s dtype."""
    if w.dtype == x.dtype:
        # one matmul call: bf16 products accumulate in f32 on the card
        return torch.matmul(x, w)
    ct = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(ct), w.to(ct)).to(x.dtype)


def rmsnorm(x: torch.Tensor, eps: float = 1e-5,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def mlp(wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``wo(silu(wg x) * wi x)``."""
    return dense(wo, F.silu(dense(wg, x)) * dense(wi, x))


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def sinusoidal_embedding(t: torch.Tensor, dim: int,
                         max_period: float = 10_000.0) -> torch.Tensor:
    """Diffusion timestep embedding.  t: (...,) -> (..., dim), f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
