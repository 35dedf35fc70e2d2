"""Building blocks of the DiT and the hybrid LM, as plain functions on tensors.

Dense weights keep the reference's ``(in, out)`` layout: ``dense`` is
``x @ w``, so weights carried over from the JAX package need no
transpose.  Matmuls accumulate in f32 and cast back to the input's
dtype (``repro/models/layers.py:dense``); ``unembed`` keeps its f32
logits.
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


def rmsnorm_init(d: int, dtype=torch.float32,
                 device: Optional[torch.device] = None):
    """``{"scale": ones (d,)}`` (f32, as the reference keeps norm scales)."""
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def layernorm_init(d: int, dtype=torch.float32,
                   device: Optional[torch.device] = None):
    """``{"scale": ones (d,), "bias": zeros (d,)}`` (f32)."""
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def mlp_init(d: int, ff: int, generator: torch.Generator, dtype=torch.bfloat16,
             device: Optional[torch.device] = None):
    """SwiGLU weights ``{"wi" | "wg": {"w": (d, ff)}, "wo": {"w": (ff, d)}}``,
    drawn in that order."""
    return {nm: {"w": dense_init(i, o, generator, dtype, device=device)}
            for nm, (i, o) in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d)))}


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


# ------------------------------------------------------------ LM pieces
def embedding_init(vocab: int, d: int, generator: torch.Generator, dtype=torch.bfloat16,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """``(vocab, d)`` table, N(0, 1) * 0.02."""
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


def embed(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return emb[tokens]


def unembed(emb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ emb^T`` in f32, not rounded to the model dtype.  The
    reference multiplies bf16 inputs with an f32 accumulator; a product
    of two bf16 values is exact in f32, so upcasting first computes the
    same sum."""
    return torch.matmul(x.float(), emb.float().t())


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """The LM's rotary embedding over split halves.  x ``(..., seq, heads,
    head_dim)``, positions ``(..., seq)``; computed in f32, cast back."""
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(head_dim, theta), dtype=torch.float32,
                            device=x.device)
    angles = positions[..., :, None].float() * freqs              # (..., s, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_conv1d_init(channels: int, width: int, generator: torch.Generator,
                       dtype=torch.bfloat16, device: Optional[torch.device] = None):
    """Depthwise conv weights ``{"w": (width, channels), "b": (channels,)}``
    (fan-in ``width``, as the reference's initializer reads its shape)."""
    return {"w": dense_init(width, channels, generator, dtype, device=device),
            "b": torch.zeros((channels,), dtype=dtype, device=device)}


def causal_conv1d(params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over ``(batch, seq, channels)``, in f32, cast
    back to x's dtype."""
    w = params["w"].float()
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = torch.addcmul(y, xp[:, i:i + s], w[i])
    return (y + params["b"].float()).to(x.dtype)


def causal_conv1d_update(params, x_t: torch.Tensor, conv_state: torch.Tensor):
    """One decode token: x_t ``(b, c)``, state ``(b, width - 1, c)``.
    Returns the conv output in x_t's dtype and the new state."""
    window = torch.cat([conv_state, x_t[:, None, :].to(conv_state.dtype)], dim=1)
    y = torch.einsum("bwc,wc->bc", window.float(), params["w"].float()) \
        + params["b"].float()
    return y.to(x_t.dtype), window[:, 1:, :]
