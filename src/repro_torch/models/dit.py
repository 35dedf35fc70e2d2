"""WAN2.1-style video DiT — the paper's denoising network f(.).

A port of ``repro/models/dit.py`` that follows it line by line, bf16
rounding points included: ``dense`` accumulates in f32 and casts to its
input's dtype, tokens and the text context enter in the model dtype, the
time MLP is f32, and the adaLN modulations are computed in f32 and cast.

Latent z: (B, T_lat, H_lat, W_lat, C).  3D-patchified with (p_T, p_H,
p_W) into tokens, processed by DiT blocks (self-attention over all patch
tokens, cross-attention to the encoded text prompt, SwiGLU FFN) with
adaLN timestep modulation, then unpatchified back to a prediction of z's
shape.  RoPE is 3D axial over patch coordinates offset by ``origin``; as
in the reference, the serving path passes no ``origin``, so LP windows
get window-local coordinates.

Weights keep the reference's ``(in, out)`` layout and are never
transposed: ``params_from_numpy`` carries a JAX parameter tree across
as it is, splitting only the layer-stacked ``blocks``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, generator as make_generator, resolve_device
from .attention import attention
from .layers import (
    dense,
    dense_init,
    layernorm,
    mlp,
    rmsnorm,
    rope_frequencies,
    sinusoidal_embedding,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Attn(nn.Module):
    """q/k/v/o projections, each ``(in, out)``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.q = _param(tree["q"]["w"])
        self.k = _param(tree["k"]["w"])
        self.v = _param(tree["v"]["w"])
        self.o = _param(tree["o"]["w"])


class DiTBlock(nn.Module):
    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self.self_attn = _Attn(tree["self_attn"])
        self.cross_attn = _Attn(tree["cross_attn"])
        self.cross_norm_scale = _param(tree["cross_norm"]["scale"])
        self.cross_norm_bias = _param(tree["cross_norm"]["bias"])
        self.mlp_wi = _param(tree["mlp"]["wi"]["w"])
        self.mlp_wg = _param(tree["mlp"]["wg"]["w"])
        self.mlp_wo = _param(tree["mlp"]["wo"]["w"])
        self.ada = _param(tree["ada"]["w"])
        self.ada_b = _param(tree["ada_b"])


def _patchify(z: torch.Tensor, cfg: ArchConfig) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(B,T,H,W,C) -> (B, N_tokens, patch_elems) + patch-grid dims."""
    B, T, H, W, C = z.shape
    pt, ph, pw = cfg.patch_sizes
    nt, nh, nw = T // pt, H // ph, W // pw
    z = z.reshape(B, nt, pt, nh, ph, nw, pw, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return z.reshape(B, nt * nh * nw, pt * ph * pw * C), (nt, nh, nw)


def _unpatchify(tok: torch.Tensor, grid, cfg: ArchConfig, out_shape) -> torch.Tensor:
    B = tok.shape[0]
    nt, nh, nw = grid
    pt, ph, pw = cfg.patch_sizes
    z = tok.reshape(B, nt, nh, nw, pt, ph, pw, cfg.latent_channels)
    return z.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(out_shape)


def _axial_rope_tables(grid, origin, head_dim: int, device,
                       theta: float = 10_000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin ``(1, N, 1, head_dim/2)`` of 3D axial RoPE over (t, h, w)
    patch coordinates offset by ``origin`` (global coordinates)."""
    nt, nh, nw = grid
    d_t = (head_dim // 3) & ~1
    d_h = (head_dim // 3) & ~1
    d_w = head_dim - d_t - d_h
    angles = []
    for ax, (n, o, dd) in enumerate(zip(grid, origin, (d_t, d_h, d_w))):
        freqs = torch.tensor(rope_frequencies(dd, theta), dtype=torch.float32,
                             device=device)
        pos = torch.arange(n, device=device) + int(o)
        a = pos[:, None].float() * freqs                      # (n, dd/2)
        shape = [1, 1, 1, dd // 2]
        shape[ax] = n
        angles.append(a.reshape(shape).expand(nt, nh, nw, dd // 2))
    ang = torch.cat(angles, dim=-1).reshape(1, nt * nh * nw, 1, head_dim // 2)
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    cos, sin = rope
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _positions(batch: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None].expand(batch, n)


def _attn(p: _Attn, x, cfg: ArchConfig, rope=None, context=None,
          kv_chunk: int = 4096) -> torch.Tensor:
    """Bidirectional self- (``context=None``) or cross-attention."""
    B, S, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    src = x if context is None else context
    Skv = src.shape[1]
    q = dense(p.q, x).reshape(B, S, H, D)
    k = dense(p.k, src).reshape(B, Skv, H, D)
    v = dense(p.v, src).reshape(B, Skv, H, D)
    if context is None and rope is not None:
        q = _apply_rope(q, rope)
        k = _apply_rope(k, rope)
    out = attention(q, k, v, _positions(B, S, x.device), _positions(B, Skv, x.device),
                    causal=False, kv_chunk=kv_chunk)
    return dense(p.o, out.reshape(B, S, H * D))


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiT(nn.Module):
    """The WAN DiT with its weights.  ``forward(z, t, context, origin)``
    returns the noise prediction with ``z``'s shape and dtype."""

    def __init__(self, cfg: ArchConfig, tree: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.dtype = model_dtype(cfg)
        self.patch_embed = _param(tree["patch_embed"]["w"])
        self.text_proj = _param(tree["text_proj"]["w"])
        self.time_w1 = _param(tree["time_mlp"]["w1"]["w"])
        self.time_w2 = _param(tree["time_mlp"]["w2"]["w"])
        self.blocks = nn.ModuleList(DiTBlock(b) for b in tree["blocks"])
        self.final_norm_scale = _param(tree["final_norm"]["scale"])
        self.final_norm_bias = _param(tree["final_norm"]["bias"])
        self.final_ada = _param(tree["final_ada"]["w"])
        self.head = _param(tree["head"]["w"])

    def forward(self, z: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                origin: Tuple[int, int, int] = (0, 0, 0),
                kv_chunk: int = 4096) -> torch.Tensor:
        cfg = self.cfg
        B, d = z.shape[0], cfg.d_model
        tok, grid = _patchify(z, cfg)
        x = dense(self.patch_embed, tok.to(self.dtype))
        ctx = dense(self.text_proj, context.to(self.dtype))

        temb = sinusoidal_embedding(t.float(), 256)
        temb = dense(self.time_w2, F.silu(dense(self.time_w1, temb)))
        temb = F.silu(temb)                                       # (B, time_dim) f32
        rope = _axial_rope_tables(grid, origin, cfg.head_dim, z.device)

        for blk in self.blocks:
            mods = dense(blk.ada, temb).reshape(B, 6, d) + blk.ada_b[None]
            s1, b1, g1, s2, b2, g2 = [mods[:, i].to(x.dtype) for i in range(6)]
            hn = _modulate(rmsnorm(x), b1, s1)
            x = x + g1[:, None, :] * _attn(blk.self_attn, hn, cfg, rope,
                                           kv_chunk=kv_chunk)
            x = x + _attn(blk.cross_attn,
                          layernorm(x, blk.cross_norm_scale, blk.cross_norm_bias),
                          cfg, context=ctx, kv_chunk=kv_chunk)
            hn = _modulate(rmsnorm(x), b2, s2)
            x = x + g2[:, None, :] * mlp(blk.mlp_wi, blk.mlp_wg, blk.mlp_wo, hn)

        fmods = dense(self.final_ada, temb).reshape(B, 2, d)
        shift, scale = fmods[:, 0].to(x.dtype), fmods[:, 1].to(x.dtype)
        x = _modulate(layernorm(x, self.final_norm_scale, self.final_norm_bias),
                      shift, scale)
        out = dense(self.head, x)
        return _unpatchify(out, grid, cfg, z.shape).to(z.dtype)


def _block_tree(cfg: ArchConfig, dense_: Any, device) -> Dict[str, Any]:
    d, dt = cfg.d_model, model_dtype(cfg)
    hd = cfg.num_heads * cfg.head_dim

    def qkvo():
        return {"q": {"w": dense_(d, hd)}, "k": {"w": dense_(d, hd)},
                "v": {"w": dense_(d, hd)}, "o": {"w": dense_(hd, d)}}

    ada_b = torch.zeros((6, d), dtype=torch.float32, device=device)
    ada_b[2] = 1.0          # gates g1, g2 start at 1 (reference dit_block_init)
    ada_b[5] = 1.0
    return {
        "self_attn": qkvo(),
        "cross_attn": qkvo(),
        "cross_norm": {"scale": torch.ones(d, device=device),
                       "bias": torch.zeros(d, device=device)},
        "mlp": {"wi": {"w": dense_(d, cfg.d_ff)}, "wg": {"w": dense_(d, cfg.d_ff)},
                "wo": {"w": dense_(cfg.d_ff, d)}},
        "ada": {"w": torch.zeros((cfg.time_embed_dim, 6 * d), dtype=dt, device=device)},
        "ada_b": ada_b,
    }


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> DiT:
    """A DiT with random weights drawn from the reference's distributions
    (``repro/models/dit.py:init_params``).  ``generator`` must live on
    ``device``; by default a generator seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = make_generator(0, device)
    dt = model_dtype(cfg)
    d = cfg.d_model
    pt, ph, pw = cfg.patch_sizes
    patch_elems = pt * ph * pw * cfg.latent_channels

    def dense_(i, o, dtype=dt):
        return dense_init(i, o, generator, dtype, device=device)

    tree = {
        "patch_embed": {"w": dense_(patch_elems, d)},
        "text_proj": {"w": dense_(cfg.context_dim, d)},
        "time_mlp": {"w1": {"w": dense_(256, cfg.time_embed_dim, torch.float32)},
                     "w2": {"w": dense_(cfg.time_embed_dim, cfg.time_embed_dim,
                                        torch.float32)}},
        "blocks": [_block_tree(cfg, dense_, device) for _ in range(cfg.num_layers)],
        "final_norm": {"scale": torch.ones(d, device=device),
                       "bias": torch.zeros(d, device=device)},
        "final_ada": {"w": torch.zeros((cfg.time_embed_dim, 2 * d), dtype=dt,
                                       device=device)},
        "head": {"w": dense_(d, patch_elems)},
    }
    return DiT(cfg, tree)


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device: DeviceLike = None) -> DiT:
    """A DiT holding the weights of a reference parameter tree.

    ``tree`` is ``repro.models.dit.init_params``'s pytree as nested dicts
    of numpy arrays.  Its ``blocks`` leaves are stacked on a leading layer
    axis (``stack_init``) and are split into per-layer weights; everything
    else, dense ``(in, out)`` weights included, is carried as it is.
    """
    device = resolve_device(device)
    tensors = _map_tree(lambda a: _to_tensor(a, device), tree)
    blocks = tensors["blocks"]
    tensors["blocks"] = [_map_tree(lambda t, i=i: t[i], blocks)
                         for i in range(cfg.num_layers)]
    return DiT(cfg, tensors)
