"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, recurrent), a port of ``repro/models/xlstm.py``.

mLSTM is a gated linear recurrence

    C_t = f_t C_{t-1} + i_t k_t (x) v_t          (matrix memory, n x p)
    n_t = f_t n_{t-1} + i_t k_t                  (normalizer state)
    y_t = (q_t . C_t) / max(|q_t . n_t|, 1)

so the prefill runs ``ssm.gated_linear_scan`` twice (the values, then the
normalizer with x = 1) with ``log_decay = logsigmoid(f~)`` and ``scale =
exp(clip(i~, -10, 10))``, in f32: on the card both scans launch the
grouped, wide-head ``mamba_ssd_wide`` kernel (g = h groups, p = n = the
head width).  The single-token decode keeps the paper's max-state
stabilizer, in plain PyTorch as the reference leaves it to XLA.

sLSTM feeds h_{t-1} into its gates, so it cannot run in parallel over
time: ``slstm_apply`` is a Python loop over the sequence of one step of
plain PyTorch each (15 launches on the card), in f32, with the four
recurrent products and the input gates' addition as one batched product
over the stacked ``rec``.  The loop's state lives in (heads, batch, ...)
layout, so each step's slices are views.

Ratio: every ``slstm_every``-th block is sLSTM, the rest mLSTM (7:1 in
xLSTM-1.3b, per arXiv:2405.04517).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import (
    causal_conv1d,
    causal_conv1d_init,
    causal_conv1d_update,
    dense,
    dense_init,
    layernorm,
    layernorm_init,
    mlp,
    rmsnorm,
    rmsnorm_init,
)
from .ssm import gated_linear_scan

PF_MLSTM = 2  # up-projection factor


# ------------------------------------------------------------------ mLSTM
def mlstm_init(d_model: int, num_heads: int, generator: torch.Generator,
               dtype=torch.bfloat16, device: Optional[torch.device] = None):
    """One mLSTM block's parameters, the reference's tree and distributions
    (the gate projection and its bias in f32)."""
    di = PF_MLSTM * d_model
    return {
        "norm": rmsnorm_init(d_model, device=device),
        "up": {"w": dense_init(d_model, 2 * di, generator, dtype, device=device)},
        "conv": causal_conv1d_init(di, 4, generator, dtype, device=device),
        "q": {"w": dense_init(di, di, generator, dtype, device=device)},
        "k": {"w": dense_init(di, di, generator, dtype, device=device)},
        "gates": {"w": dense_init(di, 2 * num_heads, generator, torch.float32, device=device)},
        "gate_bias": torch.cat([torch.zeros(num_heads, device=device),
                                torch.linspace(3.0, 6.0, num_heads, device=device)]),
        "cell_norm": rmsnorm_init(di, device=device),
        "down": {"w": dense_init(di, d_model, generator, dtype, device=device)},
    }


def mlstm_apply(params, x: torch.Tensor, num_heads: int, chunk: int = 128) -> torch.Tensor:
    """x ``(B, S, d)``.  The chunk-parallel mLSTM block forward, residual
    included."""
    b, s, _ = x.shape
    h = num_heads
    xn = rmsnorm(x, scale=params["norm"]["scale"])
    a, g = torch.chunk(dense(params["up"]["w"], xn), 2, dim=-1)        # (b, s, di) each
    di = a.shape[-1]
    dh = di // h
    ac = F.silu(causal_conv1d(params["conv"], a))
    q = dense(params["q"]["w"], ac).reshape(b, s, h, dh)
    k = dense(params["k"]["w"], ac).reshape(b, s, h, dh) / math.sqrt(float(dh))
    v = a.reshape(b, s, h, dh)                                          # value from a
    gates = dense(params["gates"]["w"], ac.float()) + params["gate_bias"]
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)                        # (b, s, h)
    log_f = F.logsigmoid(f_raw.float())
    i_scale = torch.exp(torch.clamp(i_raw.float(), -10.0, 10.0))
    # matrix memory: y = q . C with C_t = f C + i k (x) v
    y = gated_linear_scan(v, log_f, i_scale, k, q, chunk=chunk)         # (b, s, h, dh)
    # normalizer: n_t = f n + i k; denom = max(|q . n|, 1)
    ones = torch.ones((b, s, h, 1), dtype=v.dtype, device=x.device)
    qn = gated_linear_scan(ones, log_f, i_scale, k, q, chunk=chunk)[..., 0]
    y = y / torch.clamp_min(qn.abs(), 1.0)[..., None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rmsnorm(y, scale=params["cell_norm"]["scale"]) * F.silu(g)
    return x + dense(params["down"]["w"], y)


def mlstm_init_cache(batch: int, d_model: int, num_heads: int, dtype=torch.float32,
                     device: Optional[torch.device] = None):
    di = PF_MLSTM * d_model
    dh = di // num_heads
    return {
        "conv": torch.zeros((batch, 3, di), dtype=dtype, device=device),
        "C": torch.zeros((batch, num_heads, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, num_heads, dh), dtype=dtype, device=device),
        "m": torch.full((batch, num_heads), -1e30, dtype=dtype, device=device),
    }


def mlstm_decode(params, x_t: torch.Tensor, cache, num_heads: int):
    """One token through an mLSTM block with the max-state stabilizer
    (xLSTM eq. 15).  x_t ``(B, 1, d)``; returns ``(out, new cache)``, new
    tensors as the reference returns."""
    b = x_t.shape[0]
    h = num_heads
    xn = rmsnorm(x_t, scale=params["norm"]["scale"])
    a, g = torch.chunk(dense(params["up"]["w"], xn)[:, 0], 2, dim=-1)  # (b, di)
    di = a.shape[-1]
    dh = di // h
    ac, conv_state = causal_conv1d_update(params["conv"], a, cache["conv"])
    ac = F.silu(ac)
    q = dense(params["q"]["w"], ac[:, None])[:, 0].reshape(b, h, dh)
    k = dense(params["k"]["w"], ac[:, None])[:, 0].reshape(b, h, dh) / math.sqrt(float(dh))
    v = a.reshape(b, h, dh)
    gates = dense(params["gates"]["w"], ac[:, None].float())[:, 0] + params["gate_bias"]
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)                         # (b, h)
    log_f = F.logsigmoid(f_raw.float())
    m_new = torch.maximum(log_f + cache["m"], i_raw)
    f_eff = torch.exp(log_f + cache["m"] - m_new)
    i_eff = torch.exp(i_raw - m_new)
    C = cache["C"] * f_eff[..., None, None] + i_eff[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = cache["n"] * f_eff[..., None] + i_eff[..., None] * k
    num = torch.einsum("bhd,bhdp->bhp", q.float(), C)
    den = torch.einsum("bhd,bhd->bh", q.float(), n).abs()
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    y = y.reshape(b, 1, di).to(x_t.dtype)
    y = rmsnorm(y, scale=params["cell_norm"]["scale"]) * F.silu(g)[:, None]
    out = x_t + dense(params["down"]["w"], y)
    return out, {"conv": conv_state, "C": C, "n": n, "m": m_new}


# ------------------------------------------------------------------ sLSTM
def slstm_init(d_model: int, num_heads: int, generator: torch.Generator,
               dtype=torch.bfloat16, device: Optional[torch.device] = None):
    """One sLSTM block's parameters, the reference's tree and distributions.
    The reference draws ``ffn.wi`` and ``ffn.wg`` from the same key, so
    they are equal at init; here too: one draw, in two separate leaves."""
    dh = d_model // num_heads
    wx = dense_init(d_model, 4 * d_model, generator, dtype, device=device)   # z i f o
    rec = torch.randn((4, num_heads, dh, dh), generator=generator, device=device) \
        / math.sqrt(float(dh))
    ff = -(-int(d_model * 4 / 3) // 128) * 128  # shard-friendly
    wi = dense_init(d_model, ff, generator, dtype, device=device)
    return {
        "norm": rmsnorm_init(d_model, device=device),
        "wx": {"w": wx},
        "rec": rec,
        "group_norm": layernorm_init(d_model, device=device),
        "ffn": {"wi": {"w": wi}, "wg": {"w": wi.clone()},
                "wo": {"w": dense_init(ff, d_model, generator, dtype, device=device)}},
        "ffn_norm": rmsnorm_init(d_model, device=device),
    }


def _recurrent_weights(rec: torch.Tensor) -> torch.Tensor:
    """``rec`` ``(4, h, dh, dh)`` (z i f o) as ``(h, dh, 2 dh + 2)``: the z
    and o products, then the i and f products' per-head means as one column
    each (the mean of ``h_prev @ rec[k]`` over its outputs is ``h_prev @
    rec[k].mean(-1)``), so one batched product a step gives the recurrent
    part of every gate."""
    rz, ri, rf, ro = rec.unbind(0)
    return torch.cat([rz, ro, ri.mean(-1, keepdim=True), rf.mean(-1, keepdim=True)], dim=-1)


def _input_gates(gates_x: torch.Tensor, h: int) -> torch.Tensor:
    """f32 input gates ``(..., 4 d)`` (z i f o) -> ``(..., h, 2 dh + 2)``:
    z and o, then the per-head means of i and f (the columns of
    ``_recurrent_weights``)."""
    xz, xi, xf, xo = gates_x.unflatten(-1, (4, h, -1)).unbind(-3)
    return torch.cat([xz, xo, xi.mean(-1, keepdim=True), xf.mean(-1, keepdim=True)], dim=-1)


def _slstm_cell(rw, xg, state):
    """One recurrent step, in (heads, batch, ...) layout: ``rw`` from
    ``_recurrent_weights``, ``xg`` ``(h, b, 2 dh + 2)`` the step's input
    gates from ``_input_gates``, ``state`` ``(c, n, m, h_prev)`` with c, n,
    h_prev ``(h, b, dh)`` and m ``(h, b)``.  15 launches on the card."""
    c, n, m, h_prev = state
    dh = h_prev.shape[-1]
    g = torch.baddbmm(xg, h_prev, rw)                 # z, o pre-activations; i, f gates
    z = torch.tanh(g[..., :dh])
    o = torch.sigmoid(g[..., dh:2 * dh])
    gif = torch.stack((g[..., 2 * dh], F.logsigmoid(g[..., 2 * dh + 1]) + m), dim=-1)
    m_new = gif.amax(-1)                              # max(i_raw, log f + m)
    e = torch.exp(gif - m_new[..., None])
    i_eff, f_eff = e[..., :1], e[..., 1:]
    c_new = torch.addcmul(f_eff * c, i_eff, z)
    n_new = torch.addcmul(i_eff, f_eff, n)
    h_new = o * (c_new / torch.clamp_min(n_new, 1e-6))
    return c_new, n_new, m_new, h_new


def _slstm_ffn(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The block's tail: group norm of the cell output ``y``, the residual,
    then the gated FFN (PF 4/3) with its residual."""
    gn = params["group_norm"]
    x1 = x + layernorm(y, gn["scale"], gn["bias"])
    f = params["ffn"]
    return x1 + mlp(f["wi"]["w"], f["wg"]["w"], f["wo"]["w"],
                    rmsnorm(x1, scale=params["ffn_norm"]["scale"]))


def slstm_apply(params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """x ``(B, S, d)``: a sequential loop over time (inherently recurrent)."""
    b, s, d = x.shape
    h = num_heads
    dh = d // h
    xn = rmsnorm(x, scale=params["norm"]["scale"])
    gates_x = dense(params["wx"]["w"], xn).float()                      # (b, s, 4d)
    xg = _input_gates(gates_x, h).permute(1, 2, 0, 3).contiguous()      # (s, h, b, 2dh + 2)
    rw = _recurrent_weights(params["rec"])
    z = torch.zeros((h, b, dh), dtype=torch.float32, device=x.device)
    state = (z, z, torch.full((h, b), -1e30, device=x.device), z)
    hs = []
    for xt in xg.unbind(0):      # one gradient node for every step's slice
        state = _slstm_cell(rw, xt, state)
        hs.append(state[3])
    y = torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, d).to(x.dtype)   # (b, s, h, dh)
    return _slstm_ffn(params, x, y)


def slstm_init_cache(batch: int, d_model: int, num_heads: int,
                     device: Optional[torch.device] = None):
    dh = d_model // num_heads
    z = torch.zeros((batch, num_heads, dh), device=device)
    return {"c": z, "n": z.clone(), "m": torch.full((batch, num_heads), -1e30, device=device),
            "h": z.clone()}


def slstm_decode(params, x_t: torch.Tensor, cache, num_heads: int):
    """One token through an sLSTM block; returns ``(out, new cache)``."""
    b, _, d = x_t.shape
    h = num_heads
    xn = rmsnorm(x_t, scale=params["norm"]["scale"])
    gates_x = dense(params["wx"]["w"], xn)[:, 0].float()                # (b, 4d)
    state = tuple(cache[k].transpose(0, 1) for k in ("c", "n", "m", "h"))
    c, n, m, hnew = _slstm_cell(_recurrent_weights(params["rec"]),
                                _input_gates(gates_x, h).transpose(0, 1), state)
    c, n, m, hnew = (t.transpose(0, 1) for t in (c, n, m, hnew))
    y = hnew.reshape(b, 1, d).to(x_t.dtype)
    return _slstm_ffn(params, x_t, y), {"c": c, "n": n, "m": m, "h": hnew}
