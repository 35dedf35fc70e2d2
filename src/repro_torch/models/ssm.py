"""Mamba2 (SSD) blocks: the chunked scan for prefill, the recurrent
state update for decode (a port of ``repro/models/ssm.py``).

Per head h (P = headdim, N = state size):
    S_t = exp(A * dt_t) S_{t-1} + dt_t * B_t (x) x_t         (state update)
    y_t = C_t . S_t + D * x_t                                 (readout)

On CUDA tensors the scan runs in a hand-written kernel, as the DiT's
attention runs in the flash kernel: ``mamba_ssd`` (``kernels/csrc/
mamba_ssd.cu``) for Zamba2's shapes, under grad with its gradient in
``kernels/csrc/mamba_ssd_bwd.cu``, and ``mamba_ssd_wide``
(``kernels/csrc/mamba_ssd_wide.cu``) for B and C in groups, widths past
128 and p = 1 (the xLSTM's mLSTM, ``models/xlstm.py``), under grad with
its gradient in ``kernels/csrc/mamba_ssd_wide_bwd.cu``; on CPU tensors it
runs the plain ``kernels/ref.ssd_scan``.  The
reference's rounding points are kept: ``dense`` casts to x's dtype after
an f32 accumulate, the scan takes and returns f32, and y is cast back only
after ``+ D x``.  The reference's ``REPRO_SSD_NAIVE`` switch (an A/B knob
of its benchmarks) is not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from .layers import (
    causal_conv1d,
    causal_conv1d_init,
    causal_conv1d_update,
    dense,
    dense_init,
    rmsnorm,
)


def mamba2_init(d_model: int, state: int, headdim: int, generator: torch.Generator,
                expand: int = 2, conv_width: int = 4, groups: int = 1,
                dtype=torch.bfloat16, device: Optional[torch.device] = None):
    """One block's parameters, the reference's tree and distributions."""
    d_inner = expand * d_model
    heads = d_inner // headdim
    # in_proj emits [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (heads)]
    d_proj = 2 * d_inner + 2 * groups * state + heads
    # dt bias: softplus^-1 of dt log-uniform in [1e-3, 1e-1]
    u = torch.rand((heads,), generator=generator, device=device)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "in_proj": {"w": dense_init(d_model, d_proj, generator, dtype, device=device)},
        "conv": causal_conv1d_init(d_inner + 2 * groups * state, conv_width, generator,
                                   dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, device=device)),
        "D": torch.ones((heads,), device=device),
        "dt_bias": dt_bias.float(),
        "norm": {"scale": torch.ones((d_inner,), device=device)},
        "out_proj": {"w": dense_init(d_inner, d_model, generator, dtype, device=device)},
    }


def gated_linear_scan(x, log_decay, scale, B, C, chunk: int = 64,
                      factorized: bool = True) -> torch.Tensor:
    """Chunked scan of ``S_t = exp(log_decay_t) S_{t-1} + scale_t B_t (x) x_t``,
    ``y_t = C_t . S_t``.  x ``(b, s, h, p)``, log_decay/scale ``(b, s, h)``,
    B, C ``(b, s, g, n)`` with ``g | h``; returns f32 ``(b, s, h, p)``.

    CPU tensors: ``kernels/ref.ssd_scan`` (both forms, any g; autograd
    differentiates it).  CUDA tensors, ``factorized=True``, on the f32
    views the reference takes (``ops.ssd_kernel`` picks the kernel): one
    group with p, n and chunk multiples of 16 in [16, 128] on ``mamba_ssd``,
    with grad enabled and an input that requires grad through
    ``ops.mamba_ssd_autograd`` (its backward the ``mamba_ssd_bwd`` kernel);
    the rest on ``mamba_ssd_wide``, under grad through
    ``ops.mamba_ssd_wide_autograd`` (its backward the ``mamba_ssd_wide_bwd``
    kernel: the xLSTM's training).  The f32 casts are autograd's too, so
    the gradient reaches bf16 inputs in their dtype.
    ``factorized=False`` on the card raises (ROADMAP Queue 1 item 12: no
    path of the port needs it).
    """
    if not x.is_cuda:
        return kernel_ref.ssd_scan(x, log_decay, scale, B, C, chunk, factorized)
    if not factorized:
        raise NotImplementedError(
            "gated_linear_scan on CUDA: factorized=False has no kernel; only the factorized "
            "form (ROADMAP Queue 1 item 12)")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, log_decay, scale, B, C))
    kernel = kernel_ops.ssd_kernel(B.shape[2], x.shape[-1], B.shape[-1], chunk)
    scalars = (x.float().contiguous(), log_decay.float().contiguous(),
               scale.float().contiguous())
    if kernel == "mamba_ssd":
        args = (*scalars, B[:, :, 0].float().contiguous(), C[:, :, 0].float().contiguous())
        if grad:
            return kernel_ops.mamba_ssd_autograd(*args, chunk=chunk)
        return kernel_ops.mamba_ssd(*args, chunk=chunk)
    args = (*scalars, B.float().contiguous(), C.float().contiguous())
    if grad:
        return kernel_ops.mamba_ssd_wide_autograd(*args, chunk=chunk)
    return kernel_ops.mamba_ssd_wide(*args, chunk=chunk)


def _split_proj(proj: torch.Tensor, d_inner: int, gn: int):
    return torch.split(proj, [d_inner, d_inner + 2 * gn, proj.shape[-1] - 2 * d_inner - 2 * gn],
                       dim=-1)


def mamba2_apply(params, x: torch.Tensor, cfg, chunk: int = 64) -> torch.Tensor:
    """Full-sequence forward.  x ``(B, S, d_model)``."""
    b, s, _ = x.shape
    heads = params["A_log"].shape[0]
    p = cfg.ssm_headdim
    g, n = cfg.ssm_groups, cfg.ssm_state
    d_inner = heads * p
    proj = dense(params["in_proj"]["w"], x)
    z, xbc, dt_raw = _split_proj(proj, d_inner, g * n)
    xbc = F.silu(causal_conv1d(params["conv"], xbc))
    xin, B, C = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])                 # (b, s, h)
    A = -torch.exp(params["A_log"])
    xin_h = xin.reshape(b, s, heads, p)
    y = gated_linear_scan(xin_h, dt * A[None, None, :], dt, B.reshape(b, s, g, n),
                          C.reshape(b, s, g, n), chunk=chunk, factorized=True)
    y = y + params["D"][None, None, :, None] * xin_h.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), scale=params["norm"]["scale"])
    return dense(params["out_proj"]["w"], y)


def mamba2_init_cache(batch: int, cfg, dtype=torch.float32,
                      device: Optional[torch.device] = None):
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    conv_ch = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, heads, cfg.ssm_state, cfg.ssm_headdim), dtype=dtype,
                           device=device),
    }


def mamba2_decode(params, x_t: torch.Tensor, cache, cfg):
    """Single-token recurrent update.  x_t ``(B, 1, d_model)``; returns
    ``(out (B, 1, d_model), new cache)`` (new tensors, as the reference)."""
    b = x_t.shape[0]
    heads = params["A_log"].shape[0]
    p, g, n = cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state
    d_inner = heads * p
    proj = dense(params["in_proj"]["w"], x_t)[:, 0]                       # (b, d_proj)
    z, xbc, dt_raw = _split_proj(proj, d_inner, g * n)
    xbc, conv_state = causal_conv1d_update(params["conv"], xbc, cache["conv"])
    xbc = F.silu(xbc)
    xin, B, C = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])                  # (b, h)
    A = -torch.exp(params["A_log"])
    xin_h = xin.reshape(b, heads, p).float()
    Bh = B.reshape(b, g, n).repeat_interleave(heads // g, dim=1).float()
    Ch = C.reshape(b, g, n).repeat_interleave(heads // g, dim=1).float()
    decay = torch.exp(dt * A[None, :])                                     # (b, h)
    S = cache["ssm"] * decay[..., None, None] + (
        dt[..., None, None] * Bh[..., :, None] * xin_h[..., None, :])     # (b, h, n, p)
    y = torch.einsum("bhn,bhnp->bhp", Ch, S) + params["D"][None, :, None] * xin_h
    y = y.reshape(b, 1, d_inner).to(x_t.dtype)
    y = rmsnorm(y * F.silu(z)[:, None, :], scale=params["norm"]["scale"])
    out = dense(params["out_proj"]["w"], y)
    return out, {"conv": conv_state, "ssm": S}
