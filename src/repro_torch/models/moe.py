"""Mixture-of-Experts layer: top-k router and capacity-bounded sort
dispatch (a port of ``repro/models/moe.py``).

The router runs in f32 over the real and the padding experts (padding
experts, added so E divides the reference's expert-parallel axis, get
logits of -1e30 and are never chosen); the top-k probabilities are
renormalised; the Switch auxiliary loss is ``num_experts * sum(me * ce)``
over the mean router probability and the share of first choices.  Each
expert takes at most ``C = ceil(T k / num_experts * capacity_factor)``
(token, expert) pairs, in token order (a stable sort by expert); the pairs
past C are dropped.  The experts run as batched SwiGLU products on an
``(E, C, d)`` buffer, bf16 in and f32 out (the reference's
``preferred_element_type``), and the outputs come back weighted by the
renormalised probabilities and summed in f32.

The data movement is gathers only, forwards and backwards: the dispatch
gathers each buffer row from its token, the combine gathers each pair's
row from the buffer and sums a token's pairs in ascending expert order
(the order in which the reference's scatter-add visits them); their
backwards are the inverse gathers (``_RowGather``).  No float sum goes
through atomics, so a step is bit-equal run to run on the card, as the
restart drill needs.  Capacity comes from static shapes: no host sync.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init


def _expert_stack(n: int, d_in: int, d_out: int, generator: torch.Generator, dtype,
                  device) -> torch.Tensor:
    """``(n, d_in, d_out)`` fan-in truncated normal weights, drawn one
    expert at a time: no f32 temporary of the whole stack."""
    w = torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    for e in range(n):
        w[e] = dense_init(d_in, d_out, generator, dtype, device=device)
    return w


def moe_init(d_model: int, d_ff: int, num_experts: int, generator: torch.Generator,
             dtype=torch.bfloat16, num_padding_experts: int = 0,
             device: Optional[torch.device] = None):
    """``{"router": {"w": (d, E) f32}, "wi" | "wg": {"w": (E, d, d_ff)},
    "wo": {"w": (E, d_ff, d)}}`` with ``E = num_experts +
    num_padding_experts``, drawn in that order."""
    E = num_experts + num_padding_experts
    return {
        "router": {"w": dense_init(d_model, E, generator, torch.float32, device=device)},
        "wi": {"w": _expert_stack(E, d_model, d_ff, generator, dtype, device)},
        "wg": {"w": _expert_stack(E, d_model, d_ff, generator, dtype, device)},
        "wo": {"w": _expert_stack(E, d_ff, d_model, generator, dtype, device)},
    }


class _ExpertProduct(torch.autograd.Function):
    """``a @ b`` batched over experts with an f32 result, as the
    reference's ``einsum(..., preferred_element_type=f32)``.  bf16 on the
    card: one ``torch.bmm(..., out_dtype=torch.float32)`` (bf16 products,
    f32 accumulate and output); on the CPU the operands upcast to f32,
    whose products of bf16 values are exact.  The backward multiplies the
    f32 gradient rounded to the operands' dtype (a no-op in f32), with
    results in the operands' dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dtype == b.dtype == torch.float32:
            return torch.bmm(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.bmm(g.to(b.dtype), b.transpose(1, 2)).to(a.dtype) \
            if ctx.needs_input_grad[0] else None
        gb = torch.bmm(a.transpose(1, 2), g.to(a.dtype)).to(b.dtype) \
            if ctx.needs_input_grad[1] else None
        return ga, gb


class _RowGather(torch.autograd.Function):
    """``out[i] = src[idx[i]]`` where ``mask[i]``, else 0.  The backward
    is the inverse gather: ``grad_src[r] = sum_j grad_out[back[r, j]]``
    over the ``j`` with ``back_mask[r, j]``, summed in ``j`` order, where
    ``back`` lists, for each source row, the output rows that read it."""

    @staticmethod
    def forward(ctx, src, idx, mask, back, back_mask):
        ctx.save_for_backward(back, back_mask)
        return torch.where(mask[:, None], src.index_select(0, idx), 0)

    @staticmethod
    def backward(ctx, g):
        back, back_mask = ctx.saved_tensors
        n, m = back.shape
        parts = torch.where(back_mask[..., None],
                            g.index_select(0, back.reshape(-1)).view(n, m, -1), 0)
        acc = parts[:, 0]
        for j in range(1, m):
            acc = acc + parts[:, j]
        return acc, None, None, None, None


def capacity(tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Pairs an expert takes: ``ceil(T k / num_experts * capacity_factor)``."""
    return int(math.ceil(tokens * top_k / num_experts * capacity_factor))


def route(top_e: torch.Tensor, num_total: int, capacity_c: int):
    """The dispatch plan of each token's ``top_e (T, k)`` chosen experts out
    of ``num_total``: the permutation ``perm`` that puts a token's choices
    in ascending expert order, and the two index maps between pairs
    (token, choice in that order) and rows of the ``(E*C, d)`` buffer:
    ``pair_row (T*k,)``, each pair's row, valid where ``keep``, and
    ``row_pair (E*C,)``, the pair that fills each row, valid where
    ``filled``.  Within an expert the pairs take rows in token order (the
    reference's stable sort); the pairs past ``capacity_c`` are dropped."""
    dev = top_e.device
    experts, perm = torch.sort(top_e, dim=1)
    flat_e = experts.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)           # pairs by expert, tokens in order
    first = torch.searchsorted(flat_e[order], torch.arange(num_total, device=dev))
    counts = torch.diff(first, append=first.new_full((1,), n))
    pos = torch.argsort(order) - first[flat_e]           # each pair's place in its expert
    keep = pos < capacity_c
    pair_row = flat_e * capacity_c + pos.clamp(max=capacity_c - 1)
    c = torch.arange(capacity_c, device=dev)
    row_pair = order[(first[:, None] + c).clamp(max=n - 1)].reshape(-1)
    filled = (c[None, :] < counts[:, None]).reshape(-1)
    return perm, pair_row, keep, row_pair, filled


def router_probs(params, xt: torch.Tensor, num_experts: int,
                 router_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The router's f32 probabilities ``(T, E)`` of tokens ``xt (T, d)``:
    the padding experts' logits are -1e30 (never chosen), ``router_noise``
    is added to the logits."""
    E = params["router"]["w"].shape[1]
    logits = torch.matmul(xt.float(), params["router"]["w"].float())
    if E > num_experts:
        logits = logits.masked_fill(torch.arange(E, device=xt.device) >= num_experts, -1e30)
    if router_noise is not None:
        logits = logits + router_noise
    return torch.softmax(logits, dim=-1)


def moe_apply(params, x: torch.Tensor, num_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              router_noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, d)`` -> (output ``(B, S, d)`` in x's dtype, aux loss f32
    scalar).  ``num_experts`` counts the real experts (the padding ones
    are the rest of the E axis); ``router_noise`` ``(T, E)`` is added to
    the router logits."""
    B, S, d = x.shape
    E = params["wi"]["w"].shape[0]
    T = B * S
    xt = x.reshape(T, d)
    probs = router_probs(params, xt, num_experts, router_noise)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)      # (T, k), by probability
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    C = capacity(T, num_experts, top_k, capacity_factor)
    with torch.no_grad():
        perm, pair_row, keep, row_pair, filled = route(top_e, E, C)
    weights = top_p.gather(1, perm)                      # in a token's expert order

    # Switch Transformer's load-balancing loss (eq. 4); ce counts first choices
    me = probs.mean(dim=0)
    ce = (top_e[:, :1] == torch.arange(E, device=x.device)).sum(0).float() / T
    aux = num_experts * torch.sum(me * ce)

    # dispatch: each buffer row from its token (rows past an expert's pairs are 0)
    buf = _RowGather.apply(xt, row_pair // top_k, filled, pair_row.view(T, top_k),
                           keep.view(T, top_k)).view(E, C, d)
    h = F.silu(_ExpertProduct.apply(buf, params["wg"]["w"])) \
        * _ExpertProduct.apply(buf, params["wi"]["w"])                     # (E, C, f) f32
    y = _ExpertProduct.apply(h.to(x.dtype), params["wo"]["w"])             # (E, C, d) f32
    # combine: each pair's row back, weighted, a token's pairs summed in
    # ascending expert order (a dropped pair gathers 0)
    got = _RowGather.apply(y.reshape(E * C, d), pair_row, keep, row_pair.view(E * C, 1),
                           filled.view(E * C, 1)).view(T, top_k, d)
    got = got * weights[..., None]
    out = got[:, 0]
    for j in range(1, top_k):
        out = out + got[:, j]
    return out.reshape(B, S, d).to(x.dtype), aux
