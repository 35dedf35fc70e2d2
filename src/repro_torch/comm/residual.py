"""Temporal-delta coding with error feedback (EF) for wire messages.
A port of ``repro/comm/residual.py``.

Halo slabs change slowly across the steps of one rotation dim, so the
residual against the previous step's decoded slab is much smaller than
the slab; the EF carry re-injects each step's quantization error into
the next residual, so the error stays bounded instead of drifting.

    sender j:   c   = x - prev_send + err          (delta + EF carry)
                w,m = base.encode(c);  d = base.decode(w, m)
                prev_send += d;        err = c - d
    receiver k: d   = base.decode(w, m)
                x_hat = prev_recv + d; prev_recv = x_hat

``residual_encode`` takes a stack of messages (``x[n]`` is message
``n``, with its own scale), so the K slabs of one transfer are one call.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .codecs import Codec, IntCodec, Meta


@dataclasses.dataclass(frozen=True)
class ResidualCodec(Codec):
    """Temporal-delta + error-feedback wrapper around a quantizing base.

    ``encode`` / ``decode`` are not implemented: a residual codec is
    stateful, so callers go through :func:`residual_encode` /
    :func:`residual_decode` with explicit (prev, err) state.
    ``displaced``: the halo deposits the previous step's decoded slab
    while this step's lands in the carry (resolved via
    ``get_codec("displaced:<base>")``).
    """

    base: Codec = dataclasses.field(default_factory=IntCodec)
    name: str = "int8-residual"
    stateful: bool = True
    displaced: bool = False

    def __post_init__(self):
        # the delta construction changes what is quantized, not the layout
        object.__setattr__(self, "bits", self.base.bits)
        object.__setattr__(self, "meta_bytes", self.base.meta_bytes)

    def encode(self, x):
        raise TypeError("residual codecs are stateful: use residual_encode")

    def encode_many(self, x):
        raise TypeError("residual codecs are stateful: use residual_encode")

    def decode(self, wire, meta, shape):
        raise TypeError("residual codecs are stateful: use residual_decode")

    def wire_elems(self, n_elems, last_dim=None):
        return self.base.wire_elems(n_elems, last_dim)


def residual_encode(
    base: Codec, x: torch.Tensor, prev_send: torch.Tensor, err: torch.Tensor,
) -> Tuple[torch.Tensor, Meta, torch.Tensor, torch.Tensor]:
    """Sender side for ``x.shape[0]`` messages: returns (wire, meta,
    new_prev_send, new_err)."""
    corrected = x.float() - prev_send + err
    wire, meta = base.encode_many(corrected)
    d = base.decode(wire, meta, corrected.shape)
    return wire, meta, prev_send + d, corrected - d


def residual_decode(
    base: Codec, wire: torch.Tensor, meta: Meta, prev_recv: torch.Tensor,
    shape: Tuple[int, ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Receiver side: returns (x_hat, new_prev_recv)."""
    x_hat = prev_recv + base.decode(wire, meta, shape)
    return x_hat, x_hat


def ef_roundtrip(base: Codec, x: torch.Tensor,
                 err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain error-feedback round trip of one message (no temporal
    delta): returns the decoded value and the new error carry."""
    corrected = x.float() + err
    wire, meta = base.encode(corrected)
    back = base.decode(wire, meta, corrected.shape)
    return back, corrected - back
