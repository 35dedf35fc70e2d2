"""Wire codecs: encode a tensor into a compact wire dtype (+ tiny meta)
and decode it back to f32.  A port of ``repro/comm/codecs.py``.

  * **Per-slab scale** — quantizers use one max-abs scale per message,
    shaped ``(1,) * ndim`` so it broadcasts anywhere.  ``meta`` is a
    (possibly empty) tuple of such tensors.
  * **Many messages in one call** — ``encode_many(x)`` encodes each
    ``x[n]`` as its own message (its own scale, ``(N,) + (1,) * (ndim-1)``),
    bit-equal to ``N`` calls of ``encode``.  On a CUDA tensor the int
    codecs quantize all ``N`` slabs in one launch of the hand-written
    ``int8_quantize`` kernel (``kernels/ops.int8_quantize``); on a CPU
    tensor its plain version does the same arithmetic.
  * **Zero maps to zero** — an all-zero slab encodes to a zero wire and
    decodes to exactly zero, so peerless ranks stay silent.

bf16 stores its payload as the int16 view of the bf16 tensor (the
reference's u16 bitcast: the same 16 bits).  ``get_codec`` resolves the
CLI names, including ``*-residual`` and ``displaced:*``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch

from repro_torch.kernels import ops as kernel_ops

Meta = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class Codec:
    """Protocol + shared accounting.  Subclasses implement encode/decode."""

    name: str = "identity"
    bits: float = 32.0          # wire bits per logical element
    meta_bytes: int = 0         # scale payload per message, bytes
    stateful: bool = False      # True => needs carry state (residual)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, Meta]:
        """One message: the whole of ``x``."""
        wire, meta = self.encode_many(x[None])
        return wire[0], tuple(m[0] for m in meta)

    def encode_many(self, x: torch.Tensor) -> Tuple[torch.Tensor, Meta]:
        """``x.shape[0]`` messages, one per leading index."""
        raise NotImplementedError

    def decode(self, wire: torch.Tensor, meta: Meta,
               shape: Tuple[int, ...]) -> torch.Tensor:
        raise NotImplementedError

    # ---------------------------------------------------------- accounting
    def wire_bytes(self, n_elems: int) -> int:
        """Bytes of one message of ``n_elems`` logical elements (payload
        + meta)."""
        return int(math.ceil(n_elems * self.bits / 8)) + self.meta_bytes

    @property
    def wire_dtype_bytes(self) -> int:
        """Bytes per element of the payload's storage dtype (f32 4,
        bf16-as-int16 2, int8 and packed int4 1)."""
        return max(int(self.bits) // 8, 1)

    def wire_elems(self, n_elems: int, last_dim: Union[int, None] = None) -> int:
        """Storage elements of one message of ``n_elems`` logical
        elements; ``last_dim`` is needed by packing codecs (int4)."""
        return int(math.ceil(n_elems * self.bits / 8 / self.wire_dtype_bytes))


@dataclasses.dataclass(frozen=True)
class IdentityCodec(Codec):
    """fp32 passthrough — the exact baseline path, zero meta."""

    name: str = "fp32"
    bits: float = 32.0

    def encode_many(self, x):
        return x.float(), ()

    def decode(self, wire, meta, shape):
        return wire.float()


@dataclasses.dataclass(frozen=True)
class Bf16Codec(Codec):
    """bf16 wire: halves bytes, keeps fp32 dynamic range, no meta."""

    name: str = "bf16"
    bits: float = 16.0

    def encode_many(self, x):
        return x.to(torch.bfloat16).view(torch.int16), ()

    def decode(self, wire, meta, shape):
        return wire.view(torch.bfloat16).float()


@dataclasses.dataclass(frozen=True)
class IntCodec(Codec):
    """Per-slab-scaled symmetric integer quantizer (int8 or packed int4).

    int8: wire int8 in [-127, 127], scale = max|x| / 127.
    int4: wire int8 with TWO 4-bit codes per byte, packed along the last
    axis; codes in [-7, 7], scale = max|x| / 7.  An odd last dim is
    zero-padded before packing and sliced off on decode.
    """

    name: str = "int8"
    bits: float = 8.0
    meta_bytes: int = 4

    @property
    def qmax(self) -> int:
        return 127 if self.bits == 8 else 7

    def encode_many(self, x):
        n = x.shape[0]
        rows = x.shape[1] if x.ndim > 1 else 1
        slabs = x.float().reshape(n, rows, -1).contiguous()
        q, scales = kernel_ops.int8_quantize(slabs, self.qmax)
        q = q.reshape(x.shape)
        scale = scales.reshape((n,) + (1,) * (x.ndim - 1))
        if self.bits == 8:
            return q, (scale,)
        # int4: pack adjacent pairs of the last axis into one byte
        q = q.to(torch.int32)
        if x.shape[-1] % 2:
            q = torch.nn.functional.pad(q, (0, 1))
        lo = q[..., 0::2] & 0xF
        hi = (q[..., 1::2] & 0xF) << 4
        return (lo | hi).to(torch.int8), (scale,)

    def decode(self, wire, meta, shape):
        (scale,) = meta
        if self.bits == 8:
            return wire.float() * scale
        p = wire.to(torch.int32)
        lo = ((p & 0xF) ^ 8) - 8
        hi = (((p >> 4) & 0xF) ^ 8) - 8
        q = torch.stack([lo, hi], dim=-1).reshape(
            wire.shape[:-1] + (2 * wire.shape[-1],))[..., : shape[-1]]
        return q.float() * scale

    def wire_elems(self, n_elems: int, last_dim: Union[int, None] = None) -> int:
        if self.bits == 4 and last_dim:
            return n_elems // last_dim * ((last_dim + 1) // 2)
        return super().wire_elems(n_elems, last_dim)


def int4_wire_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Stored shape of an int4-packed message of logical ``shape``."""
    return tuple(shape[:-1]) + ((shape[-1] + 1) // 2,)


CODEC_NAMES = ("fp32", "bf16", "int8", "int4", "int8-residual",
               "int4-residual", "displaced", "displaced:int8-residual",
               "displaced:int4-residual")


def get_codec(name: Union[str, Codec, None]) -> Codec:
    """Resolve a CLI name (or pass a Codec through).  ``None`` => fp32."""
    if name is None:
        return IdentityCodec()
    if isinstance(name, Codec):
        return name
    base = {
        "identity": IdentityCodec(),
        "fp32": IdentityCodec(),
        "bf16": Bf16Codec(),
        "int8": IntCodec(name="int8", bits=8.0),
        "int4": IntCodec(name="int4", bits=4.0),
    }
    if name in base:
        return base[name]
    if name == "displaced":
        # bare ``displaced`` is sugar for the default residual base
        name = "displaced:int8-residual"
    if name.startswith("displaced:"):
        from .residual import ResidualCodec

        innerc = get_codec(name[len("displaced:"):])
        if not isinstance(innerc, ResidualCodec):
            raise ValueError(
                "displaced halo needs a *-residual base codec (the EF "
                f"carry is the staleness corrector), got {innerc.name!r}")
        return ResidualCodec(base=innerc.base, name=name, displaced=True)
    if name.endswith("-residual"):
        from .residual import ResidualCodec

        inner = name[: -len("-residual")]
        if inner in base and base[inner].meta_bytes:
            return ResidualCodec(base=base[inner], name=name)
        raise ValueError(f"residual coding needs a quantizing base codec, got {inner!r}")
    raise ValueError(f"unknown wire codec {name!r}; know {CODEC_NAMES}")
