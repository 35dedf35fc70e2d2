"""Uniform-window LP math: slice the K windows, stitch their predictions.

The single-GPU part of ``repro/core/spmd.py``.  The latent lives on one
device, so the "rotating partition" is K slices of it and "latent
reconstruction" (paper Eqs. 15-17) is one pass of the hand-written
``latent_blend`` kernel (``kernels/ops.latent_blend``) for CUDA tensors,
its plain version for CPU ones; ``blend_windows_coded`` stitches windows
that crossed a quantized wire (``int8_quantize`` + ``dequant_blend``).
The multi-GPU engines (psum, halo) are ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops

from .uniform import UniformPlan


def stack_windows(z: torch.Tensor, plan: UniformPlan, axis: int) -> torch.Tensor:
    """(K, ..., window, ...) stack of the K uniform windows of ``z``."""
    return torch.stack([z.narrow(axis, s, plan.window) for s in plan.starts])


def window_weights(plan: UniformPlan) -> np.ndarray:
    """(K, window) trapezoid masks, float32."""
    return np.stack([plan.weight_1d(k) for k in range(plan.num_partitions)])


@dataclasses.dataclass(frozen=True)
class BlendTables:
    """A plan's blend weights ``(K, window)`` and normalizer ``(E,)``, f32,
    on the device that blends."""

    weights: torch.Tensor
    normalizer: torch.Tensor

    @classmethod
    def build(cls, plan: UniformPlan, device) -> "BlendTables":
        return cls(torch.from_numpy(window_weights(plan)).to(device),
                   torch.from_numpy(plan.normalizer()).to(device))


def blend_windows(preds: torch.Tensor, plan: UniformPlan, axis: int,
                  tables: BlendTables | None = None) -> torch.Tensor:
    """Position-aware reconstruction of stacked window predictions.

    ``preds``: (K, ...) with the partition dim at ``axis`` of each element
    (``axis + 1`` of the stack).  The partition dim is moved to the front
    and the rest flattened, so the kernel sees ``(K, window, F)``.
    ``tables`` (from ``BlendTables.build``) saves rebuilding the weights
    on every call.
    """
    K = plan.num_partitions
    if tables is None:
        tables = BlendTables.build(plan, preds.device)
    p = torch.movedim(preds, axis + 1, 1)          # (K, W, rest...)
    rest = p.shape[2:]
    flat = int(np.prod(rest)) if rest else 1
    out = kernel_ops.latent_blend(
        p.reshape(K, plan.window, flat).contiguous(), tables.weights,
        tables.normalizer, plan.starts, plan.window, plan.extent,
    )
    return torch.movedim(out.reshape((plan.extent,) + tuple(rest)), 0, axis)


def blend_windows_coded(preds: torch.Tensor, plan: UniformPlan, axis: int,
                        codec="int8", tables: BlendTables | None = None) -> torch.Tensor:
    """Blend stacked window predictions that crossed a quantized wire.

    Each of the K window predictions is round-tripped through the codec
    with one per-slab scale per window.  For int8 the round trip is two
    kernels: ``int8_quantize`` of the K windows in one launch, then
    ``dequant_blend``, which never writes the dequantized f32 windows to
    device memory (their plain versions for CPU tensors).  Other codecs
    decode and reuse :func:`blend_windows`.
    """
    from repro_torch.comm.codecs import get_codec

    codec = get_codec(codec)
    K = plan.num_partitions
    if tables is None:
        tables = BlendTables.build(plan, preds.device)
    if codec.name == "int8":
        p = torch.movedim(preds, axis + 1, 1)          # (K, W, rest...)
        rest = p.shape[2:]
        flat = int(np.prod(rest)) if rest else 1
        wire, scales = kernel_ops.int8_quantize(
            p.reshape(K, plan.window, flat).float().contiguous())
        out = kernel_ops.dequant_blend(wire, scales, tables.weights, tables.normalizer,
                                       plan.starts, plan.window, plan.extent,
                                       out_dtype=preds.dtype)
        return torch.movedim(out.reshape((plan.extent,) + tuple(rest)), 0, axis)
    wire, meta = codec.encode_many(preds)
    roundtripped = codec.decode(wire, meta, preds.shape).to(preds.dtype)
    return blend_windows(roundtripped, plan, axis, tables)


# ------------------------------------------------------- engine selection
LP_IMPLS = ("auto", "gspmd", "shard_map", "halo", "halo_hybrid")


def select_lp_impl(num_partitions: int, tp: int = 1) -> str:
    """Resolve ``lp_impl="auto"`` to the engine the reference would pick
    (``repro/core/spmd.py:select_lp_impl``): the psum engine at K <= 2,
    the halo family beyond (hybrid halo on a tensor-parallel mesh)."""
    if num_partitions <= 2:
        return "shard_map"
    return "halo_hybrid" if tp > 1 else "halo"
