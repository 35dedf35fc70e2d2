"""Uniform-window LP math: slice the K windows, stitch their predictions,
on one GPU or across the ranks of an lp group.

A port of ``repro/core/spmd.py``.  On one device the "rotating
partition" is K slices of the latent and "latent reconstruction" (paper
Eqs. 15-17) one pass of the hand-written ``latent_blend`` kernel
(``kernels/ops.latent_blend``) for CUDA tensors, its plain version for
CPU ones; ``blend_windows_coded`` stitches windows that crossed a
quantized wire (``int8_quantize`` + ``dequant_blend``).

Across an lp group (``distributed.collectives.LPGroup``, one rank per
window, the latent replicated on every rank) the reference's two SPMD
engines, picked by ``select_lp_impl``:

* :func:`lp_forward_shard_map` — the psum engine (K = 2): one all-reduce
  of the f32 weighted global buffer, then the normalizer;
* :func:`lp_forward_halo` — the halo engine (K >= 3): overlap slabs by
  point-to-point rounds, each rank normalizes its core, an all-gather of
  the cores; uncoded or through a wire codec (``comm/wire.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops

from .uniform import UniformPlan

DenoiseFn = Callable[[torch.Tensor], torch.Tensor]


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


# --------------------------------------------------------- across ranks
def _check_group(group, plan: UniformPlan, z: torch.Tensor, axis: int) -> None:
    K = plan.num_partitions
    if group.size != K:
        raise ValueError(f"the lp group has {group.size} ranks, the plan has K={K}")
    if z.shape[axis] != plan.extent:
        raise ValueError(f"z must be the whole (replicated) latent: extent {z.shape[axis]} "
                         f"on axis {axis}, the plan covers {plan.extent}")


def _weighted_window(denoise_fn: DenoiseFn, z: torch.Tensor, plan: UniformPlan, axis: int,
                     k: int) -> torch.Tensor:
    """Rank k's window denoised, as f32 times its trapezoid weights."""
    pred = denoise_fn(z.narrow(axis, plan.starts[k], plan.window)).float()
    w = torch.from_numpy(plan.weight_1d(k)).to(pred.device)
    wshape = [1] * pred.ndim
    wshape[axis] = plan.window
    return pred * w.reshape(wshape)


def lp_forward_shard_map(denoise_fn: DenoiseFn, z: torch.Tensor, plan: UniformPlan,
                         axis: int, group) -> torch.Tensor:
    """The psum engine on one rank: slice the window locally, denoise,
    weight, scatter into a zero f32 global buffer, one sum all-reduce
    over the group (``comm_model.comm_lp_spmd``'s ``2 (K-1) S_z`` wire
    bytes a step across the group), divide by the analytic normalizer.
    ``z`` is the replicated latent; the group's size must equal K."""
    _check_group(group, plan, z, axis)
    k = group.rank
    buf = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    buf.narrow(axis, plan.starts[k], plan.window).copy_(
        _weighted_window(denoise_fn, z, plan, axis, k))
    buf = group.all_reduce(buf)                   # latent reconstruction (Eq. 15)
    nshape = [1] * buf.ndim
    nshape[axis] = plan.extent
    norm = torch.from_numpy(plan.normalizer()).to(buf.device)
    return (buf / norm.reshape(nshape)).to(z.dtype)


def lp_forward_halo(denoise_fn: DenoiseFn, z: torch.Tensor, plan: UniformPlan, axis: int,
                    group, codec=None, codec_state=None, eager_sends: bool = False,
                    shard_axis=None, nan_guard: bool = False):
    """The halo engine on one rank: the psum engine's math without a
    global-sized buffer on the wire.

    The rank denoises and weights its window, exchanges only the overlap
    slabs with the ranks whose cores its window touches
    (``distributed.collectives.halo_exchange``), normalizes its own core
    with the analytic ``Z(x)``, all-gathers the cores (a disjoint cover
    of the latent) and reassembles the replicated output
    (``comm_model.comm_lp_halo``'s bytes).  Uncoded, the core is cast to
    z's dtype before the gather.

    ``codec`` (a ``comm.codecs`` name or instance) squeezes every slab and
    the core gather through a wire codec (``comm_model.comm_lp_halo_codec``).
    Residual codecs are stateful: ``codec_state`` is this rank's slice of
    ``comm.wire.init_halo_wire_state`` (``comm.wire.rank_wire_state``),
    and the call returns ``(latent, new_state)``.  ``eager_sends`` issues
    every round before the first deposit; ``nan_guard`` arms the codec
    decode guard (``comm.wire._finite_or``).

    ``shard_axis`` (the tp group of a ``distributed.collectives.HybridGroup``
    whose lp group is ``group``) shards every payload, halo slabs and core
    contributions, over the tp ranks: each ships 1/T of it across the lp
    group and one tp all-gather reassembles it
    (``comm_model.comm_lp_halo_sharded``).  The denoiser's output must be
    the same on every tp rank, as the hybrid engine's contract requires;
    the result is then bit-equal to the unsharded engine's.
    """
    from repro_torch.distributed.collectives import check_shard, gather, halo_exchange, halo_spec

    shard_axis = check_shard(group, shard_axis)
    _check_group(group, plan, z, axis)
    K, k = plan.num_partitions, group.rank
    spec = halo_spec(plan)
    if codec is not None:
        from repro_torch.comm.codecs import get_codec

        codec = get_codec(codec)
        if codec.stateful and codec_state is None:
            raise ValueError(f"codec {codec.name!r} is stateful: pass this rank's slice of "
                             "comm.wire.init_halo_wire_state as codec_state")
    wpred = torch.movedim(_weighted_window(denoise_fn, z, plan, axis, k), axis, 0)
    rest = tuple(wpred.shape[1:])
    wpred = torch.cat([wpred, wpred.new_zeros((spec.pad,) + rest)])
    norm = np.ones(spec.core_pad, np.float32)        # ones past core_len: a no-op divide
    norm[:spec.core_len[k]] = plan.normalizer()[spec.core_start[k]:spec.core_end[k]]
    norm = torch.from_numpy(norm).to(z.device).reshape((spec.core_pad,) + (1,) * len(rest))

    def reassemble(gathered):
        out = torch.cat([gathered[j, :spec.core_len[j]] for j in range(K)])
        return torch.movedim(out, 0, axis).to(z.dtype)

    if codec is None:
        acc = halo_exchange(wpred, spec, k, group, eager_sends=eager_sends,
                            shard_axis=shard_axis)
        core = (acc[:spec.core_pad] / norm).to(z.dtype)
        return reassemble(gather(group, core, shard_axis))

    from repro_torch.comm.wire import compressed_core_gather, compressed_halo_exchange

    state = codec_state if codec.stateful else {}
    acc, state = compressed_halo_exchange(wpred, spec, k, group, codec, state,
                                          eager_sends=eager_sends, shard_axis=shard_axis,
                                          nan_guard=nan_guard)
    core = acc[:spec.core_pad] / norm
    gathered, state = compressed_core_gather(core, k, group, codec, state, K,
                                             shard_axis=shard_axis, nan_guard=nan_guard)
    out = reassemble(gathered)
    return (out, state) if codec.stateful else out


# ------------------------------------------------------- engine selection
LP_IMPLS = ("auto", "gspmd", "shard_map", "halo", "halo_hybrid")


def select_lp_impl(num_partitions: int, tp: int = 1) -> str:
    """Resolve ``lp_impl="auto"`` to the engine the reference would pick
    (``repro/core/spmd.py:select_lp_impl``): the psum engine at K <= 2,
    the halo family beyond (hybrid halo on a tensor-parallel mesh)."""
    if num_partitions <= 2:
        return "shard_map"
    return "halo_hybrid" if tp > 1 else "halo"
