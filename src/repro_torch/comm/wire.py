"""The quantized LP wire: the halo engine's codec'd collectives, across
ranks and as a bit-faithful single-process mirror.

A port of ``repro/comm/wire.py``.

* :func:`compressed_halo_exchange` / :func:`compressed_core_gather` —
  the SPMD half, run by each rank of an lp group
  (``distributed.collectives.LPGroup``) inside ``core/spmd.lp_forward_halo``:
  each halo slab and the rank's normalized core cross the wire through a
  codec, payload and per-slab scale meta each as a message of their own
  (both counted: together ``codec.wire_bytes``).  A rank holds its own
  slice of the residual state (:func:`rank_wire_state`).  With
  ``shard_axis`` (the tp group of a 2-D group) each coded payload crosses
  the lp group in 1/T chunks and the meta whole.
* :func:`simulate_halo_forward` replays the same arithmetic on one
  device: every rank's slab and core through the codec with its own
  per-slab scale, delivery by ``halo_spec``'s schedule, residual codecs
  threading explicit state (:func:`init_halo_wire_state`).  The serving
  engine runs it off a mesh when a wire codec is active or
  ``lp_impl="halo"`` was asked for; the tests hold the ranks to it.

The reference loops over ranks in Python; here the K ranks of one
transfer are one stack ``(K, length, ...)``, so each transfer and the
core gather are one ``encode_many`` call each: one ``int8_quantize``
launch on a CUDA tensor for the int codecs.  Per-rank results are
bit-equal to the reference's loop (each slab keeps its own scale).  A
rank encodes its slab of every round and its core: one launch each, the
launches of the mirror's stacks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.spmd import stack_windows, window_weights
from repro_torch.distributed.collectives import (HaloSpec, HaloTransfer, LPGroup, Round,
                                                 check_shard, gather, halo_round, halo_rounds,
                                                 halo_spec, issue_round, land_round,
                                                 masked_slab)

from .codecs import get_codec
from .residual import ResidualCodec, residual_decode, residual_encode

WireState = Dict[str, Any]


def _dir_key(t: HaloTransfer) -> str:
    """Per-direction state key of one transfer round: ``halo_spec`` emits
    one transfer per nonzero window offset, so the signed offset names
    it (``"+1"`` = slab from the left neighbour)."""
    return f"{t.offset:+d}"


def init_halo_wire_state(codec, spec: HaloSpec, rest_shape: Tuple[int, ...],
                         device=None) -> WireState:
    """Zeroed codec state for one halo-LP geometry, f32 on ``device``.

    Every leaf has a leading ``K`` dim (the rank).  ``pp_send`` /
    ``pp_err`` / ``pp_recv`` are dicts keyed per direction
    (:func:`_dir_key`); ``ag_prev`` is the decoded gathered-core table,
    identical for every rank and kept per rank ``(K, K, core_pad, ...)``.
    Displaced codecs add a per-rank ``fresh`` flag of ones: the first
    exchange after any state init deposits the fresh decode, later ones
    the one-step-stale carry.  Stateless codecs get ``{}``.
    """
    codec = get_codec(codec)
    if not codec.stateful:
        return {}
    K = spec.num_partitions
    rest = tuple(rest_shape)

    def z(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    state = {
        "pp_send": {_dir_key(t): z((K, t.length) + rest) for t in spec.transfers},
        "pp_err": {_dir_key(t): z((K, t.length) + rest) for t in spec.transfers},
        "pp_recv": {_dir_key(t): z((K, t.length) + rest) for t in spec.transfers},
        "ag_prev": z((K, K, spec.core_pad) + rest),
        "ag_err": z((K, spec.core_pad) + rest),
    }
    if getattr(codec, "displaced", False):
        state["fresh"] = torch.ones((K,), dtype=torch.float32, device=device)
    return state


def _finite_or(decoded: torch.Tensor, fallback) -> torch.Tensor:
    """NaN/Inf decode guard, all or nothing per message: one non-finite
    element and the whole message falls back to ``fallback`` (zeros when
    None).  A device-side select: no host synchronisation."""
    ok = torch.isfinite(decoded).all()
    fb = torch.zeros_like(decoded) if fallback is None else fallback
    return torch.where(ok, decoded, fb)


def _finite_rows_or(decoded: torch.Tensor, fallback) -> torch.Tensor:
    """:func:`_finite_or` per message of a ``(K, ...)`` stack."""
    ok = torch.isfinite(decoded).flatten(1).all(dim=1)
    ok = ok.reshape((-1,) + (1,) * (decoded.ndim - 1))
    fb = torch.zeros_like(decoded) if fallback is None else fallback
    return torch.where(ok, decoded, fb)


def rank_wire_state(state: WireState, rank: int) -> WireState:
    """Rank ``rank``'s slice of a global-layout wire state (every leaf's
    leading K dim taken at ``rank``): what that rank holds and threads."""
    return _map_leaves(state, lambda s: s[rank])


def put_rank_wire_state(state: WireState, rank: int, rank_state: WireState) -> WireState:
    """``state`` (global layout) with rank ``rank``'s row replaced by
    ``rank_state``; a new state, ``state`` is left as it is."""
    flat_rank = dict(_leaves(rank_state))

    def put(path, s):
        s = s.clone()
        s[rank] = flat_rank[path]
        return s

    return _map_leaves(state, put, with_path=True)


def _leaves(state, prefix=()):
    for key, val in state.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _map_leaves(state, fn, with_path=False, prefix=()):
    out = {}
    for key, val in state.items():
        path = prefix + (key,)
        if isinstance(val, dict):
            out[key] = _map_leaves(val, fn, with_path, path)
        else:
            out[key] = fn(path, val) if with_path else fn(val)
    return out


# ----------------------------------------------------------- SPMD pieces
def compressed_halo_exchange(
    wpred: torch.Tensor,
    spec: HaloSpec,
    rank: int,
    group: LPGroup,
    codec,
    state: WireState,
    eager_sends: bool = False,
    shard_axis: Optional[LPGroup] = None,
    nan_guard: bool = False,
) -> Tuple[torch.Tensor, WireState]:
    """Codec twin of ``collectives.halo_exchange`` on one rank: padded
    window-first f32 ``wpred`` in, the ``(core_pad + max_transfer, ...)``
    accumulator out, with this rank's updated codec state.

    Each round encodes the rank's masked slab (residual codecs: the
    temporal delta with its EF carry) and ships payload and meta to the
    round's receiver.  As in the reference, every rank encodes every
    round and decodes what it receives, a rank without a sender decoding
    zeros (ppermute's implicit zeros: exactly zero, and a residual
    receiver's state advances as the reference's does).  ``eager_sends``
    encodes and issues every round before the first decode.
    ``nan_guard`` falls back per message (:func:`_finite_or`): to the
    same direction's stale slab for residual codecs (which is then not
    advanced), to zeros otherwise.  Displaced codecs deposit the previous
    step's decoded slab while this step's lands in the carry; the first
    exchange after a state init (``fresh``) deposits the fresh decode.
    ``shard_axis`` (the tp group of a ``HybridGroup``) ships each coded
    payload sharded over it and the meta whole (``collectives.issue_round``):
    encoding happens on the full slab, identical on every tp rank, so
    scales, codes and residual state are those of the unsharded wire.
    """
    shard_axis = check_shard(group, shard_axis)
    stateful = isinstance(codec, ResidualCodec)
    base = codec.base if stateful else codec
    displaced = stateful and getattr(codec, "displaced", False)
    rest = tuple(wpred.shape[1:])
    acc = wpred.new_zeros((spec.core_pad + spec.max_transfer,) + rest, dtype=torch.float32)
    new_state: WireState = {}
    if stateful:
        new_state = dict(state)
        for key in ("pp_send", "pp_err", "pp_recv"):
            new_state[key] = dict(state[key])
    if displaced:
        fresh = state["fresh"] > 0.5
        new_state["fresh"] = torch.zeros_like(state["fresh"])

    def send(ti: int, t: HaloTransfer):
        dk = _dir_key(t)
        slab = masked_slab(wpred, t, rank)
        if stateful:
            wire, meta, n_send, n_err = residual_encode(
                base, slab[None], state["pp_send"][dk][None], state["pp_err"][dk][None])
            new_state["pp_send"][dk] = n_send[0]
            new_state["pp_err"][dk] = n_err[0]
            wire, meta = wire[0], tuple(m[0] for m in meta)
        else:
            wire, meta = codec.encode(slab)
        msg = (wire,) + tuple(meta)
        dst, src = halo_round(t, rank)
        return issue_round(group, Round(msg, dst, src), ti, shard_axis), msg

    def deposit(t: HaloTransfer, sent) -> None:
        handle, msg = sent
        got = land_round(group, handle, shard_axis)
        if got is None:                                  # no sender: ppermute's zeros
            got = tuple(torch.zeros_like(m) for m in msg)
        wire, meta = got[0], got[1:]
        shape = (t.length,) + rest
        if stateful:
            dk = _dir_key(t)
            prev = state["pp_recv"][dk]                  # this direction's stale slab
            dec, n_recv = residual_decode(base, wire, meta, prev, shape)
            if nan_guard:
                dec = n_recv = _finite_or(dec, prev)
            new_state["pp_recv"][dk] = n_recv
            if displaced:
                dec = torch.where(fresh, dec, prev)
        else:
            dec = codec.decode(wire, meta, shape)
            if nan_guard:
                dec = _finite_or(dec, None)
        dst = t.dst_start[rank]
        acc[dst:dst + t.length] += dec

    off = spec.core_start[rank] - spec.starts[rank]
    acc[:spec.core_pad] = wpred[off:off + spec.core_pad]          # own core, never coded
    halo_rounds(spec, eager_sends, send, deposit)
    return acc, new_state


def compressed_core_gather(
    core: torch.Tensor,
    rank: int,
    group: LPGroup,
    codec,
    state: WireState,
    num_partitions: int,
    shard_axis: Optional[LPGroup] = None,
    nan_guard: bool = False,
) -> Tuple[torch.Tensor, WireState]:
    """All-gather of the normalized ``(core_pad, ...)`` f32 core slices
    through the codec: the decoded ``(K, core_pad, ...)`` stack and the
    updated state.  Residual codecs delta-code against ``ag_prev`` (the
    previous gathered table, the same on every rank, so the rank's own
    row is its sender reference) with an EF carry on its own core.
    ``nan_guard`` drops a corrupted sender's row (residual: its delta).
    ``shard_axis`` gathers each coded core sharded over the tp group
    (``collectives.sharded_all_gather``) and the meta whole over the lp
    group; the residual state stays tp-replicated."""
    shard_axis = check_shard(group, shard_axis)
    stateful = isinstance(codec, ResidualCodec)
    base = codec.base if stateful else codec
    shape = (num_partitions,) + tuple(core.shape)
    if not stateful:
        wire, meta = codec.encode(core)
        wires = gather(group, wire, shard_axis)
        metas = tuple(group.all_gather(m) for m in meta)
        out = codec.decode(wires, metas, shape)
        if nan_guard:
            out = _finite_rows_or(out, None)
        return out, {}
    corrected = core - state["ag_prev"][rank] + state["ag_err"]
    wire, meta = base.encode(corrected)
    wires = gather(group, wire, shard_axis)
    metas = tuple(group.all_gather(m) for m in meta)
    d_all = base.decode(wires, metas, shape)
    if nan_guard:
        d_all = _finite_rows_or(d_all, None)
    gathered = state["ag_prev"] + d_all
    out_state = dict(state)
    out_state["ag_prev"] = gathered
    out_state["ag_err"] = corrected - d_all[rank]
    return gathered, out_state


@dataclasses.dataclass(frozen=True)
class _TransferTables:
    src_rows: torch.Tensor       # (K, length) window rows each rank sends
    valid: torch.Tensor          # (K, length) bool: rows inside src_len
    src_of: torch.Tensor         # (K,) sender of each receiver (0 if none)
    has_peer: torch.Tensor       # (K,) bool
    dst_rows: torch.Tensor       # (K, length) accumulator rows it lands in


@dataclasses.dataclass(frozen=True)
class HaloTables:
    """One plan's halo schedule as index tensors on the device, built once
    per step-cache entry so a step copies nothing from the host."""

    spec: HaloSpec
    weights: torch.Tensor        # (K, window) f32 trapezoid masks
    core_rows: torch.Tensor      # (K, core_pad) window rows of each core block
    core_norm: torch.Tensor      # (K, core_pad) f32 normalizer, ones past core_len
    transfers: Tuple[_TransferTables, ...]
    out_rank: torch.Tensor       # (E,) rank whose core holds latent row x
    out_row: torch.Tensor        # (E,) row of x in that core

    @classmethod
    def build(cls, plan, device) -> "HaloTables":
        spec = halo_spec(plan)
        K = spec.num_partitions

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        core_rows = [[spec.core_start[k] - spec.starts[k] + i for i in range(spec.core_pad)]
                     for k in range(K)]
        norm = plan.normalizer()
        core_norm = np.ones((K, spec.core_pad), np.float32)
        for k in range(K):
            core_norm[k, :spec.core_len[k]] = norm[spec.core_start[k]:spec.core_end[k]]
        transfers = []
        for t in spec.transfers:
            ar = np.arange(t.length)
            senders = dict((k, j) for j, k in t.perm)
            transfers.append(_TransferTables(
                src_rows=idx([[t.src_start[j] + i for i in ar] for j in range(K)]),
                valid=torch.as_tensor(
                    np.stack([ar < t.src_len[j] for j in range(K)]), device=device),
                src_of=idx([senders.get(k, 0) for k in range(K)]),
                has_peer=torch.as_tensor([k in senders for k in range(K)], device=device),
                dst_rows=idx([[t.dst_start[k] + i for i in ar] for k in range(K)]),
            ))
        out_rank, out_row = [], []
        for k in range(K):
            out_rank += [k] * spec.core_len[k]
            out_row += list(range(spec.core_len[k]))
        if sum(spec.core_len) != spec.extent or list(spec.core_start[1:]) != list(
                spec.core_end[:-1]):
            raise ValueError(f"cores {spec.core_start}..{spec.core_end} do not tile "
                             f"[0, {spec.extent})")
        return cls(spec=spec,
                   weights=torch.from_numpy(window_weights(plan)).to(device),
                   core_rows=idx(core_rows),
                   core_norm=torch.from_numpy(core_norm).to(device),
                   transfers=tuple(transfers),
                   out_rank=idx(out_rank), out_row=idx(out_row))


def simulate_halo_forward(
    denoise_fn,
    z: torch.Tensor,
    plan,
    axis: int,
    codec=None,
    state: Optional[WireState] = None,
    nan_guard: bool = False,
    tables: Optional[HaloTables] = None,
):
    """Single-device replay of the codec'd halo-LP forward pass.

    Bit-faithful to the reference's ``simulate_halo_forward``: the K
    windows go through ``denoise_fn`` as one batch stacked on axis 0 (as
    ``lp_forward_uniform`` does), every rank's weighted slab is encoded
    with its own per-slab scale and state slice, delivery follows
    ``halo_spec``, cores are normalized and round-tripped through the
    gather codec.  A rank's core block is ``core_pad`` rows long: past
    ``core_len`` it holds the rank's own window rows, which enter that
    core's scale as in the reference.  Stateless codecs return the
    latent, stateful ones ``(latent, new_state)``.  ``nan_guard`` falls
    back per message (:func:`_finite_or`).  ``tables`` (from
    ``HaloTables.build(plan, device)``) saves rebuilding the schedule.
    """
    codec = get_codec(codec)
    stateful = isinstance(codec, ResidualCodec)
    base = codec.base if stateful else codec
    if stateful and state is None:
        raise ValueError(f"codec {codec.name!r} needs init_halo_wire_state")
    if tables is None:
        tables = HaloTables.build(plan, z.device)
    spec = tables.spec
    K = plan.num_partitions
    windows = stack_windows(z, plan, axis)                 # (K, ...)
    preds = denoise_fn(windows.reshape((K * windows.shape[1],) + windows.shape[2:]))
    preds = preds.reshape(windows.shape).float()
    wshape = [1] * preds.ndim
    wshape[0] = K
    wshape[axis + 1] = plan.window
    wp = torch.movedim(preds * tables.weights.reshape(wshape), axis + 1, 1)  # (K, W, rest)
    rest = tuple(wp.shape[2:])
    trail = (1,) * len(rest)
    wp = torch.cat([wp, wp.new_zeros((K, spec.pad) + rest)], dim=1)
    ranks = torch.arange(K, device=z.device)[:, None]

    accs = torch.cat([wp[ranks, tables.core_rows],
                      wp.new_zeros((K, spec.max_transfer) + rest)], dim=1)
    displaced = stateful and getattr(codec, "displaced", False)
    new_state: WireState = {"pp_send": {}, "pp_err": {}, "pp_recv": {}} if stateful else {}
    if displaced:
        new_state["fresh"] = torch.zeros_like(state["fresh"])
        fresh = (state["fresh"] > 0.5).reshape((K, 1) + trail)
    for t, tt in zip(spec.transfers, tables.transfers):
        dk = _dir_key(t)
        slab = wp[ranks, tt.src_rows] * tt.valid.reshape((K, t.length) + trail)
        if stateful:
            wire, meta, n_send, n_err = residual_encode(
                base, slab, state["pp_send"][dk], state["pp_err"][dk])
            new_state["pp_send"][dk] = n_send
            new_state["pp_err"][dk] = n_err
        else:
            wire, meta = codec.encode_many(slab)
        # ppermute: receiver k gets its sender's message, peerless ranks zeros
        peer = tt.has_peer.reshape((K,) + (1,) * (wire.ndim - 1))
        wire = torch.where(peer, wire[tt.src_of], 0)
        meta = tuple(torch.where(tt.has_peer.reshape((K,) + (1,) * (m.ndim - 1)),
                                 m[tt.src_of], 0.0) for m in meta)
        shape = (K, t.length) + rest
        if stateful:
            prev = state["pp_recv"][dk]                      # same-direction stale slab
            got, n_recv = residual_decode(base, wire, meta, prev, shape)
            if nan_guard:
                got = n_recv = _finite_rows_or(got, prev)
            new_state["pp_recv"][dk] = n_recv
            if displaced:
                got = torch.where(fresh, got, prev)
        else:
            got = codec.decode(wire, meta, shape)
            if nan_guard:
                got = _finite_rows_or(got, None)
        accs[ranks, tt.dst_rows] += got

    # normalize own cores (ones-padded normalizer rows)
    cores = accs[:, :spec.core_pad] / tables.core_norm.reshape((K, spec.core_pad) + trail)
    core_shape = (K, spec.core_pad) + rest
    if stateful:
        diag = torch.arange(K, device=z.device)
        corrected = cores - state["ag_prev"][diag, diag] + state["ag_err"]
        wires, metas = base.encode_many(corrected)
        d_all = base.decode(wires, metas, core_shape)
        if nan_guard:
            d_all = _finite_rows_or(d_all, None)
        gathered = state["ag_prev"][0] + d_all              # replicas are identical
        new_state["ag_prev"] = gathered.expand((K,) + gathered.shape)
        new_state["ag_err"] = corrected - d_all
    else:
        wires, metas = codec.encode_many(cores)
        gathered = codec.decode(wires, metas, core_shape)
        if nan_guard:
            gathered = _finite_rows_or(gathered, None)

    out = gathered[tables.out_rank, tables.out_row]          # (E, rest)
    out = torch.movedim(out, 0, axis).to(z.dtype)
    return (out, new_state) if stateful else out
