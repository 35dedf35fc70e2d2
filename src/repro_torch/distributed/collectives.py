"""Halo-exchange geometry: the static transfer schedule of halo LP.

The framework-free part of ``repro/distributed/collectives.py``
(``HaloTransfer``, ``HaloSpec``, ``halo_spec``), copied so the port
never imports the reference.  The collectives that run this schedule
across GPUs are ROADMAP Queue 1 item 6; on one process
``comm/wire.simulate_halo_forward`` replays it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HaloTransfer:
    """One ppermute round: every rank ``j`` with a nonempty overlap
    between its window and the core of rank ``j + offset`` sends that slab.

    Slabs are padded to ``length`` (the max over senders); ``src_len``
    masks the padding to zero before the send.  ``src_start`` is in the
    sender's window coordinates, ``dst_start`` in the receiver's core
    coordinates, both in latent units.
    """

    offset: int
    length: int
    perm: Tuple[Tuple[int, int], ...]
    src_start: Tuple[int, ...]
    src_len: Tuple[int, ...]
    dst_start: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Static transfer schedule for halo-exchange LP reconstruction."""

    num_partitions: int
    window: int
    extent: int
    starts: Tuple[int, ...]
    core_start: Tuple[int, ...]
    core_end: Tuple[int, ...]
    core_pad: int                      # max core length (all-gather shard)
    transfers: Tuple[HaloTransfer, ...]

    @property
    def core_len(self) -> Tuple[int, ...]:
        return tuple(e - s for s, e in zip(self.core_start, self.core_end))

    @property
    def max_transfer(self) -> int:
        return max((t.length for t in self.transfers), default=0)

    @property
    def pad(self) -> int:
        """Zero rows a window buffer needs so every slab slice is in
        bounds."""
        return max(self.core_pad, self.max_transfer)


def halo_spec(plan) -> HaloSpec:
    """The exact transfer schedule of a uniform-window plan: for every
    rank pair (j, k) the slab is ``window_j ∩ core_k``, grouped by
    offset ``k - j`` so each group is one round."""
    K = plan.num_partitions
    core_len = [plan.core_end[k] - plan.core_start[k] for k in range(K)]
    transfers = []
    for d in [x for x in range(-(K - 1), K) if x != 0]:
        pairs = []
        for j in range(K):
            k = j + d
            if not 0 <= k < K:
                continue
            lo = max(plan.starts[j], plan.core_start[k])
            hi = min(plan.starts[j] + plan.window, plan.core_end[k])
            if hi > lo:
                pairs.append((j, k, lo, hi))
        if not pairs:
            continue
        length = max(hi - lo for (_, _, lo, hi) in pairs)
        src_start, src_len, dst_start = [0] * K, [0] * K, [0] * K
        perm = []
        for j, k, lo, hi in pairs:
            perm.append((j, k))
            src_start[j] = lo - plan.starts[j]
            src_len[j] = hi - lo
            dst_start[k] = lo - plan.core_start[k]
        transfers.append(HaloTransfer(
            offset=d, length=length, perm=tuple(perm),
            src_start=tuple(src_start), src_len=tuple(src_len),
            dst_start=tuple(dst_start),
        ))
    return HaloSpec(
        num_partitions=K,
        window=plan.window,
        extent=plan.extent,
        starts=tuple(plan.starts),
        core_start=tuple(plan.core_start),
        core_end=tuple(plan.core_end),
        core_pad=max(core_len),
        transfers=tuple(transfers),
    )
