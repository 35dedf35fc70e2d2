"""Straggler mitigation for LP serving: adaptive partition sizing.  A
copy of ``repro/runtime/straggler.py`` (numpy only), without its optional
metrics registry (observability is ROADMAP Queue 1 item 7).

LP's unit of work is *patches*, so a slow device (thermal throttling, a
noisy neighbour, a degraded ICI link) can be compensated by shrinking its
core region and growing everyone else's — the blend machinery is already
built for unequal partitions.  We keep an EMA of per-group step times and
re-plan core sizes proportional to measured speed, re-planning only when
the imbalance exceeds a threshold (re-planning starts a new step-cache entry,
so it is rate-limited).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.partition import PartitionPlan, _finalize


@dataclasses.dataclass
class StragglerState:
    num_partitions: int
    ema_alpha: float = 0.3
    rebalance_threshold: float = 0.15   # re-plan when >15% imbalance
    _ema: Optional[np.ndarray] = None

    def observe(self, step_times: Sequence[float]) -> None:
        t = np.asarray(step_times, dtype=np.float64)
        if len(t) != self.num_partitions:
            # group count changed without evict() — restart the EMA on
            # the new layout rather than broadcasting stale history
            self.num_partitions = len(t)
            self._ema = None
        if self._ema is None:
            self._ema = t
        else:
            self._ema = self.ema_alpha * t + (1 - self.ema_alpha) * self._ema

    @property
    def speeds(self) -> np.ndarray:
        """Relative speed per group (1/time), normalized to mean 1."""
        if self._ema is None:
            return np.ones(self.num_partitions)
        s = 1.0 / np.maximum(self._ema, 1e-9)
        return s / s.mean()

    def needs_rebalance(self) -> bool:
        s = self.speeds
        return bool((s.max() - s.min()) / s.max() > self.rebalance_threshold)

    @property
    def slowest(self) -> int:
        """Index of the slowest group (largest step-time EMA)."""
        if self._ema is None:
            return 0
        return int(np.argmax(self._ema))

    def evict(self, group: int) -> None:
        """Drop ``group`` from the tracked layout after an applied
        eviction: the EMA row is removed so surviving groups keep their
        history under their NEW indices and the next ``observe`` expects
        ``num_partitions - 1`` step times."""
        if not 0 <= group < self.num_partitions:
            raise ValueError(f"group {group} not in [0, {self.num_partitions})")
        self.num_partitions -= 1
        if self._ema is not None:
            self._ema = np.delete(self._ema, group)

    def propose_group_eviction(
        self, mesh_shape, slowdown_factor: float = 2.0
    ):
        """Mid-request eviction proposal for the hybrid ``(M, T)`` mesh.

        Core re-sizing (:func:`plan_weighted_partition`) absorbs mild
        imbalance, but a group that is ``>= slowdown_factor`` slower than
        the median (dying host, broken ICI link) should be dropped from
        the LP ring entirely: returns ``(evicted_group, new_mesh_shape)``
        with ``M - 1`` groups, or ``None`` when no group is that far
        gone.  The caller applies it with
        ``runtime.elastic.replan_lp_compiler`` — which guarantees the
        compiled-step cache never reuses an entry for the old mesh shape
        and codec residual state resets exactly once — and then calls
        :meth:`evict` so this monitor tracks the shrunken ring.
        """
        if self._ema is None or mesh_shape[0] <= 2:
            return None
        worst = self.slowest
        med = float(np.median(np.delete(self._ema, worst)))
        if med <= 0 or float(self._ema[worst]) < slowdown_factor * med:
            return None
        return worst, (mesh_shape[0] - 1,) + tuple(mesh_shape[1:])


def plan_weighted_partition(
    extent: int,
    patch: int,
    overlap_ratio: float,
    speeds: Sequence[float],
    dim: int = 0,
) -> PartitionPlan:
    """Patch-aligned partition with core sizes proportional to speed.

    Largest-remainder apportionment of N patches over K groups; every
    group keeps >= 1 patch.  Overlap O scales with the *average* core size
    (same r semantics as the uniform plan)."""
    K = len(speeds)
    N = extent // patch
    if N < K:
        raise ValueError(f"N={N} patches < K={K} groups")
    s = np.clip(np.asarray(speeds, dtype=np.float64), 1e-3, None)
    quota = s / s.sum() * N
    base = np.maximum(np.floor(quota).astype(int), 1)
    # fix rounding to sum exactly N (largest remainders first)
    while base.sum() > N:
        base[np.argmax(base)] -= 1
    rem = quota - np.floor(quota)
    order = np.argsort(-rem)
    i = 0
    while base.sum() < N:
        base[order[i % K]] += 1
        i += 1
    L_avg = max(int(math.ceil(N / K)), 1)
    O = math.floor(L_avg * overlap_ratio)
    core_start, core_end = [], []
    pos = 0
    for k in range(K):
        core_start.append(pos)
        core_end.append(pos + int(base[k]))
        pos += int(base[k])
    assert pos == N
    return _finalize(dim, extent, patch, K, overlap_ratio, L_avg, O,
                     core_start, core_end)
