"""Group health for the LP serving ring: slow is not dead.  A copy of
``repro/runtime/health.py`` (numpy only), without its optional metrics
registry (observability is ROADMAP Queue 1 item 7).

``runtime/straggler.StragglerState`` sees only finite step times, so its
EMA can flag a *slow* group (rebalance, eventually evict at the 2×-median
threshold) but can never notice a group that stopped reporting at all —
a dead host looks like "no new observation" and the stale EMA keeps it
healthy forever.  :class:`GroupHealthMonitor` generalizes the monitor
with **heartbeat deadlines**:

  * every ``observe()`` is one heartbeat round; a group whose entry is
    missing (``None`` / ``inf`` / ``nan``) or beyond its current
    deadline scores a *miss*, everything else feeds the wrapped EMA;
  * a miss does not kill: the group gets ``max_misses`` retry rounds,
    each with a backoff-extended deadline (``deadline × backoff^misses``
    — transient hiccups, a GC pause, a link retrain get time to clear);
  * only after the retry budget is exhausted is the group **dead**:
    :meth:`propose` then returns an immediate eviction proposal with
    ``reason="dead"``, bypassing the EMA's 2×-median slow test.  Slow
    proposals still come from the wrapped
    ``StragglerState.propose_group_eviction`` (``reason="slow"``).

The monitor never evicts below 2 LP groups (same floor as the straggler
EMA: a 1-group "ring" is not LP), and :meth:`evict` re-maps indices the
same way ``StragglerState.evict`` does, so misses follow their group to
its new index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .straggler import StragglerState


@dataclasses.dataclass(frozen=True)
class EvictionProposal:
    """A concrete shrink proposal: drop ``group``, rebuild at
    ``new_mesh_shape`` (LP axis one smaller, tp untouched)."""

    group: int
    new_mesh_shape: Tuple[int, ...]
    reason: str                      # "dead" | "slow"


@dataclasses.dataclass
class GroupHealthMonitor:
    """Heartbeat-deadline health on top of the straggler EMA."""

    num_groups: int
    deadline_factor: float = 4.0     # miss when t > factor × median EMA
    max_misses: int = 2              # retry rounds before declaring death
    backoff: float = 1.5             # deadline growth per missed round
    default_deadline_s: float = 30.0  # before any EMA history exists
    straggler: StragglerState = None  # type: ignore[assignment]
    _misses: np.ndarray = None        # type: ignore[assignment]
    _dead: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        if self.straggler is None:
            self.straggler = StragglerState(self.num_groups)
        if self._misses is None:
            self._misses = np.zeros(self.num_groups, dtype=np.int64)

    # ---------------------------------------------------------- heartbeats
    def deadline_s(self, group: int) -> float:
        """Current per-step deadline for ``group``: the fleet-median EMA
        times ``deadline_factor``, backoff-extended by the group's missed
        rounds so far (bounded retry: each miss buys the next round more
        slack, until the budget runs out)."""
        ema = self.straggler._ema
        base = self.default_deadline_s if ema is None else \
            self.deadline_factor * float(np.median(ema))
        return base * self.backoff ** int(self._misses[group])

    def observe(self, step_times: Sequence[Optional[float]]) -> None:
        """One heartbeat round.  Missing (None/inf/nan) or
        deadline-breaking entries count a miss; on-time entries clear
        the miss counter and feed the EMA.  A missed group feeds the
        fleet median instead of its (possibly infinite) reading: misses
        are judged by the retry counter, not the EMA, so a single
        deadline break must neither poison the median with infinities
        nor trip the EMA's 2×-median *slow* eviction before the miss
        budget has run out (dead-vs-slow stay separate verdicts)."""
        t = [math.inf if x is None else float(x) for x in step_times]
        if len(t) != self.num_groups:
            # layout changed without evict(): restart, like the EMA does
            self.num_groups = len(t)
            self._misses = np.zeros(len(t), dtype=np.int64)
            self._dead = set()
        missed = [not math.isfinite(x) or x > self.deadline_s(g)
                  for g, x in enumerate(t)]
        finite = [x for x, m in zip(t, missed) if not m]
        neutral = float(np.median(finite)) if finite else self.default_deadline_s
        feed = [neutral if m else x for x, m in zip(t, missed)]
        self.straggler.observe(feed)
        for g, m in enumerate(missed):
            if m:
                self._misses[g] += 1
                if self._misses[g] > self.max_misses:
                    self._dead.add(g)
            else:
                self._misses[g] = 0
                self._dead.discard(g)

    def mark_recovered(self, group: int) -> None:
        """External recovery signal: ``group`` came back (host restart,
        link re-trained, replica re-attached).  Clears its miss counter
        and dead verdict so the next heartbeat round judges it fresh —
        deadlines drop back to the un-backed-off base.  The EMA row is
        deliberately NOT reset: a recovered group that is still slow
        should keep tripping the straggler test (dead and slow stay
        separate verdicts, in both directions)."""
        if not 0 <= group < self.num_groups:
            raise ValueError(
                f"group {group} not in [0, {self.num_groups})")
        self._misses[group] = 0
        self._dead.discard(group)

    # ----------------------------------------------------------- proposals
    def dead_groups(self) -> List[int]:
        return sorted(self._dead)

    def propose(self, mesh_shape,
                slowdown_factor: float = 2.0) -> Optional[EvictionProposal]:
        """Dead first, slow second.  ``None`` when the ring is healthy or
        already at the 2-group floor (matching
        ``StragglerState.propose_group_eviction``)."""
        new_shape = (mesh_shape[0] - 1,) + tuple(mesh_shape[1:])
        if self._dead and mesh_shape[0] > 2:
            return EvictionProposal(min(self._dead), new_shape, "dead")
        prop = self.straggler.propose_group_eviction(
            mesh_shape, slowdown_factor=slowdown_factor)
        if prop is None:
            return None
        return EvictionProposal(prop[0], prop[1], "slow")

    def evict(self, group: int) -> None:
        """Apply an eviction: drop the group's miss row and re-map the
        survivors' indices (delegating the EMA row to the straggler)."""
        if not 0 <= group < self.num_groups:
            raise ValueError(
                f"group {group} not in [0, {self.num_groups})")
        self.straggler.evict(group)
        self.num_groups -= 1
        self._misses = np.delete(self._misses, group)
        self._dead = {g - 1 if g > group else g
                      for g in self._dead if g != group}
