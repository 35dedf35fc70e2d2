"""Deterministic serving-fault injection: a port of
``repro/runtime/faults.py``, the public successor of the engine's private
``_step_fault`` test hook.

A :class:`ServingFaultPlan` scripts failures against the serving engine's
per-step hook (``LPServingEngine`` installs it when ``inject_fault=`` is
set, the CLIs via ``--inject-fault``), reusing the fire-once bookkeeping
of ``runtime/ft.FailureInjector``:

  * ``dead:G@S``     — LP group G stops heartbeating at step S.  Every
    step from S on raises :class:`ServingFault` (the collective "times
    out") AND feeds a missed heartbeat into the engine's
    ``runtime/health.GroupHealthMonitor``; after the monitor's bounded
    retries the group is declared dead and evicted, at which point the
    fault stops firing (the dead hardware left the ring).
  * ``slow:GxF``     — group G's synthetic heartbeats run F× the
    baseline from step 1: exercises the EMA slow path (core re-sizing /
    eventual eviction), never raises.
  * ``corrupt@S``    — the wire payload of step S decodes to NaN
    (:class:`CorruptingCodec` swapped in for exactly that step); the
    decode-path NaN/Inf guard (``comm/wire.py`` ``nan_guard``) must
    absorb it by falling back to the rank-local stale slab.
  * ``replica:R:dead@S`` — the WHOLE replica R (its entire mesh, not
    one LP group) dies at denoise step S of whatever batch it is
    running: the step hook raises :class:`ReplicaDeath`, which is *not*
    recoverable engine-side (there is no surviving group to shrink to)
    and surfaces straight out of ``engine.run`` for the
    ``serving/router.ReplicaRouter`` to handle (requeue the in-flight
    batch to survivors, mark the replica dead).
  * ``replica:R:<chunk>`` — any base chunk (``dead:G@S`` / ``slow:GxF``
    / ``corrupt@S``) scoped to replica R only; the router splits these
    out per replica (:meth:`ServingFaultPlan.for_replica`) and hands
    each engine its own sub-plan.  A top-level plan with replica-scoped
    targets cannot be passed to a bare engine — only the router knows
    which replica it is.

Specs compose comma-separated: ``dead:1@4,corrupt@2`` or
``replica:1:dead@3,replica:0:slow:1x2``.  All injection is host-side
and deterministic: faults fire between steps, so the same spec replays
bit-identically, and on every rank of a group alike (each rank holds the
same plan, so each reaches the same verdict in the same step hook,
before any collective of the step).  Every parse error names the offending chunk, and
:meth:`ServingFaultPlan.describe` round-trips: parsing its output
yields an equivalent plan.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import torch

from repro_torch.comm.codecs import Codec, get_codec


class ServingFault(RuntimeError):
    """A denoise step failed for a *recoverable* serving reason (group
    death, injected wire fault).  ``LPServingEngine.run()`` retries only
    this and ``runtime/ft.DeviceFailure`` — anything else (a real torch /
    CUDA / programming error) surfaces immediately instead of burning the
    restart budget on a deterministic failure.

    ``step`` records the 1-indexed denoise step that was about to run
    when the fault fired, so recovery can account lost work against the
    last boundary snapshot.
    """

    def __init__(self, msg: str, step: Optional[int] = None):
        super().__init__(msg)
        self.step = step


class GroupEvicted(RuntimeError):
    """Raised by ``LPServingEngine.run`` on every rank of an LP group that
    an elastic re-plan evicted from the ring (the group's processes leave:
    the survivors continue on a shrunken group without them).  Not a
    :class:`ServingFault`: the engine on that rank does not retry, and it
    serves nothing more.  ``launch/mesh.run_lp_world`` counts it as the
    rank's success (``Evicted``).  ``group`` is the evicted group's index
    in the ring it left, ``step`` the denoise step the eviction applied
    before."""

    def __init__(self, msg: str, group: int, step: Optional[int] = None):
        super().__init__(msg)
        self.group = group
        self.step = step


class ReplicaDeath(RuntimeError):
    """A whole serving replica (its entire mesh) died mid-batch.

    Deliberately NOT a :class:`ServingFault` subclass: the engine's
    retry loop must not burn restarts on it — with every LP group gone
    there is no smaller mesh to shrink to and no snapshot that helps.
    It surfaces straight out of ``LPServingEngine.run`` so the replica
    router can requeue the in-flight batch to surviving replicas and
    mark this one dead.

    ``replica`` is the router-level replica id, ``step`` the 1-indexed
    denoise step that was about to run when the replica died.
    """

    def __init__(self, msg: str, replica: Optional[int] = None,
                 step: Optional[int] = None):
        super().__init__(msg)
        self.replica = replica
        self.step = step


@dataclasses.dataclass(frozen=True)
class CorruptingCodec(Codec):
    """Wraps a stateless codec; its decode poisons every element to NaN.

    Models a corrupted wire payload (bit-flips on the link, a truncated
    DMA): the encode side is untouched — bytes on the wire, the
    collectives, and cache keys stay honest — but everything decoded
    from the wire is garbage.  Stateless only: ``comm/wire.py`` routes
    stateful codecs through ``isinstance(codec, ResidualCodec)``, so a
    corrupting wrapper there would silently demote them.  The name is
    distinct (``<base>-corrupt``) on purpose: it keys separate
    step-cache entries, so swapping the codec for one step can never
    poison a healthy step's entry.
    """

    base: Codec = None  # type: ignore[assignment]

    @staticmethod
    def wrap(base) -> "CorruptingCodec":
        base = get_codec(base)
        if base.stateful:
            raise ValueError(
                f"CorruptingCodec wraps stateless codecs only, got "
                f"{base.name!r} (wrap its base instead)"
            )
        return CorruptingCodec(
            name=f"{base.name}-corrupt", bits=base.bits,
            meta_bytes=base.meta_bytes, stateful=False, base=base,
        )

    def encode_many(self, x):
        return self.base.encode_many(x)

    def decode(self, wire, meta, shape):
        dec = self.base.decode(wire, meta, shape)
        return torch.full(tuple(shape), float("nan"), dtype=torch.float32,
                          device=dec.device) + 0.0 * dec


_DEAD_RE = re.compile(r"^dead:(\d+)@(\d+)$")
_SLOW_RE = re.compile(r"^slow:(\d+)x([\d.]+)$")
_CORRUPT_RE = re.compile(r"^corrupt@(\d+)$")
_REPLICA_DEAD_RE = re.compile(r"^replica:(\d+):dead@(\d+)$")
_REPLICA_RE = re.compile(r"^replica:(\d+):(.+)$")


def _parse_error(chunk: str, why: str) -> ValueError:
    """Every fault-spec parse error names the offending chunk."""
    return ValueError(f"bad fault spec chunk {chunk!r}: {why}")


@dataclasses.dataclass
class ServingFaultPlan:
    """Scripted faults against the serving step hook (fire-once where it
    matters, like ``runtime/ft.FailureInjector``)."""

    dead: Tuple[Tuple[int, int], ...] = ()      # (group, from_step)
    slow: Tuple[Tuple[int, float], ...] = ()    # (group, factor)
    corrupt: Tuple[int, ...] = ()               # steps with a NaN wire
    # router-level targets (serving/router.ReplicaRouter splits these
    # out per replica; a bare engine refuses a plan that carries them):
    replica_dead: Tuple[Tuple[int, int], ...] = ()   # (replica, step)
    replica_scoped: Tuple[Tuple[int, str], ...] = () # (replica, chunk)
    # per-replica plan fields (set by ``for_replica``, never by parse):
    # the whole replica dies at ``die_step`` — the step hook raises
    # ReplicaDeath, sticky once fired
    die_step: Optional[int] = None
    die_replica: Optional[int] = None
    baseline_s: float = 1.0                     # synthetic healthy heartbeat
    _die_fired: bool = False
    _recovered: set = dataclasses.field(default_factory=set)
    _corrupt_fired: set = dataclasses.field(default_factory=set)
    # dead faults are STICKY once triggered: a batch retry resumes from
    # an earlier snapshot step, but the host that died at step S does
    # not resurrect because the step counter rewound — without this the
    # replayed healthy heartbeats would reset the monitor's miss budget
    # and recovery could never converge
    _dead_active: set = dataclasses.field(default_factory=set)
    # first-fire event log for the observability plane: one entry per
    # fault *activation* (corrupt swap, first step a group goes dead),
    # drained incrementally by the engine's step hook
    _events: List[dict] = dataclasses.field(default_factory=list)
    _drained: int = 0

    # ------------------------------------------------------------ parsing
    @staticmethod
    def _parse_base_chunk(chunk: str, dead, slow, corrupt,
                          seen_dead, seen_slow, seen_corrupt,
                          label: Optional[str] = None) -> None:
        """Parse one engine-level chunk into the accumulators, naming
        the offending chunk in every error (malformed form, bad value,
        duplicate target).  ``label`` overrides the name shown in
        errors — replica-scoped chunks report the full
        ``replica:R:...`` spelling the operator wrote."""
        err_name = chunk if label is None else label
        if m := _DEAD_RE.match(chunk):
            g, s = int(m.group(1)), int(m.group(2))
            if s < 1:
                raise _parse_error(err_name, "steps are 1-indexed")
            if g in seen_dead:
                raise _parse_error(
                    err_name, f"duplicate dead target: group {g} already "
                    f"dies at step {dict(dead)[g]}")
            seen_dead.add(g)
            dead.append((g, s))
        elif m := _SLOW_RE.match(chunk):
            g, f = int(m.group(1)), float(m.group(2))
            if f <= 0:
                raise _parse_error(err_name, "slowdown factor must be > 0")
            if g in seen_slow:
                raise _parse_error(
                    err_name, f"duplicate slow target: group {g} already "
                    f"has a factor")
            seen_slow.add(g)
            slow.append((g, f))
        elif m := _CORRUPT_RE.match(chunk):
            s = int(m.group(1))
            if s < 1:
                raise _parse_error(err_name, "steps are 1-indexed")
            if s in seen_corrupt:
                raise _parse_error(
                    err_name, f"duplicate corrupt target: step {s} is "
                    f"already poisoned")
            seen_corrupt.add(s)
            corrupt.append(s)
        else:
            raise _parse_error(
                err_name, "want dead:G@S, slow:GxF, corrupt@S, "
                "replica:R:dead@S or replica:R:<chunk> "
                "(comma-separated)")

    @staticmethod
    def parse(spec: str) -> "ServingFaultPlan":
        dead: List[Tuple[int, int]] = []
        slow: List[Tuple[int, float]] = []
        corrupt: List[int] = []
        replica_dead: List[Tuple[int, int]] = []
        replica_scoped: List[Tuple[int, str]] = []
        seen_dead: set = set()
        seen_slow: set = set()
        seen_corrupt: set = set()
        seen_replica_dead: set = set()
        # per-replica duplicate tracking for scoped chunks
        scoped_seen: dict = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if m := _REPLICA_DEAD_RE.match(part):
                r, s = int(m.group(1)), int(m.group(2))
                if s < 1:
                    raise _parse_error(part, "steps are 1-indexed")
                if r in seen_replica_dead:
                    raise _parse_error(
                        part, f"duplicate replica-dead target: replica "
                        f"{r} already dies at step "
                        f"{dict(replica_dead)[r]}")
                seen_replica_dead.add(r)
                replica_dead.append((r, s))
            elif m := _REPLICA_RE.match(part):
                r, sub = int(m.group(1)), m.group(2).strip()
                if sub.startswith("replica:"):
                    raise _parse_error(part, "replica targets do not nest")
                acc = scoped_seen.setdefault(
                    r, ([], [], [], set(), set(), set()))
                # validate (and duplicate-check within the replica) now,
                # so a bad scoped chunk fails at parse time, not when
                # the router splits the plan
                ServingFaultPlan._parse_base_chunk(sub, *acc, label=part)
                replica_scoped.append((r, sub))
            else:
                ServingFaultPlan._parse_base_chunk(
                    part, dead, slow, corrupt,
                    seen_dead, seen_slow, seen_corrupt)
        return ServingFaultPlan(
            dead=tuple(dead), slow=tuple(slow),
            corrupt=tuple(sorted(corrupt)),
            replica_dead=tuple(replica_dead),
            replica_scoped=tuple(replica_scoped))

    def describe(self) -> str:
        """Canonical string form; ``parse(describe())`` yields an
        equivalent plan (the round-trip the tests pin).  A per-replica
        sub-plan's whole-replica death renders back in top-level
        grammar (``replica:R:dead@S``)."""
        parts = [f"dead:{g}@{s}" for g, s in self.dead]
        parts += [f"slow:{g}x{f:g}" for g, f in self.slow]
        parts += [f"corrupt@{s}" for s in self.corrupt]
        parts += [f"replica:{r}:dead@{s}" for r, s in self.replica_dead]
        parts += [f"replica:{r}:{c}" for r, c in self.replica_scoped]
        if self.die_step is not None:
            parts.append(f"replica:{self.die_replica}:dead@{self.die_step}")
        return ",".join(parts) or "none"

    # -------------------------------------------------- replica routing
    @property
    def has_replica_targets(self) -> bool:
        """True when the plan carries router-level targets that a bare
        engine cannot interpret (it does not know which replica it is)."""
        return bool(self.replica_dead or self.replica_scoped)

    def replicas_targeted(self) -> List[int]:
        """Sorted replica ids named anywhere in the plan — the router
        validates them against its fleet size."""
        ids = {r for r, _ in self.replica_dead}
        ids |= {r for r, _ in self.replica_scoped}
        return sorted(ids)

    def for_replica(self, replica: int) -> Optional["ServingFaultPlan"]:
        """Split out replica ``replica``'s sub-plan: its scoped base
        chunks become a normal engine-level plan, and a
        ``replica:R:dead@S`` target becomes ``die_step`` (the step hook
        raises :class:`ReplicaDeath` there).  Returns ``None`` when the
        plan has nothing for this replica.  Engine-level chunks WITHOUT
        a replica scope are fleet-wide and deliberately not included —
        scope them explicitly when routing."""
        chunks = [c for r, c in self.replica_scoped if r == replica]
        die = dict(self.replica_dead).get(replica)
        if not chunks and die is None:
            return None
        sub = (ServingFaultPlan.parse(",".join(chunks)) if chunks
               else ServingFaultPlan())
        sub.die_step = die
        sub.die_replica = replica if die is not None else None
        sub.baseline_s = self.baseline_s
        return sub

    # ----------------------------------------------------------- behaviour
    def _activate_dead(self, group: int, step: int) -> None:
        """Mark a dead fault live, logging its first activation only."""
        if group not in self._dead_active:
            self._events.append(
                {"kind": "dead", "group": group, "step": step})
        self._dead_active.add(group)

    def drain_events(self) -> List[dict]:
        """Fault activations logged since the last drain — the trace
        feeder (``serving/engine.py`` forwards these to the flight
        recorder as ``fault.*`` instants).  Each event carries the step
        it fired at, so drain timing cannot skew the record."""
        new = self._events[self._drained:]
        self._drained = len(self._events)
        return new

    @property
    def touches_health(self) -> bool:
        """True when the plan needs heartbeats fed to a health monitor."""
        return bool(self.dead or self.slow)

    def heartbeats(self, step: int, num_groups: int) -> List[float]:
        """Synthetic per-group step times for ``step`` (what an external
        monitor would report): ``inf`` for a dead group past its fault
        step, ``factor * baseline`` for slow groups, baseline otherwise.
        Evicted dead groups (``mark_recovered``) drop out of the layout,
        so the list always matches the CURRENT group count."""
        t = [self.baseline_s] * num_groups
        for g, f in self.slow:
            if g < num_groups and g not in self._recovered:
                t[g] = f * self.baseline_s
        for g, s in self.dead:
            if g in self._recovered or g >= num_groups:
                continue
            if step >= s:
                self._activate_dead(g, step)
            if g in self._dead_active:
                t[g] = float("inf")
        return t

    def active_dead(self, step: int) -> Optional[int]:
        """The (first) dead group whose fault is live at ``step`` —
        sticky: once triggered it fires at every step (including steps
        before S replayed by a snapshot-resumed retry) until the engine
        evicts the group (``mark_recovered``)."""
        for g, s in self.dead:
            if g in self._recovered:
                continue
            if step >= s or g in self._dead_active:
                self._activate_dead(g, step)
                return g
        return None

    def mark_recovered(self, group: int) -> None:
        """The engine evicted ``group``: its dead/slow faults stop firing
        (the hardware left the ring; surviving groups re-index)."""
        self._recovered.add(group)

    def die_fires(self, step: int) -> bool:
        """Whole-replica death check (per-replica plans only): sticky —
        once ``die_step`` is reached the replica is gone at every later
        step too (including earlier steps replayed by a retry; dead
        hardware does not resurrect because a step counter rewound)."""
        if self.die_step is None:
            return False
        if self._die_fired or step >= self.die_step:
            if not self._die_fired:
                self._die_fired = True
                self._events.append({
                    "kind": "replica_dead",
                    "replica": self.die_replica, "step": step})
            return True
        return False

    def corrupt_fires(self, step: int) -> bool:
        """Fire-once check: True exactly the first time ``step`` is hit
        (a retried batch replays the step with a clean wire — the
        corruption was transient, as on real links)."""
        if step in self.corrupt and step not in self._corrupt_fired:
            self._corrupt_fired.add(step)
            self._events.append({"kind": "corrupt", "step": step})
            return True
        return False


def parse_fault_plan(spec) -> Optional[ServingFaultPlan]:
    """CLI/engine entry: None passes through, strings parse, plans are
    taken as-is."""
    if spec is None:
        return None
    if isinstance(spec, ServingFaultPlan):
        return spec
    return ServingFaultPlan.parse(spec)
