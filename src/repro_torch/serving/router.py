"""Fault-tolerant data-parallel replica router for the LP serving path.
A port of ``repro/serving/router.py``: host-side control flow only, held
to the original by ``tests/test_torch_router.py``.

One :class:`ReplicaRouter` fronts N independent :class:`LPServingEngine`
replicas (each its own mesh / compiled-step cache / ``VirtualClock``)
with one front-door queue, and owns the robustness stack the single
engine cannot: a replica dying MID-BATCH must not lose requests, an
overload burst must shed low-priority work loudly, and sustained
pressure must cost quality (cheaper codec schedules) before it costs
high-priority deadlines.

Simulation model — the router generalizes ``loadgen.run_workload``'s
open-loop replay to N replicas as a discrete-event loop on virtual
time: every replica carries its own ``VirtualClock`` (the engine
advances it by each batch's *measured* wall), the router carries the
global ``now`` and only ever moves it forward to the next event (an
arrival, a replica coming free, a retry backoff expiring).  Dispatching
synchronizes the chosen replica's clock to ``now`` before handing it a
batch, so every lifecycle stamp — across all replicas — lives on one
coherent virtual timeline and the per-replica SLO report is exact.

The robustness stack, piece by piece:

* **Health states** (``healthy / degraded / draining / dead``): a
  router-level :class:`~repro_torch.runtime.health.GroupHealthMonitor` treats
  replicas as groups — every dispatch outcome is a heartbeat round
  (batch wall on success, a miss on failure), so a replica that stops
  completing work burns its miss budget and is DRAINED (no new
  dispatches) even if it never raised; engine signals act immediately
  (``ReplicaDeath`` -> dead, a terminal engine fault -> degraded, then
  draining past ``dead_after_failures``; a clean batch after restarts
  recovers degraded -> healthy, with ``health.mark_recovered``).
* **Admission control / backpressure**: engine queues are bounded
  (``max_queue``, ``QueueFull``) and the router holds all waiting work
  in its front-door queue (a dispatch hands an engine at most one
  batch, so engine bounds never trip in routed operation).  When the
  aggregate depth crosses ``shed_watermark``, the LOWEST-priority
  (largest class deadline), newest-arrival requests are shed — each
  with an explicit ``request.shed`` trace row
  (``FlightRecorder.record_shed``), never silently.
* **Retries / redispatch**: a batch lost to a replica death (or a
  terminal engine fault) is requeued with each request's ORIGINAL
  ``submit_s`` preserved — queue-wait accounting stays honest across
  replicas — behind a capped exponential backoff
  (``backoff_base_s * 2^(attempt-1)``, capped at ``backoff_cap_s``),
  up to ``max_redispatch`` attempts before a terminal
  ``request.failed`` row with ``terminal=True``
  (``FlightRecorder.record_failed``).  Dispatch order is
  deadline-aware: the queued request with the earliest absolute
  deadline (``submit_s`` + its SLO class deadline) goes first, and its
  geometry bucket rides along.
* **Graceful degradation**: when the queue sits above
  ``degrade_watermark`` for ``degrade_patience_s`` of virtual time, the
  router relaxes every class's ``psnr_floor`` by ``degrade_step_db``
  (never below ``min_psnr_floor_db``, the int4 conformance envelope) —
  outgoing requests carry the relaxed floor and every live engine with
  an autotuned schedule re-resolves toward cheaper codecs
  (``LPServingEngine.set_psnr_floor``).  Floors restore stepwise on
  recovery.  Both directions are recorded (``router.degrade`` /
  ``router.restore`` instants, ``router.degrade_steps`` /
  ``router.restore_steps`` counters).

Fault drills: the ``replica:<id>:`` grammar
(``runtime/faults.ServingFaultPlan``) scopes chunks to one replica —
``replica:1:dead@3`` kills replica 1 whole at denoise step 3
(:class:`~repro_torch.runtime.faults.ReplicaDeath` propagates out of
``engine.run``; a dead replica cannot retry itself), and
``replica:0:slow:2x3`` runs the ordinary engine-level drill on replica
0 only.  The router splits the plan with
``ServingFaultPlan.for_replica`` at construction; a bare engine refuses
replica-scoped plans.

Everything here is host-side control flow with no device code of its
own, and a fixed workload seed + fault plan replays byte-identically.  Replicas may share one DiT module (one copy of the
weights on the card), each with its own step cache, queue and clock.  On a
group every rank runs the same router over the same replicas: the engines'
ranks agree on each batch's wall, so every rank's clocks, heartbeats and
dispatch decisions are the same, and so are the collectives they run.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import metrics as obsm
from repro_torch.runtime.faults import ReplicaDeath, ServingFault, \
    parse_fault_plan
from repro_torch.runtime.ft import DeviceFailure
from repro_torch.runtime.health import GroupHealthMonitor

from .engine import LPServingEngine, QueueFull, VideoRequest, VideoResult
from .loadgen import Arrival, VirtualClock, _default_make_context

REPLICA_STATES = ("healthy", "degraded", "draining", "dead")
ROUTER_POLICIES = ("least-loaded", "round-robin")


@dataclasses.dataclass
class _Pending:
    """One front-door queue entry: the request plus its routing state.

    ``submit_s`` is the ORIGINAL arrival stamp and never changes — a
    redispatched request's queue wait keeps accruing from its first
    arrival, not from the retry."""

    request: VideoRequest
    submit_s: float
    deadline_s: float          # absolute: submit_s + class deadline
    class_deadline_s: float    # relative class deadline (shed ranking)
    redispatches: int = 0
    not_before_s: float = 0.0  # retry backoff gate


@dataclasses.dataclass
class _Replica:
    idx: int
    engine: LPServingEngine
    clock: VirtualClock
    state: str = "healthy"
    free_s: float = 0.0        # virtual time the replica is free at
    failures: int = 0          # consecutive terminal engine faults
    last_wall: Optional[float] = None
    dispatches: int = 0

    @property
    def live(self) -> bool:
        return self.state in ("healthy", "degraded")


class ReplicaRouter:
    """Dispatch :class:`VideoRequest` s across N engine replicas."""

    def __init__(
        self,
        engines: Sequence[LPServingEngine],
        *,
        recorder=None,
        slo=None,
        policy: str = "least-loaded",
        max_redispatch: int = 2,
        shed_watermark: Optional[int] = None,
        degrade_watermark: Optional[int] = None,
        degrade_patience_s: float = 0.0,
        restore_patience_s: float = 0.0,
        degrade_step_db: float = 2.0,
        min_psnr_floor_db: float = 24.0,
        backoff_base_s: float = 0.25,
        backoff_cap_s: float = 4.0,
        dead_after_failures: int = 2,
        inject_fault=None,
        health: Optional[GroupHealthMonitor] = None,
    ):
        if not engines:
            raise ValueError("need at least one engine replica")
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"router policy must be one of {ROUTER_POLICIES}, "
                f"got {policy!r}")
        clocks = []
        for r, eng in enumerate(engines):
            if not isinstance(eng.clock, VirtualClock):
                raise ValueError(
                    f"replica {r}: engine must be constructed with its "
                    "own VirtualClock (LPServingEngine(clock=...)) — "
                    "the router coordinates per-replica virtual time")
            clocks.append(eng.clock)
        if len({id(c) for c in clocks}) != len(clocks):
            raise ValueError(
                "engine replicas must not share a VirtualClock: each "
                "replica's clock advances by ITS batch walls; sharing "
                "one would serialize concurrent replicas")
        self.policy = policy
        self.recorder = recorder if recorder is not None \
            else engines[0].recorder
        from repro_torch.obs.slo import SLOSpec
        self.slo = SLOSpec.parse(slo if slo is not None
                                 else engines[0].slo)
        self.max_redispatch = int(max_redispatch)
        total_batch = sum(e.max_batch for e in engines)
        self.shed_watermark = (8 * total_batch if shed_watermark is None
                               else int(shed_watermark))
        self.degrade_watermark = (
            max(total_batch, self.shed_watermark // 2)
            if degrade_watermark is None else int(degrade_watermark))
        self.degrade_patience_s = float(degrade_patience_s)
        self.restore_patience_s = float(restore_patience_s)
        self.degrade_step_db = float(degrade_step_db)
        self.min_psnr_floor_db = float(min_psnr_floor_db)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.dead_after_failures = int(dead_after_failures)

        self.replicas: List[_Replica] = []
        for r, eng in enumerate(engines):
            eng.replica_id = r
            self.replicas.append(_Replica(idx=r, engine=eng,
                                          clock=eng.clock))
        # split the fault plan per replica: scoped chunks become each
        # engine's ordinary plan, replica:R:dead@S becomes its die-step
        plan = parse_fault_plan(inject_fault)
        if plan is not None:
            if plan.dead or plan.slow or plan.corrupt or \
                    plan.die_step is not None:
                raise ValueError(
                    f"router fault plan {plan.describe()!r} has "
                    "unscoped chunks — scope every target with "
                    "replica:<id>: so the drill names which replica "
                    "it hits")
            bad = [r for r in plan.replicas_targeted()
                   if not 0 <= r < len(engines)]
            if bad:
                raise ValueError(
                    f"fault plan targets replica(s) {bad}, but only "
                    f"{len(engines)} replicas exist")
            for rep in self.replicas:
                sub = plan.for_replica(rep.idx)
                if sub is not None:
                    rep.engine._fault_plan = sub
        self.fault_plan = plan
        # replica heartbeats: every dispatch outcome is one round; a
        # replica that stops completing batches misses its deadline
        # budget and is drained even without an engine-level signal
        self.health = health if health is not None else \
            GroupHealthMonitor(
                len(engines),
                metrics=None if self.recorder is None
                else self.recorder.metrics)

        self._queue: List[_Pending] = []
        self._rr = 0                       # round-robin cursor
        self.now = 0.0
        self.results: List[VideoResult] = []
        self.degrade_level = 0
        self._overload_since: Optional[float] = None
        self._underload_since: Optional[float] = None
        # base autotuner floors per replica (None = engine has no
        # autotuned schedule; set_psnr_floor no-ops there)
        self._base_floor: Dict[int, Optional[float]] = {
            rep.idx: rep.engine.psnr_floor for rep in self.replicas}
        self.stats = {"admitted": 0, "completed": 0, "shed": 0,
                      "failed": 0, "redispatches": 0,
                      "replica_deaths": 0}
        self._gauge_health()

    # ------------------------------------------------------------ helpers
    def _instant(self, name: str, **args) -> None:
        if self.recorder is not None:
            self.recorder.instant(name, cat="router", **args)

    def _inc(self, name: str, value: float = 1.0, **labels) -> None:
        if self.recorder is not None:
            self.recorder.inc(name, value, **labels)

    def _gauge(self, name: str, value: float, **labels) -> None:
        if self.recorder is not None:
            self.recorder.gauge(name, value, **labels)

    def _gauge_health(self) -> None:
        self._gauge(obsm.ROUTER_HEALTHY_REPLICAS,
                    sum(1 for r in self.replicas
                        if r.state == "healthy"))

    def _set_state(self, rep: _Replica, state: str, reason: str) -> None:
        if state not in REPLICA_STATES:
            raise ValueError(f"unknown replica state {state!r}")
        if state == rep.state:
            return
        prev, rep.state = rep.state, state
        self._instant("router.replica_state", replica=rep.idx,
                      prev=prev, state=state, reason=reason,
                      now_s=self.now)
        self._gauge_health()

    def live_replicas(self) -> List[_Replica]:
        return [r for r in self.replicas if r.live]

    def queue_depth(self) -> int:
        return len(self._queue)

    # ---------------------------------------------------------- admission
    def submit(self, request: VideoRequest,
               submit_s: Optional[float] = None) -> None:
        """Admit one request to the front-door queue at ``submit_s``
        (default: the router's current virtual ``now``)."""
        s = self.now if submit_s is None else float(submit_s)
        cls_deadline = self.slo.deadline_for(str(request.priority))
        self._queue.append(_Pending(
            request=request, submit_s=s,
            deadline_s=s + cls_deadline,
            class_deadline_s=cls_deadline))
        self.stats["admitted"] += 1
        self._gauge(obsm.ROUTER_QUEUE_DEPTH, len(self._queue))

    def _shed_overflow(self) -> None:
        """Enforce the aggregate watermark: shed lowest-priority
        (largest class deadline), newest-arrival first — loudly."""
        while len(self._queue) > self.shed_watermark:
            victim = max(
                self._queue,
                key=lambda p: (p.class_deadline_s, p.submit_s,
                               p.request.request_id))
            self._queue.remove(victim)
            self.stats["shed"] += 1
            row = {
                "request_id": victim.request.request_id,
                "priority": str(victim.request.priority),
                "submit_s": victim.submit_s,
                "shed_s": self.now,
                "reason": "watermark",
                "queue_depth": len(self._queue) + 1,
                "watermark": self.shed_watermark,
            }
            if self.recorder is not None:
                self.recorder.record_shed(row)
            self._gauge(obsm.ROUTER_QUEUE_DEPTH, len(self._queue))

    def _fail_terminal(self, p: _Pending, reason: str) -> None:
        self.stats["failed"] += 1
        row = {
            "request_id": p.request.request_id,
            "priority": str(p.request.priority),
            "submit_s": p.submit_s,
            "failed_s": self.now,
            "redispatches": p.redispatches,
            "reason": reason,
            "terminal": True,
        }
        if self.recorder is not None:
            self.recorder.record_failed(row)

    # ------------------------------------------------------- degradation
    def _effective_floor(self, floor: Optional[float]) -> Optional[float]:
        if floor is None or self.degrade_level == 0:
            return floor
        return max(self.min_psnr_floor_db,
                   floor - self.degrade_level * self.degrade_step_db)

    def _apply_floors(self) -> None:
        for rep in self.replicas:
            if not rep.live:
                continue
            base = self._base_floor[rep.idx]
            if base is not None:
                rep.engine.set_psnr_floor(self._effective_floor(base))

    def _check_degradation(self) -> None:
        """Sustained overload costs quality before it costs deadlines;
        floors restore stepwise once the queue drains."""
        depth = len(self._queue)
        if depth > self.degrade_watermark:
            self._underload_since = None
            if self._overload_since is None:
                self._overload_since = self.now
            if self.now - self._overload_since >= self.degrade_patience_s:
                if self._can_degrade_further():
                    self.degrade_level += 1
                    self._overload_since = self.now  # re-arm patience
                    self._apply_floors()
                    self._instant(
                        "router.degrade", level=self.degrade_level,
                        queue_depth=depth,
                        step_db=self.degrade_step_db,
                        min_floor_db=self.min_psnr_floor_db,
                        now_s=self.now)
                    self._inc(obsm.ROUTER_DEGRADE_STEPS)
        elif depth <= self.degrade_watermark // 2:
            self._overload_since = None
            if self.degrade_level > 0:
                if self._underload_since is None:
                    self._underload_since = self.now
                if self.now - self._underload_since >= \
                        self.restore_patience_s:
                    self.degrade_level -= 1
                    self._underload_since = self.now
                    self._apply_floors()
                    self._instant(
                        "router.restore", level=self.degrade_level,
                        queue_depth=depth, now_s=self.now)
                    self._inc(obsm.ROUTER_RESTORE_STEPS)
        else:
            self._overload_since = None
            self._underload_since = None

    def _can_degrade_further(self) -> bool:
        """At least one class/engine floor is still above the envelope
        minimum — degrading past that would change nothing."""
        floors = [f for f in self._base_floor.values() if f is not None]
        floors += [p.request.psnr_floor for p in self._queue
                   if p.request.psnr_floor is not None]
        if not floors:
            return False
        next_level = self.degrade_level + 1
        return any(f - next_level * self.degrade_step_db
                   > self.min_psnr_floor_db - 1e-9 for f in floors)

    # ---------------------------------------------------------- dispatch
    @staticmethod
    def _bucket_key(p: _Pending) -> Tuple:
        return (tuple(p.request.latent_shape),
                float(p.request.guidance))

    def _pick_batch(self, rep: _Replica) -> List[_Pending]:
        """Deadline-aware batch selection: the dispatchable request with
        the earliest absolute deadline leads, and its geometry bucket
        rides along (a batch shares one compiled denoise)."""
        ready = [p for p in self._queue if p.not_before_s <= self.now]
        if not ready:
            return []
        ready.sort(key=lambda p: (p.deadline_s, p.submit_s,
                                  p.request.request_id))
        head = ready[0]
        key = self._bucket_key(head)
        batch = [p for p in ready if self._bucket_key(p) == key]
        return batch[: rep.engine.max_batch]

    def _pick_replica(self) -> Optional[_Replica]:
        free = [r for r in self.replicas
                if r.live and r.free_s <= self.now]
        if not free:
            return None
        if self.policy == "round-robin":
            n = len(self.replicas)
            for off in range(1, n + 1):
                cand = self.replicas[(self._rr + off) % n]
                if cand in free:
                    self._rr = cand.idx
                    return cand
            return None
        # least-loaded: healthy before degraded, then the replica that
        # has done the least work, then stable index order
        free.sort(key=lambda r: (r.state != "healthy", r.dispatches,
                                 r.idx))
        return free[0]

    def _requeue_lost(self, rep: _Replica, batch: List[_Pending],
                      why: str) -> None:
        """A batch died with its replica (or a terminal engine fault):
        requeue each request with its ORIGINAL submit_s behind a capped
        exponential backoff, up to ``max_redispatch`` attempts."""
        # scrub the dead engine's queue/lifecycle so a later restart
        # cannot resurrect stale stamps
        for p in batch:
            rep.engine._lifecycle.pop(p.request.request_id, None)
            rep.engine._enqueued_at.pop(p.request.request_id, None)
        rep.engine._inflight = []
        rep.engine._queue = []
        for p in batch:
            p.redispatches += 1
            if p.redispatches > self.max_redispatch:
                self._fail_terminal(p, reason=why)
                continue
            backoff = min(
                self.backoff_cap_s,
                self.backoff_base_s * 2.0 ** (p.redispatches - 1))
            p.not_before_s = self.now + backoff
            self._queue.append(p)
            self.stats["redispatches"] += 1
            self._instant("router.redispatch",
                          request_id=p.request.request_id,
                          priority=str(p.request.priority),
                          attempt=p.redispatches,
                          backoff_s=backoff, replica=rep.idx,
                          reason=why, now_s=self.now)
            self._inc(obsm.ROUTER_REDISPATCHES, replica=str(rep.idx))
        self._gauge(obsm.ROUTER_QUEUE_DEPTH, len(self._queue))

    def _heartbeat(self, rep: _Replica, wall: Optional[float]) -> None:
        """One heartbeat round from this dispatch outcome: the serving
        replica reports its wall (None = it failed to complete), idle
        live replicas report their last known wall (still responsive),
        dead/draining replicas miss."""
        rep.last_wall = wall
        neutral = wall if wall is not None else None
        beats: List[Optional[float]] = []
        for r in self.replicas:
            if not r.live:
                beats.append(None)
            elif r.idx == rep.idx:
                beats.append(wall)
            else:
                beats.append(r.last_wall if r.last_wall is not None
                             else neutral)
        self.health.observe(beats)
        for g in self.health.dead_groups():
            r = self.replicas[g]
            if r.live:
                # heartbeat budget exhausted without an engine-level
                # signal: stop dispatching, let in-flight work finish
                self._set_state(r, "draining", "heartbeat_misses")

    def _dispatch(self, rep: _Replica, batch: List[_Pending],
                  max_restarts_per_batch: int = 2) -> None:
        """Hand ``batch`` to ``rep`` at virtual ``now`` and run it to
        completion (the engine is synchronous; concurrency lives in the
        per-replica clocks)."""
        chosen = {id(p) for p in batch}
        self._queue = [p for p in self._queue if id(p) not in chosen]
        rep.clock.advance_to(self.now)
        for p in batch:
            req = p.request
            eff = self._effective_floor(req.psnr_floor)
            if eff != req.psnr_floor:
                req = dataclasses.replace(req, psnr_floor=eff)
            try:
                rep.engine.submit(req, submit_s=p.submit_s)
            except QueueFull:
                # cannot happen in routed operation (a dispatch is at
                # most one batch) unless the operator mis-sized
                # max_queue; requeue rather than lose the request
                self._queue.append(p)
        rep.dispatches += 1
        self._inc(obsm.ROUTER_DISPATCHES, replica=str(rep.idx))
        try:
            results = rep.engine.run(
                max_batches=1,
                max_restarts_per_batch=max_restarts_per_batch)
        except ReplicaDeath as e:
            rep.free_s = rep.clock.now
            self.stats["replica_deaths"] += 1
            self._set_state(rep, "dead", f"replica_death:{e}")
            self._instant("router.replica_dead", replica=rep.idx,
                          step=getattr(e, "step", None), fault=str(e),
                          lost=[p.request.request_id for p in batch],
                          now_s=self.now)
            self._inc(obsm.ROUTER_REPLICA_DEATHS)
            self._heartbeat(rep, None)
            self._requeue_lost(rep, batch, why="replica_death")
            return
        except (DeviceFailure, ServingFault) as e:
            # the engine burned its whole restart budget: the replica
            # is alive but not serving — degrade it, drain it past the
            # failure threshold, and send the batch elsewhere
            rep.free_s = rep.clock.now
            rep.failures += 1
            if rep.failures >= self.dead_after_failures:
                self._set_state(rep, "draining",
                                f"terminal_faults:{rep.failures}")
            else:
                self._set_state(rep, "degraded", f"terminal_fault:{e}")
            self._heartbeat(rep, None)
            self._requeue_lost(rep, batch, why="engine_fault")
            return
        rep.free_s = rep.clock.now
        rep.failures = 0
        wall = results[0].batch_wall_s if results else None
        self._heartbeat(rep, wall)
        if results and results[0].restarts > 0:
            self._set_state(rep, "degraded",
                            f"restarts:{results[0].restarts}")
        elif rep.state == "degraded":
            self._set_state(rep, "healthy", "recovered")
            self.health.mark_recovered(rep.idx)
        self.stats["completed"] += len(results)
        self.results.extend(results)
        self._gauge(obsm.ROUTER_QUEUE_DEPTH, len(self._queue))

    # ------------------------------------------------------------- serve
    def serve(
        self,
        workload: Sequence[Arrival],
        make_context: Optional[Callable[[Arrival], object]] = None,
        max_restarts_per_batch: int = 2,
    ) -> List[VideoResult]:
        """Open-loop replay of ``workload`` across the fleet: the
        N-replica generalization of ``loadgen.run_workload``.  Returns
        the completed :class:`VideoResult` s (shed / terminally failed
        requests have trace rows instead — every admitted request is
        accounted for)."""
        if make_context is None:
            make_context = _default_make_context(self.replicas[0].engine)
        pending = sorted(workload,
                         key=lambda a: (a.arrival_s, a.request_id))
        i = 0
        while True:
            # admit everything that has arrived by now
            while i < len(pending) and \
                    pending[i].arrival_s <= self.now:
                a = pending[i]
                self.submit(VideoRequest(
                    request_id=a.request_id,
                    context=make_context(a),
                    latent_shape=tuple(a.cls.latent_shape),
                    seed=a.seed,
                    guidance=a.cls.guidance,
                    priority=a.cls.priority,
                    psnr_floor=a.cls.psnr_floor,
                ), submit_s=a.arrival_s)
                i += 1
            self._shed_overflow()
            self._check_degradation()
            if not self.live_replicas():
                # total fleet loss: every queued and future request
                # fails terminally, loudly
                while i < len(pending):
                    a = pending[i]
                    self.submit(VideoRequest(
                        request_id=a.request_id,
                        context=make_context(a),
                        latent_shape=tuple(a.cls.latent_shape),
                        seed=a.seed, guidance=a.cls.guidance,
                        priority=a.cls.priority,
                        psnr_floor=a.cls.psnr_floor,
                    ), submit_s=a.arrival_s)
                    i += 1
                for p in list(self._queue):
                    self._fail_terminal(p, reason="no_live_replicas")
                self._queue = []
                break
            rep = self._pick_replica()
            if rep is not None:
                batch = self._pick_batch(rep)
                if batch:
                    self._dispatch(
                        rep, batch,
                        max_restarts_per_batch=max_restarts_per_batch)
                    continue
            if i >= len(pending) and not self._queue:
                break
            # nothing dispatchable at now: advance virtual time to the
            # next event (arrival, replica coming free, backoff expiry)
            nxt: List[float] = []
            if i < len(pending):
                nxt.append(pending[i].arrival_s)
            if self._queue:
                frees = [r.free_s for r in self.live_replicas()
                         if r.free_s > self.now]
                if frees:
                    nxt.append(min(frees))
                gates = [p.not_before_s for p in self._queue
                         if p.not_before_s > self.now]
                if gates:
                    nxt.append(min(gates))
            nxt = [t for t in nxt if t > self.now]
            if not nxt:
                if self._queue:
                    # queued work that can never dispatch (every live
                    # replica free, every gate open, yet no batch —
                    # cannot happen, but an infinite loop would be
                    # worse than a loud failure)
                    for p in list(self._queue):
                        self._fail_terminal(p, reason="stuck")
                    self._queue = []
                break
            self.now = min(nxt)
        # the queue has drained: the overload is over by definition, so
        # unwind any residual degradation before handing the fleet back
        while self.degrade_level > 0:
            self.degrade_level -= 1
            self._apply_floors()
            self._instant("router.restore", level=self.degrade_level,
                          queue_depth=len(self._queue), now_s=self.now)
            self._inc(obsm.ROUTER_RESTORE_STEPS)
        return self.results
