"""Flight recorder + metrics plane for the LP serving path.  A port of
``repro/obs/__init__.py``.

One object — :class:`FlightRecorder` — carries the whole observability
surface: Chrome-trace spans (:mod:`.trace`), a metrics registry
(:mod:`.metrics`), and derived per-step wire accounting
(:mod:`.account`).  Every feeder (serving engine, runtime health,
policy autotuner, launch CLIs) takes an *optional* recorder and calls
through the no-op-safe helpers here, so the instrumented and bare code
paths are the same code path.

Invariant: the recorder is host state only.  It never enters
``LPStepCompiler``'s cache key, so it cannot add a step-cache miss.  On a
group each rank holds its own recorder; its ``wire_steps`` are that
rank's payloads, which equal its byte counter's
(``distributed/collectives.WireCounter``) per step and tier.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional, Sequence

from . import metrics as M
from .account import (
    attribute_denoise_steps,
    reconcile_segments,
    step_wire_attribution,
    tier_for_group_size,
    tiered_collectives,
)
from .clock import perf_s, perf_us, wall_stamp_s
from .metrics import MetricsRegistry
from .slo import (
    SLO_REPORT_SCHEMA,
    SLOClass,
    SLOSpec,
    disposition,
    evaluate_slo,
    failures_from_trace,
    report_from_metrics_jsonl,
    rows_from_trace,
    shed_from_trace,
)
from .trace import TRACE_SCHEMA, TraceRecorder, validate_trace

__all__ = [
    "FlightRecorder", "MetricsRegistry", "TraceRecorder",
    "TRACE_SCHEMA", "validate_trace", "attribute_denoise_steps",
    "step_wire_attribution", "tiered_collectives",
    "tier_for_group_size", "reconcile_segments",
    "perf_s", "perf_us", "wall_stamp_s",
    "SLOSpec", "SLOClass", "SLO_REPORT_SCHEMA", "evaluate_slo",
    "rows_from_trace", "report_from_metrics_jsonl",
    "shed_from_trace", "failures_from_trace", "disposition",
]


class FlightRecorder:
    """Bundles a trace recorder + metrics registry behind safe helpers.

    Construct with ``trace=False`` or ``metrics=False`` to disable one
    plane; all helpers no-op cleanly on the disabled plane, so feeders
    never branch.
    """

    def __init__(self, trace: bool = True, metrics: bool = True,
                 links=None) -> None:
        self.trace: Optional[TraceRecorder] = (
            TraceRecorder() if trace else None)
        self.metrics: Optional[MetricsRegistry] = (
            MetricsRegistry() if metrics else None)
        if links is None:
            # the autotuner's two-tier defaults, so per-step predicted
            # wire time is priced without configuration (lazy import:
            # policy sits above obs in the layering)
            from repro_torch.policy.autotune import DEFAULT_LINKS
            links = DEFAULT_LINKS
        self.links = links  # policy.autotune.LinkModel for pricing
        self.wire_steps: List[dict] = []    # per-step attribution rows
        self.plans: List[dict] = []         # resolved plan records
        self.measured_runs: List[dict] = []  # run-span wall times
        self.reconciliations: List[dict] = []  # predicted vs measured
        self.request_rows: List[dict] = []  # per-request lifecycle rows
        self.shed_rows: List[dict] = []     # admission-control sheds
        self.failed_rows: List[dict] = []   # terminal request failures

    # -- trace helpers (no-op when trace plane disabled) ---------------
    def span(self, name: str, cat: str = "serve", **args: Any):
        if self.trace is None:
            return nullcontext()
        return self.trace.span(name, cat=cat, **args)

    def device_span(self, name: str, cat: str = "denoise", **args: Any):
        if self.trace is None:
            return nullcontext()
        return self.trace.device_span(name, cat=cat, **args)

    def instant(self, name: str, cat: str = "serve", **args: Any) -> None:
        if self.trace is not None:
            self.trace.instant(name, cat=cat, **args)

    def counter_sample(self, name: str, values: Dict[str, float],
                       cat: str = "serve") -> None:
        if self.trace is not None:
            self.trace.counter(name, values, cat=cat)

    # -- metrics helpers (no-op when metrics plane disabled) -----------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, value, **labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        if self.metrics is not None:
            self.metrics.set(name, value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        if self.metrics is not None:
            self.metrics.observe(name, value, **labels)

    # -- composite feeders ---------------------------------------------
    def record_run(self, start: int, stop: int, wall_s: float,
                   dim: Optional[int] = None, codec: Optional[str] = None,
                   epoch: int = 0) -> None:
        """One run of same-dim, same-codec steps (or a single step).

        The span itself is emitted by ``lp_denoise``'s ``device_span``;
        this records the measured wall for segment reconciliation and
        feeds the run/step latency histograms.  The per-step sample is
        the run wall divided evenly, as in the reference, whose fused
        runs hide their steps.
        """
        n = max(1, int(stop) - int(start) + 1)
        self.measured_runs.append({
            "start": int(start), "stop": int(stop),
            "wall_s": float(wall_s), "dim": dim, "codec": codec,
            "epoch": int(epoch),
        })
        self.observe(M.RUN_WALL_S, wall_s)
        for _ in range(n):
            self.observe(M.STEP_LATENCY_S, wall_s / n)

    def record_snapshot(self, step: int) -> None:
        self.instant("snapshot.record", cat="serve", step=int(step))
        self.inc(M.SNAPSHOT_RECORDS)

    def record_resume(self, from_step: int) -> None:
        self.instant("snapshot.resume", cat="serve",
                     from_step=int(from_step))
        self.inc(M.SNAPSHOT_RESUMES)

    def record_replan(self, step: int, K: int, epoch: int) -> None:
        self.instant("plan.replan", cat="elastic", step=int(step),
                     K=int(K), epoch=int(epoch))

    def record_request(self, row: dict) -> None:
        """One completed request's lifecycle row (serving engine).

        The row carries the full stamp set (``submit_s`` / ``admit_s``
        / ``denoise_start_s`` / ``done_s`` on the engine's clock — the
        workload's *virtual* timeline under the load harness) plus
        ``priority``, batch identity, and the derived
        ``queue_wait_s`` / ``e2e_s``.  It is emitted verbatim as a
        ``request.lifecycle`` complete event so an offline evaluation
        (``obs.slo.rows_from_trace``) sees byte-identical inputs to
        the live one, and feeds the per-priority latency histograms.
        """
        self.request_rows.append(row)
        if self.trace is not None:
            self.trace.complete(
                "request.lifecycle",
                ts_us=float(row["submit_s"]) * 1e6,
                dur_us=(float(row["done_s"]) - float(row["submit_s"]))
                * 1e6,
                cat="serve", **row)
        priority = str(row.get("priority", "standard"))
        labels = {"priority": priority}
        if row.get("replica") is not None:
            labels["replica"] = str(row["replica"])
        self.observe(M.QUEUE_WAIT_S, row["queue_wait_s"], **labels)
        self.observe(M.E2E_LATENCY_S, row["e2e_s"], **labels)
        if row.get("violated"):
            self.inc(M.SLO_VIOLATIONS, **labels)

    def record_shed(self, row: dict) -> None:
        """One request shed by admission control (the replica router's
        load-shedding path — never the engine, which REJECTS at submit
        instead).  ``row`` carries ``request_id`` / ``priority`` /
        ``submit_s`` / ``shed_s`` / ``reason`` (+ queue depths); it is
        emitted verbatim as a ``request.shed`` instant so the offline
        SLO evaluation can reconstruct the disposition of every
        admitted request (the zero-lost-requests gate), and counts
        ``router.shed`` per priority."""
        self.shed_rows.append(row)
        self.instant("request.shed", cat="serve", **row)
        self.inc(M.ROUTER_SHED,
                 priority=str(row.get("priority", "standard")))

    def record_failed(self, row: dict) -> None:
        """One TERMINAL request failure (redispatch budget exhausted,
        or no live replica left).  Engine-level ``request.failed``
        instants are not terminal under a router — the router may still
        redispatch — so the router records its own row here with
        ``terminal=True``; offline disposition accounting keys on that
        flag.  Emitted verbatim as a ``request.failed`` instant and
        counted as ``router.failed`` per priority."""
        self.failed_rows.append(row)
        self.instant("request.failed", cat="serve", **row)
        self.inc(M.ROUTER_FAILED,
                 priority=str(row.get("priority", "standard")))

    def record_wire_steps(self, records: Sequence[dict]) -> None:
        """Attribution rows -> trace instants + tiered byte counters.

        ``hidden_bytes`` (the displaced-halo portion of ``inter_bytes``
        that overlaps compute, see ``account.attribute_denoise_steps``)
        rides the same instants and the by-tier counter — it is an
        attribution OF inter bytes, not an extra tier, so the collective
        byte counters (which gate HLO-exactness) are unchanged.
        """
        self.wire_steps.extend(records)
        for rec in records:
            self.instant("wire.step", cat="wire", **{
                k: rec[k] for k in
                ("step", "dim", "codec", "K", "inter_bytes", "intra_bytes",
                 "hidden_bytes") if k in rec
            })
            for tier in ("inter", "intra"):
                for coll, nbytes in rec.get(tier, {}).items():
                    self.inc(M.WIRE_BYTES, nbytes, tier=tier,
                             collective=coll)
        if records and self.trace is not None:
            tot_inter = sum(r["inter_bytes"] for r in records)
            tot_intra = sum(r["intra_bytes"] for r in records)
            tot_hidden = sum(r.get("hidden_bytes", 0.0) for r in records)
            self.counter_sample("wire.bytes_by_tier",
                                {"inter": tot_inter, "intra": tot_intra,
                                 "hidden": tot_hidden},
                                cat="wire")

    def record_reconciliations(self, rows: Sequence[dict]) -> None:
        """Predicted-vs-measured rows (``account.reconcile_segments``)
        -> ``wire.reconcile`` instants.  ``unattributed_steps`` travels
        with each row so ``validate_trace`` can fail a trace whose
        reconciliation silently skipped steps."""
        self.reconciliations.extend(rows)
        for row in rows:
            self.instant("wire.reconcile", cat="wire", **row)

    def record_plan(self, plan, candidates: Optional[Sequence[dict]] = None,
                    context: str = "serve") -> None:
        """A resolved ``StepPolicyPlan`` + the autotuner's ranked field."""
        row = {
            "context": context,
            "lp_impl": plan.lp_impl,
            "schedule": plan.schedule.spec,
            "wire_shard": bool(plan.wire_shard),
            "num_segments": plan.num_segments,
            "wire_bytes": float(plan.wire_bytes),
            "inter_bytes": float(plan.inter_bytes),
            "intra_bytes": float(plan.intra_bytes),
            "wire_time_ms": float(plan.wire_time_ms),
            "hidden_bytes": float(getattr(plan, "hidden_bytes", 0)),
        }
        if candidates is not None:
            row["candidates"] = list(candidates)
        self.plans.append(row)
        self.instant("policy.plan", cat="policy", **row)
        self.gauge(M.PLAN_WIRE_BYTES, plan.wire_bytes, context=context)
        self.gauge(M.PLAN_WIRE_TIME_MS, plan.wire_time_ms, context=context)
        self.gauge(M.PLAN_SEGMENTS, plan.num_segments, context=context)

    # -- export ---------------------------------------------------------
    def write_trace(self, path: str) -> None:
        if self.trace is not None:
            self.trace.write(path)

    def write_metrics(self, path: str) -> None:
        if self.metrics is not None:
            self.metrics.write(path)
