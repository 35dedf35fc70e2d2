"""SLO specs + request-lifecycle evaluator for the serving load harness.
A copy of ``repro/obs/slo.py`` (numpy only); the serving engine's
``slo=`` takes its :class:`SLOSpec`.

An :class:`SLOSpec` maps **priority classes** to deadlines: the
``--slo`` grammar is comma-separated ``priority:deadline_s[@target]``
entries, e.g. ``"interactive:2.0@0.999,standard:8,batch:30@0.9"`` —
``deadline_s`` is the end-to-end (submit -> done) latency bound and
``target`` the fraction of the class's requests that must meet it
(default 0.99).

:func:`evaluate_slo` turns per-request lifecycle rows (the stamps the
serving engine records — see ``LPServingEngine`` and
``FlightRecorder.record_request``) into a per-class report: request
count, queue-wait and e2e p50/p99, deadline violations + violation
rate, goodput (requests meeting their deadline per second, absolute
and per device), and SLO **burn rate** (violation rate over the error
budget ``1 - target``; burn > 1 means the budget is being spent faster
than the SLO allows).

The evaluator is deliberately *source-agnostic*: rows can come

* **live** from a :class:`~repro_torch.obs.FlightRecorder`
  (``recorder.request_rows``),
* **offline** from a ``--trace-out`` artifact
  (:func:`rows_from_trace` extracts the ``request.lifecycle`` events),

and because violations/quantiles are always recomputed from the raw
stamps (never trusted from the producer), the offline report is
guaranteed to equal the live one for the same serve —
``benchmarks/serving_load.py`` gates that equality.  A coarser
aggregate-only report can also be rebuilt from a ``--metrics-out``
JSONL snapshot (:func:`report_from_metrics_jsonl`): per-class
quantiles survive, per-request recomputation does not.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from . import metrics as M

SLO_REPORT_SCHEMA = "repro-slo-report-v1"

#: Priority vocabulary the load harness ships by default.  The spec
#: grammar accepts any identifier — these are just the documented
#: classes the request-mix generator and docs use.
PRIORITY_CLASSES = ("interactive", "standard", "batch")

DEFAULT_SLO_SPEC = "interactive:30@0.99,standard:120@0.95,batch:600@0.9"


@dataclasses.dataclass(frozen=True)
class SLOClass:
    priority: str
    deadline_s: float
    target: float = 0.99          # fraction that must meet the deadline

    def __post_init__(self):
        if self.deadline_s <= 0:
            raise ValueError(
                f"SLO class {self.priority!r}: deadline must be > 0, "
                f"got {self.deadline_s}")
        if not 0.0 < self.target <= 1.0:
            raise ValueError(
                f"SLO class {self.priority!r}: target must be in (0, 1], "
                f"got {self.target}")

    @property
    def entry(self) -> str:
        tgt = f"@{self.target:g}" if self.target != 0.99 else ""
        return f"{self.priority}:{self.deadline_s:g}{tgt}"


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    classes: Dict[str, SLOClass]

    @classmethod
    def parse(cls, spec: "SLOSpec | str | None") -> "SLOSpec":
        """``"interactive:2.0@0.999,standard:8"`` -> :class:`SLOSpec`.

        ``None``/empty parses to :data:`DEFAULT_SLO_SPEC`.
        """
        if isinstance(spec, SLOSpec):
            return spec
        if spec is None or not str(spec).strip():
            spec = DEFAULT_SLO_SPEC
        classes: Dict[str, SLOClass] = {}
        for entry in str(spec).split(","):
            entry = entry.strip()
            if not entry:
                continue
            head, sep, tgt = entry.partition("@")
            name, colon, deadline = head.partition(":")
            name = name.strip()
            if not name or not colon or not deadline.strip():
                raise ValueError(
                    f"bad SLO entry {entry!r}: want "
                    "'priority:deadline_s[@target]'")
            if name in classes:
                raise ValueError(f"duplicate SLO class {name!r}")
            try:
                deadline_s = float(deadline)
                target = float(tgt) if sep else 0.99
            except ValueError as e:
                raise ValueError(f"bad SLO entry {entry!r}: {e}") from None
            classes[name] = SLOClass(name, deadline_s, target)
        if not classes:
            raise ValueError(f"SLO spec {spec!r} has no classes")
        return cls(classes)

    @property
    def spec(self) -> str:
        """Canonical round-trippable string form."""
        return ",".join(c.entry for c in self.classes.values())

    def get(self, priority: str) -> Optional[SLOClass]:
        return self.classes.get(priority)

    def deadline_for(self, priority: str) -> float:
        """Deadline for ``priority``; +inf when the class is unspeced
        (an unspeced class can never violate — it is still reported)."""
        c = self.classes.get(priority)
        return c.deadline_s if c is not None else math.inf


# ---------------------------------------------------------------- rows
def rows_from_trace(doc: dict) -> List[dict]:
    """Extract per-request lifecycle rows from an exported trace.

    The inverse of ``FlightRecorder.record_request``: every
    ``request.lifecycle`` complete event carries the full row in its
    ``args``, so an offline evaluation sees byte-identical inputs to
    the live one.
    """
    rows = []
    for ev in doc.get("traceEvents", []):
        if ev.get("name") == "request.lifecycle" and "args" in ev:
            rows.append(dict(ev["args"]))
    return rows


def shed_from_trace(doc: dict) -> List[dict]:
    """Extract ``request.shed`` rows from an exported trace — the
    inverse of ``FlightRecorder.record_shed``.  One row per request the
    router's admission control dropped; together with the lifecycle and
    terminal-failure rows these account for EVERY admitted request (the
    zero-lost-requests gate in ``benchmarks/router_resilience.py``)."""
    rows = []
    for ev in doc.get("traceEvents", []):
        if ev.get("name") == "request.shed" and "args" in ev:
            rows.append(dict(ev["args"]))
    return rows


def failures_from_trace(doc: dict, terminal_only: bool = True) -> List[dict]:
    """Extract ``request.failed`` rows from an exported trace.

    Two producers share the event name: the ENGINE emits one when a
    batch exhausts its restart budget (under a router that request may
    still be redispatched and complete elsewhere), and the ROUTER emits
    one with ``terminal=True`` when the redispatch budget is exhausted.
    ``terminal_only`` (the default) keeps only the router's terminal
    rows — the mirror of ``FlightRecorder.record_failed`` and the set
    disposition accounting needs."""
    rows = []
    for ev in doc.get("traceEvents", []):
        if ev.get("name") == "request.failed" and "args" in ev:
            args = dict(ev["args"])
            if terminal_only and not args.get("terminal"):
                continue
            rows.append(args)
    return rows


def disposition(completed_rows: Iterable[dict],
                shed_rows: Iterable[dict],
                failed_rows: Iterable[dict]) -> Dict[str, object]:
    """Account for every request's final disposition by ``request_id``.

    Precedence is ``completed > shed > failed``: a redispatched request
    may have left a non-terminal failure trail (or been shed from one
    replica's queue and re-admitted) before completing, and completion
    always wins.  Returns the per-outcome id sets plus counts; the
    zero-lost gate checks ``completed | shed | failed == admitted``."""
    completed = {int(r["request_id"]) for r in completed_rows}
    shed = {int(r["request_id"]) for r in shed_rows} - completed
    failed = ({int(r["request_id"]) for r in failed_rows}
              - completed - shed)
    return {
        "completed_ids": completed, "shed_ids": shed,
        "failed_ids": failed,
        "completed": len(completed), "shed": len(shed),
        "failed": len(failed),
        "accounted": len(completed) + len(shed) + len(failed),
    }


def _pct(vals: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals, dtype=np.float64), q))


# ----------------------------------------------------------- evaluator
def evaluate_slo(
    rows: Iterable[dict],
    spec: "SLOSpec | str | None" = None,
    num_devices: int = 1,
    recorder=None,
    shed_rows: Optional[Iterable[dict]] = None,
    failed_rows: Optional[Iterable[dict]] = None,
) -> dict:
    """Per-class SLO report from request-lifecycle rows.

    Violations and quantiles are recomputed here from the raw stamps
    (``submit_s`` / ``admit_s`` / ``done_s``), never read from the
    producer — the property that makes the offline (trace-replayed)
    report equal the live one.  Goodput counts only requests that met
    their class deadline, over the workload makespan
    (first submit -> last done); ``num_devices`` scales it to
    goodput-per-device.  When a ``recorder`` is passed, the canonical
    ``serve.goodput_rps`` gauges are published per class and in total.

    Router extensions (all additive — the report for a routerless
    serve is byte-identical to before): ``shed_rows`` /
    ``failed_rows`` (``FlightRecorder.shed_rows`` / ``failed_rows``
    live, :func:`shed_from_trace` / :func:`failures_from_trace`
    offline) add per-class ``shed`` / ``failed`` counts and a
    disposition block; lifecycle rows carrying a ``replica`` field add
    a per-replica section (count / violations / goodput on the shared
    makespan).
    """
    spec = SLOSpec.parse(spec)
    rows = list(rows)
    by_class: Dict[str, List[dict]] = {}
    for row in rows:
        by_class.setdefault(str(row.get("priority", "standard")),
                            []).append(row)

    report: dict = {
        "schema": SLO_REPORT_SCHEMA,
        "spec": spec.spec,
        "num_devices": int(num_devices),
        "requests": len(rows),
        "classes": {},
    }
    shed = None if shed_rows is None else list(shed_rows)
    failed = None if failed_rows is None else list(failed_rows)
    if shed is not None or failed is not None:
        disp = disposition(rows, shed or [], failed or [])
        report["disposition"] = {
            "completed": disp["completed"], "shed": disp["shed"],
            "failed": disp["failed"], "accounted": disp["accounted"],
        }
        if shed is not None:
            by_p: Dict[str, int] = {}
            for r in shed:
                p = str(r.get("priority", "standard"))
                by_p[p] = by_p.get(p, 0) + 1
            report["shed"] = {"total": len(shed),
                              "by_priority": dict(sorted(by_p.items()))}
        if failed is not None:
            by_p = {}
            for r in failed:
                p = str(r.get("priority", "standard"))
                by_p[p] = by_p.get(p, 0) + 1
            report["failed"] = {"total": len(failed),
                                "by_priority": dict(sorted(by_p.items()))}
    if not rows:
        report.update(makespan_s=0.0, goodput_rps=0.0,
                      goodput_per_device_rps=0.0, violations=0)
        return report

    t0 = min(float(r["submit_s"]) for r in rows)
    t1 = max(float(r["done_s"]) for r in rows)
    makespan = max(t1 - t0, 1e-12)
    total_good = 0
    total_violations = 0
    for priority in sorted(by_class):
        crows = by_class[priority]
        waits = [float(r["admit_s"]) - float(r["submit_s"]) for r in crows]
        e2es = [float(r["done_s"]) - float(r["submit_s"]) for r in crows]
        deadline = spec.deadline_for(priority)
        sclass = spec.get(priority)
        violations = sum(1 for e in e2es if e > deadline)
        good = len(crows) - violations
        total_good += good
        total_violations += violations
        violation_rate = violations / len(crows)
        entry = {
            "count": len(crows),
            "queue_wait_p50_s": _pct(waits, 50),
            "queue_wait_p99_s": _pct(waits, 99),
            "e2e_p50_s": _pct(e2es, 50),
            "e2e_p99_s": _pct(e2es, 99),
            "deadline_s": deadline if math.isfinite(deadline) else None,
            "target": sclass.target if sclass is not None else None,
            "violations": violations,
            "violation_rate": violation_rate,
            "goodput_rps": good / makespan,
            "goodput_per_device_rps": good / makespan / num_devices,
        }
        # burn rate: violation rate over the error budget (1 - target).
        # > 1.0 means the budget burns faster than the SLO allows; a
        # target of exactly 1.0 has no budget, so any violation is an
        # infinite burn (reported as null/None when clean).
        if sclass is None:
            entry["burn_rate"] = None
        elif sclass.target >= 1.0:
            entry["burn_rate"] = math.inf if violations else 0.0
        else:
            entry["burn_rate"] = violation_rate / (1.0 - sclass.target)
        report["classes"][priority] = entry

    report["makespan_s"] = makespan
    report["violations"] = total_violations
    report["goodput_rps"] = total_good / makespan
    report["goodput_per_device_rps"] = total_good / makespan / num_devices
    # per-replica section: only when rows carry a fleet identity (the
    # replica router stamps ``replica`` into every lifecycle row), so a
    # single-engine serve keeps the exact historical report schema
    if any(r.get("replica") is not None for r in rows):
        by_replica: Dict[str, List[dict]] = {}
        for row in rows:
            rid = row.get("replica")
            by_replica.setdefault(
                "unrouted" if rid is None else str(rid), []).append(row)
        replicas: Dict[str, dict] = {}
        for rid in sorted(by_replica):
            rrows = by_replica[rid]
            e2es = [float(r["done_s"]) - float(r["submit_s"])
                    for r in rrows]
            viol = sum(
                1 for r, e in zip(rrows, e2es)
                if e > spec.deadline_for(
                    str(r.get("priority", "standard"))))
            good = len(rrows) - viol
            replicas[rid] = {
                "count": len(rrows),
                "e2e_p50_s": _pct(e2es, 50),
                "e2e_p99_s": _pct(e2es, 99),
                "violations": viol,
                "goodput_rps": good / makespan,
            }
        report["replicas"] = replicas
    if recorder is not None:
        recorder.gauge(M.GOODPUT_RPS, report["goodput_rps"],
                       priority="_total")
        for priority, entry in report["classes"].items():
            recorder.gauge(M.GOODPUT_RPS, entry["goodput_rps"],
                           priority=priority)
    return report


def report_from_metrics_jsonl(text: str,
                              spec: "SLOSpec | str | None" = None) -> dict:
    """Aggregate-only report from a ``--metrics-out`` JSONL snapshot.

    The snapshot holds per-class histogram aggregates (not raw rows),
    so this rebuilds per-class p50/p99 and the live-counted
    ``serve.slo_violations`` — it cannot recompute violations or
    goodput from stamps.  Use the trace artifact
    (:func:`rows_from_trace` + :func:`evaluate_slo`) for the exact
    report; this one is for fleets that only ship metrics.
    """
    spec = SLOSpec.parse(spec)
    classes: Dict[str, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        row = json.loads(line)
        priority = row.get("labels", {}).get("priority")
        if priority is None:
            continue
        entry = classes.setdefault(priority, {})
        if row["name"] == M.E2E_LATENCY_S:
            entry.update(count=row["count"], e2e_p50_s=row["p50"],
                         e2e_p99_s=row["p99"],
                         e2e_samples_dropped=row.get("dropped", 0))
        elif row["name"] == M.QUEUE_WAIT_S:
            entry.update(queue_wait_p50_s=row["p50"],
                         queue_wait_p99_s=row["p99"])
        elif row["name"] == M.SLO_VIOLATIONS:
            entry["violations"] = row["value"]
    for priority, entry in classes.items():
        deadline = spec.deadline_for(priority)
        entry["deadline_s"] = deadline if math.isfinite(deadline) else None
        entry.setdefault("violations", 0)
    return {
        "schema": SLO_REPORT_SCHEMA,
        "source": "metrics",
        "spec": spec.spec,
        "classes": classes,
    }


def format_report(report: dict) -> str:
    """Human-readable per-class table for CLI output."""
    lines = [f"SLO report ({report.get('requests', '?')} requests, "
             f"spec={report['spec']})"]
    for priority, e in sorted(report.get("classes", {}).items()):
        deadline = e.get("deadline_s")
        dl = f"{deadline:g}s" if deadline is not None else "-"
        burn = e.get("burn_rate")
        burn_s = ("inf" if burn == math.inf else
                  f"{burn:.2f}" if burn is not None else "-")
        lines.append(
            f"  {priority:<12} n={e.get('count', '?'):<4} "
            f"wait p50/p99={e.get('queue_wait_p50_s', float('nan')):.3f}/"
            f"{e.get('queue_wait_p99_s', float('nan')):.3f}s "
            f"e2e p50/p99={e.get('e2e_p50_s', float('nan')):.3f}/"
            f"{e.get('e2e_p99_s', float('nan')):.3f}s "
            f"deadline={dl} viol={e.get('violations', 0)} "
            f"burn={burn_s}"
            + (f" goodput={e['goodput_rps']:.3f}rps"
               if "goodput_rps" in e else ""))
    for rid, e in sorted(report.get("replicas", {}).items()):
        lines.append(
            f"  replica {rid:<4} n={e['count']:<4} "
            f"e2e p50/p99={e['e2e_p50_s']:.3f}/{e['e2e_p99_s']:.3f}s "
            f"viol={e['violations']} "
            f"goodput={e['goodput_rps']:.3f}rps")
    if "disposition" in report:
        d = report["disposition"]
        lines.append(
            f"  disposition: completed={d['completed']} "
            f"shed={d['shed']} failed={d['failed']} "
            f"(accounted={d['accounted']})")
    if "goodput_rps" in report:
        lines.append(
            f"  total: goodput={report['goodput_rps']:.3f}rps "
            f"({report['goodput_per_device_rps']:.3f}/device over "
            f"{report['num_devices']} devices), "
            f"makespan={report['makespan_s']:.2f}s, "
            f"violations={report['violations']}")
    return "\n".join(lines)
