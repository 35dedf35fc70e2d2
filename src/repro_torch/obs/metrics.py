"""Metrics registry: counters, gauges, histograms + snapshot exporters.

Names are dotted (``serve.queue_depth``); labels are sorted key=value
pairs so a (name, labels) series is stable across runs — the property
the trace-schema tests pin.  Export formats:

* **Prometheus text** (``.prom``/``.txt``): standard exposition format,
  dots mapped to underscores, histograms exported as ``_count`` /
  ``_sum`` plus p50/p99 ``{quantile=...}`` rows (summary-style);
  reservoir truncation is a separate ``<name>_dropped`` counter
  family (``_dropped`` is not a valid summary child series).
* **JSONL** (anything else): one JSON object per series, machine-
  diffable against ``comm_model`` outputs.

Histograms keep a bounded **reservoir** of samples (Algorithm R, a
deterministic per-registry PRNG): once a series passes ``hist_cap``,
each new sample replaces a uniformly random held one, so p50/p99 stay
unbiased estimates of the WHOLE stream instead of freezing on the
first ``hist_cap`` (warm-up) observations.  ``count`` / ``sum`` stay
exact running totals, and every snapshot row exports ``dropped`` (how
many observations exceed the held sample count) so truncation is
always visible.

Recording is a dict update — no locks, no I/O until snapshot time, and
never part of a step-cache key.  A copy of ``repro/obs/metrics.py``
(numpy and ``random`` only); ``tests/test_torch_obs.py`` holds its
snapshots, exporters and reservoir samples to the reference's.
"""
from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .clock import wall_stamp_s

LabelKey = Tuple[Tuple[str, str], ...]

# Canonical metric names (docs/observability.md) — feeders use these
# constants so the schema cannot fork silently.
QUEUE_DEPTH = "serve.queue_depth"
BATCH_SIZE = "serve.batch_size"
REQUESTS = "serve.requests"
BATCHES = "serve.batches"
RESTARTS = "serve.restarts"
EVICTIONS = "serve.evictions"
BATCH_WALL_S = "serve.batch_wall_s"
STEP_LATENCY_S = "denoise.step_s"
RUN_WALL_S = "denoise.run_s"
COMPILES = "compiler.compiles"
WIRE_BYTES = "wire.bytes"
HEARTBEAT_MISSES = "health.heartbeat_misses"
DEAD_GROUPS = "health.dead_groups"
STRAGGLER_IMBALANCE = "straggler.imbalance"
FAULTS_INJECTED = "faults.injected"
SNAPSHOT_RESUMES = "snapshot.resumes"
SNAPSHOT_RECORDS = "snapshot.records"
PLAN_WIRE_BYTES = "policy.plan_wire_bytes"
PLAN_WIRE_TIME_MS = "policy.plan_wire_time_ms"
PLAN_SEGMENTS = "policy.plan_segments"
# request-lifecycle / SLO names (docs/observability.md, obs/slo.py)
QUEUE_WAIT_S = "serve.queue_wait_s"
E2E_LATENCY_S = "serve.e2e_latency_s"
BATCH_OCCUPANCY = "serve.batch_occupancy"
GOODPUT_RPS = "serve.goodput_rps"
SLO_VIOLATIONS = "serve.slo_violations"
# explicit backpressure: submit() rejected a request at the max_queue
# bound (serving/engine.QueueFull) — counted where it happened
REQUESTS_REJECTED = "serve.requests_rejected"
# replica-router family (serving/router.py, docs/observability.md) —
# fleet-level series; per-replica engine series reuse the serve.*
# names above with a {replica="<id>"} label
ROUTER_DISPATCHES = "router.dispatches"
ROUTER_SHED = "router.shed"
ROUTER_REDISPATCHES = "router.redispatches"
ROUTER_FAILED = "router.failed"
ROUTER_DEGRADE_STEPS = "router.degrade_steps"
ROUTER_RESTORE_STEPS = "router.restore_steps"
ROUTER_REPLICA_DEATHS = "router.replica_deaths"
ROUTER_QUEUE_DEPTH = "router.queue_depth"
ROUTER_HEALTHY_REPLICAS = "router.healthy_replicas"


def _labels(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Reservoir:
    """Bounded sample reservoir (Vitter's Algorithm R) with exact
    running ``seen`` / ``total``: quantiles come from a uniform sample
    of the whole stream, count/sum stay exact, and ``dropped`` exposes
    how many observations the reservoir is NOT holding."""

    __slots__ = ("vals", "seen", "total", "mn", "mx")

    def __init__(self) -> None:
        self.vals: List[float] = []
        self.seen = 0
        self.total = 0.0
        self.mn = float("inf")
        self.mx = float("-inf")

    def add(self, value: float, cap: int, rng: random.Random) -> None:
        self.seen += 1
        self.total += value
        self.mn = min(self.mn, value)
        self.mx = max(self.mx, value)
        if len(self.vals) < cap:
            self.vals.append(value)
            return
        j = rng.randrange(self.seen)
        if j < cap:
            self.vals[j] = value

    @property
    def dropped(self) -> int:
        return self.seen - len(self.vals)


class MetricsRegistry:
    """Counters/gauges/histograms keyed on (name, sorted labels)."""

    def __init__(self, hist_cap: int = 65536, seed: int = 0) -> None:
        self._counters: Dict[Tuple[str, LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, LabelKey], float] = {}
        self._hists: Dict[Tuple[str, LabelKey], _Reservoir] = {}
        self._hist_cap = hist_cap
        # one seeded PRNG for every reservoir: the same observation
        # sequence always yields the same held samples (replayable
        # snapshots under a fixed workload seed)
        self._rng = random.Random(seed)

    # -- recording ------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _labels(labels))
        self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set(self, name: str, value: float, **labels) -> None:
        self._gauges[(name, _labels(labels))] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        res = self._hists.setdefault((name, _labels(labels)), _Reservoir())
        res.add(float(value), self._hist_cap, self._rng)

    # -- reading --------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get((name, _labels(labels)), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get((name, _labels(labels)))

    def hist_values(self, name: str, **labels) -> List[float]:
        res = self._hists.get((name, _labels(labels)))
        return [] if res is None else list(res.vals)

    def hist_dropped(self, name: str, **labels) -> int:
        res = self._hists.get((name, _labels(labels)))
        return 0 if res is None else res.dropped

    @staticmethod
    def _quantiles(res: _Reservoir) -> Dict[str, float]:
        arr = np.asarray(res.vals, dtype=np.float64)
        return {
            "count": int(res.seen),          # exact stream length
            "sum": float(res.total),         # exact stream total
            "min": float(res.mn),            # exact stream extrema
            "max": float(res.mx),
            "p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)),
            "dropped": int(res.dropped),     # samples not held
        }

    def snapshot(self) -> List[dict]:
        """Flat series list — the JSONL rows, sorted for stable diffs."""
        rows: List[dict] = []
        for (name, lk), v in self._counters.items():
            rows.append({"name": name, "type": "counter",
                         "labels": dict(lk), "value": v})
        for (name, lk), v in self._gauges.items():
            rows.append({"name": name, "type": "gauge",
                         "labels": dict(lk), "value": v})
        for (name, lk), res in self._hists.items():
            if res.vals:
                rows.append({"name": name, "type": "histogram",
                             "labels": dict(lk),
                             **self._quantiles(res)})
        rows.sort(key=lambda r: (r["name"], sorted(r["labels"].items())))
        return rows

    # -- exporters ------------------------------------------------------
    def to_jsonl(self) -> str:
        stamp = wall_stamp_s()
        return "\n".join(
            json.dumps({**row, "stamp_s": stamp})
            for row in self.snapshot()
        ) + "\n"

    def to_prometheus(self) -> str:
        def pname(name: str) -> str:
            return "repro_" + name.replace(".", "_").replace("-", "_")

        def escape(v: str) -> str:
            # exposition-format label escaping: backslash, quote, newline
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
            parts = [f'{k}="{escape(v)}"' for k, v in sorted(labels.items())]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: List[str] = []
        typed: set = set()  # one TYPE line per metric name
        # reservoir truncation per histogram series: NOT a valid
        # summary child series, so it gets its own counter family —
        # collected here and emitted after the main pass so every
        # family's samples stay contiguous under one TYPE line
        dropped: Dict[str, List[str]] = {}

        def type_line(n: str, kind: str) -> None:
            if n not in typed:
                typed.add(n)
                lines.append(f"# TYPE {n} {kind}")

        for row in self.snapshot():
            n = pname(row["name"])
            if row["type"] == "counter":
                type_line(n, "counter")
                lines.append(f"{n}{fmt_labels(row['labels'])} "
                             f"{row['value']}")
            elif row["type"] == "gauge":
                type_line(n, "gauge")
                lines.append(f"{n}{fmt_labels(row['labels'])} "
                             f"{row['value']}")
            else:  # histogram -> summary-style quantile rows
                type_line(n, "summary")
                for q, field in (("0.5", "p50"), ("0.99", "p99")):
                    extra = 'quantile="%s"' % q
                    lines.append(
                        f"{n}{fmt_labels(row['labels'], extra)} "
                        f"{row[field]}")
                lines.append(f"{n}_sum{fmt_labels(row['labels'])} "
                             f"{row['sum']}")
                lines.append(f"{n}_count{fmt_labels(row['labels'])} "
                             f"{row['count']}")
                dropped.setdefault(f"{n}_dropped", []).append(
                    f"{n}_dropped{fmt_labels(row['labels'])} "
                    f"{row['dropped']}")
        for fam in sorted(dropped):
            lines.append(f"# TYPE {fam} counter")
            lines.extend(dropped[fam])
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        """Format by extension: .prom/.txt -> Prometheus text, else JSONL."""
        text = (self.to_prometheus()
                if path.endswith((".prom", ".txt")) else self.to_jsonl())
        with open(path, "w") as f:
            f.write(text)
