"""Chrome-trace / Perfetto flight recorder (host-side, monotonic).

Spans are recorded as complete ("X") events with microsecond ``ts`` /
``dur`` from :mod:`repro_torch.obs.clock`, point events as instants ("i"),
and numeric series as counters ("C") — the JSON schema Perfetto and
``chrome://tracing`` load directly (open https://ui.perfetto.dev and
drop the file in).  Recording is append-to-a-list cheap: no locks, no
I/O until :meth:`TraceRecorder.write`; the recorder is plain host state
and never enters a step-cache key.  A copy of ``repro/obs/trace.py``.

``device_span`` additionally enters ``torch.profiler.record_function``
(where the reference enters ``jax.profiler.TraceAnnotation``), so that
when a ``torch.profiler`` capture is running the host spans name a range
on its timeline, and with CUDA activities a GPU user annotation over the
kernels launched inside it.
"""
from __future__ import annotations

import json
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from .clock import perf_us

TRACE_SCHEMA = "repro-obs-trace-v1"

# Span/instant taxonomy (docs/observability.md) — categories group the
# Perfetto tracks: serve (request lifecycle), denoise (compiled step
# path), policy (plan resolution), elastic (replan/evict), fault
# (injected drills), wire (derived byte attribution), dryrun (lowering).
CATEGORIES = ("serve", "denoise", "policy", "elastic", "fault", "wire",
              "dryrun", "obs")


def _jsonable(v: Any) -> Any:
    """Recursive JSON-safe copy: numpy and torch scalars/arrays ->
    python, tuples -> lists, anything exotic -> repr."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.ndim == 0 else v.tolist()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()          # numpy scalar
    if hasattr(v, "tolist"):
        return v.tolist()        # numpy array
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    return repr(v)


def _clean(args: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _jsonable(v) for k, v in args.items()}


class TraceRecorder:
    """Accumulates Chrome-trace events; serialises on demand."""

    def __init__(self, pid: int = 1, tid: int = 1) -> None:
        self.events: List[dict] = []
        self.pid = pid
        self.tid = tid

    # -- primitives -----------------------------------------------------
    def begin_span(self, name: str, cat: str = "serve",
                   **args: Any) -> float:
        """Manual span open; pair with :meth:`end_span`."""
        return perf_us()

    def end_span(self, name: str, t0_us: float, cat: str = "serve",
                 **args: Any) -> None:
        t1 = perf_us()
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": t0_us, "dur": t1 - t0_us,
            "pid": self.pid, "tid": self.tid,
            "args": _clean(args),
        })

    @contextmanager
    def span(self, name: str, cat: str = "serve", **args: Any):
        t0 = perf_us()
        try:
            yield
        finally:
            self.end_span(name, t0, cat=cat, **args)

    @contextmanager
    def device_span(self, name: str, cat: str = "denoise", **args: Any):
        """Span that also annotates the device timeline.

        ``torch.profiler.record_function`` costs little when no profiler
        is running, and names a range of the capture when one is — so
        host spans and device kernels share a vocabulary.
        """
        t0 = perf_us()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.end_span(name, t0, cat=cat, **args)

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "serve", **args: Any) -> None:
        """Complete ("X") event with caller-supplied timestamps.

        Used for events whose clock domain is not ``perf_us`` — e.g.
        per-request lifecycle spans stamped on the serving engine's
        (possibly virtual) clock.  ``dur_us`` is clamped at 0 so a
        degenerate stamp pair can never produce an invalid event.
        """
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": float(ts_us), "dur": max(0.0, float(dur_us)),
            "pid": self.pid, "tid": self.tid,
            "args": _clean(args),
        })

    def instant(self, name: str, cat: str = "serve", **args: Any) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": perf_us(),
            "pid": self.pid, "tid": self.tid,
            "args": _clean(args),
        })

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "serve") -> None:
        """Counter sample — Perfetto renders these as stacked series."""
        self.events.append({
            "name": name, "cat": cat, "ph": "C",
            "ts": perf_us(),
            "pid": self.pid, "tid": self.tid,
            "args": _clean(values),
        })

    # -- serialisation --------------------------------------------------
    def to_json(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA},
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def validate_trace(doc: dict) -> List[str]:
    """Schema check for exported traces; returns a list of violations.

    Guarded by tier-1 tests so the on-disk format cannot drift without
    a deliberate schema bump: top-level ``traceEvents`` + the
    ``otherData.schema`` tag, and every event a well-formed Chrome
    trace phase with monotonic-microsecond ``ts``.
    """
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["trace document is not an object"]
    if doc.get("otherData", {}).get("schema") != TRACE_SCHEMA:
        errs.append(f"otherData.schema != {TRACE_SCHEMA!r}")
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return errs + ["traceEvents is not a list"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "B", "E", "M"):
            errs.append(f"{where}: bad phase {ph!r}")
        for field in ("name", "ts", "pid", "tid"):
            if field not in ev:
                errs.append(f"{where}: missing {field!r}")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            errs.append(f"{where}: X event needs dur >= 0")
        if ev.get("cat") not in CATEGORIES:
            errs.append(f"{where}: unknown category {ev.get('cat')!r}")
        if "args" in ev:
            try:
                json.dumps(ev["args"])
            except TypeError:
                errs.append(f"{where}: args not JSON-serialisable")
            ua = ev["args"].get("unattributed_steps") \
                if isinstance(ev["args"], dict) else None
            if isinstance(ua, (int, float)) and ua > 0:
                # a reconciliation row that skipped steps means the wire
                # attribution has a hole — never "free" wire time
                errs.append(f"{where}: {ev.get('name')} has "
                            f"unattributed_steps={ua}")
    return errs
