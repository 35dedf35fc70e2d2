"""One monotonic clock for every span, metric, and wall measurement.
A copy of ``repro/obs/clock.py``.

Every host-side duration in the repo — engine ``batch_wall_s``, trace
span ``dur``, benchmark timers — must come from the same monotonic
source so they are mutually comparable and immune to NTP slews.
``time.time()`` is reserved for *stamps* (when did this snapshot get
written), never for durations.
"""
from __future__ import annotations

import time

__all__ = ["perf_s", "perf_us", "wall_stamp_s"]


def perf_s() -> float:
    """Monotonic seconds — the clock for all durations."""
    return time.perf_counter()


def perf_us() -> float:
    """Monotonic microseconds — Chrome-trace ``ts``/``dur`` units."""
    return time.perf_counter() * 1e6


def wall_stamp_s() -> float:
    """Wall-clock epoch seconds — for snapshot timestamps ONLY.

    Never subtract two of these; use :func:`perf_s` for durations.
    """
    return time.time()
