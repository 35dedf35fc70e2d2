"""One monotonic clock for every wall measurement of the port.

Every host-side duration (the engine's ``batch_wall_s``, a request's
queue wait and end-to-end time) comes from the same monotonic source,
so they are comparable with each other and immune to NTP slews.
"""
from __future__ import annotations

import time


def perf_s() -> float:
    """Monotonic seconds — the clock for all durations."""
    return time.perf_counter()
