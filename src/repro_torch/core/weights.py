"""Position-aware blend weights (paper §3.4, Eqs. 11-12).

For partition ``k`` with extent ``[s_k, e_k)`` (length ``ell_k``), core
region ``[alpha_k * p, beta_k * p)``, front overlap ``Delta_start`` and rear
overlap ``Delta_end``:

    W_j = j / Delta_start                for 0 <= j < Delta_start
        = 1                              for Delta_start <= j < ell - Delta_end
        = (ell - j) / Delta_end          for ell - Delta_end <= j < ell

Weights are deterministic functions of partition *geometry* only.  That
matters on TPU: every device can compute the **global** normalizer
``Z(x) = sum_k I_k(x) * W_k(x)`` (Eq. 16) analytically, so reconstruction
needs a single all-reduce of the weighted predictions instead of shipping
weights across devices.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .partition import PartitionPlan


def blend_weight_1d(length: int, delta_start: int, delta_end: int) -> np.ndarray:
    """Trapezoid weights for one partition (Eq. 12), as float32 numpy.

    Ramp up over ``[0, delta_start)``, flat 1 over the core, ramp down over
    ``[length - delta_end, length)``.  ``delta == 0`` means no ramp on that
    side (boundary partitions clipped by Eq. 8).
    """
    if length < 1:
        return np.zeros((0,), dtype=np.float32)
    if delta_start + delta_end > length:
        raise ValueError(
            f"overlaps ({delta_start}+{delta_end}) exceed partition length {length}"
        )
    j = np.arange(length, dtype=np.float32)
    w = np.ones(length, dtype=np.float32)
    if delta_start > 0:
        ramp = j[:delta_start] / float(delta_start)
        w[:delta_start] = ramp
    if delta_end > 0:
        tail = (float(length) - j[length - delta_end :]) / float(delta_end)
        w[length - delta_end :] = tail
    return w


def partition_weights(plan: PartitionPlan) -> Tuple[np.ndarray, ...]:
    """Per-partition 1-D weight masks ``W^(k)`` along the partition dim."""
    out = []
    for k in range(plan.num_partitions):
        ell = plan.lat_end[k] - plan.lat_start[k]
        out.append(blend_weight_1d(ell, plan.delta_start[k], plan.delta_end[k]))
    return tuple(out)


def global_normalizer(plan: PartitionPlan) -> np.ndarray:
    """``Z(x) = sum_k I_k(x) W^(k)_{pi_k(x)}`` (Eq. 16) over the full extent.

    Computed from geometry alone — no communication.  Positive everywhere
    (every position is in at least one core or adjacent ramp).
    """
    z = np.zeros(plan.extent, dtype=np.float32)
    for k, w in enumerate(partition_weights(plan)):
        s, e = plan.lat_start[k], plan.lat_end[k]
        z[s:e] += w
    if not (z > 0).all():
        raise AssertionError("normalizer has zero entries — uncovered positions")
    return z
