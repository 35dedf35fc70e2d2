"""Uniform-window partition variant for SPMD execution (TPU adaptation).

XLA SPMD requires identical shapes on every rank, but the paper's Eq. 8
clips edge partitions (`max(0, ...)`, `min(N, ...)`) to *different* sizes.
Instead of padding + masking, every rank slices a fixed-size window of
``W = L + 2*O`` patches whose *start* is clamped into range:

    start_k = clamp(core_start_k - O, 0, N - W)

Edge ranks therefore see extra valid context on their clipped side (a
superset of the paper's context — quality can only improve).  Blend
ramps span the full distance from the core edge to the window edge so the
trapezoids of neighboring ranks still sum consistently, and the global
normalizer remains an analytic function of geometry.

Cores are assigned with the *balanced* scheme so all ranks do useful work
even when N is barely >= K (e.g. 21 latent frames over 16 devices).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .partition import PartitionPlan, plan_partition_balanced
from .weights import blend_weight_1d


@dataclasses.dataclass(frozen=True)
class UniformPlan:
    """K equal-size windows with per-rank core bounds and blend deltas."""

    dim: int
    extent: int                    # D_d (latent units); must be patch-aligned
    patch: int
    num_partitions: int
    overlap_ratio: float
    window: int                    # window size, latent units (same all ranks)
    starts: Tuple[int, ...]        # s_k, latent units
    core_start: Tuple[int, ...]    # latent units, global coords
    core_end: Tuple[int, ...]
    delta_start: Tuple[int, ...]   # front ramp lengths (latent units)
    delta_end: Tuple[int, ...]     # rear ramp lengths

    @property
    def ends(self) -> Tuple[int, ...]:
        return tuple(s + self.window for s in self.starts)

    def weight_1d(self, k: int) -> np.ndarray:
        return blend_weight_1d(self.window, self.delta_start[k], self.delta_end[k])

    def normalizer(self) -> np.ndarray:
        z = np.zeros(self.extent, dtype=np.float32)
        for k in range(self.num_partitions):
            s = self.starts[k]
            z[s : s + self.window] += self.weight_1d(k)
        assert (z > 0).all(), "uncovered positions in uniform plan"
        return z

    def validate(self) -> None:
        K = self.num_partitions
        assert len(self.starts) == K
        covered = np.zeros(self.extent, dtype=bool)
        core_covered = np.zeros(self.extent, dtype=bool)
        for k in range(K):
            s, e = self.starts[k], self.starts[k] + self.window
            assert 0 <= s and e <= self.extent, (s, e, self.extent)
            assert s <= self.core_start[k] <= self.core_end[k] <= e
            covered[s:e] = True
            core_covered[self.core_start[k] : self.core_end[k]] = True
        assert covered.all() and core_covered.all()


def plan_uniform(
    extent: int, patch: int, num_partitions: int, overlap_ratio: float, dim: int = 0
) -> UniformPlan:
    """Build the uniform-window plan from a balanced core assignment."""
    if extent % patch != 0:
        raise ValueError(
            f"SPMD uniform partitioning requires patch-aligned extents "
            f"(extent={extent}, patch={patch}); pad the latent first"
        )
    base: PartitionPlan = plan_partition_balanced(
        extent, patch, num_partitions, overlap_ratio, dim
    )
    N = base.num_patches
    K = num_partitions
    L = base.core_patches
    O = base.overlap_patches
    Wp = min(N, L + 2 * O)  # window in patches
    starts, core_s, core_e, d_s, d_e = [], [], [], [], []
    for k in range(K):
        a, b = base.core_start[k], base.core_end[k]
        s = min(max(0, a - O), N - Wp)
        starts.append(s * patch)
        core_s.append(a * patch)
        core_e.append(b * patch)
        d_s.append((a - s) * patch)
        d_e.append((s + Wp - b) * patch)
    plan = UniformPlan(
        dim=dim,
        extent=extent,
        patch=patch,
        num_partitions=K,
        overlap_ratio=overlap_ratio,
        window=Wp * patch,
        starts=tuple(starts),
        core_start=tuple(core_s),
        core_end=tuple(core_e),
        delta_start=tuple(d_s),
        delta_end=tuple(d_e),
    )
    plan.validate()
    return plan


def expansion_factor(plan: UniformPlan) -> float:
    """gamma(r, K) = S_ext / S_z (paper Eq. 19) for the uniform plan."""
    return plan.num_partitions * plan.window / plan.extent
