"""Patch-aligned overlapping partition (paper §3.3, Eqs. 7-10).

Partitioning happens in *patch space*: the DiT patchify sizes
``(p_T, p_H, p_W)`` define the atomic units, and partition boundaries always
land on patch boundaries so no visual patch is cut in half.

Two planners are provided:

* :func:`plan_partition` — the paper-exact scheme (Eqs. 7-10):
  ``L = ceil(N/K)`` core patches per partition, ``O = floor(L*r)`` overlap
  patches, extended bounds clipped to ``[0, N)``.
* :func:`plan_partition_balanced` — a beyond-paper variant distributing
  ``N mod K`` leftover patches one-per-partition, avoiding the paper
  formula's empty partitions when ``N`` is close to ``K`` (e.g. 21 latent
  frames over 16 devices).  Used by the SPMD engine.

All geometry is static Python/numpy — partitioning never traces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Static geometry of a K-way patch-aligned overlapping partition.

    All bounds are half-open ``[start, end)``.  ``core_*`` / ``ext_*`` are in
    patch space, ``lat_*`` in latent space (patch index * patch size, with
    the final partition absorbing any remainder ``D mod p``).
    """

    dim: int                      # which latent dim (0=T, 1=H, 2=W)
    extent: int                   # D_d: latent size along dim
    patch: int                    # p_d: patch size along dim
    num_partitions: int           # K
    overlap_ratio: float          # r
    num_patches: int              # N_d = floor(D_d / p_d)
    core_patches: int             # L  (paper; max core size for balanced)
    overlap_patches: int          # O
    core_start: Tuple[int, ...]   # alpha_k, patch space
    core_end: Tuple[int, ...]     # beta_k
    ext_start: Tuple[int, ...]    # alpha'_k
    ext_end: Tuple[int, ...]      # beta'_k
    lat_start: Tuple[int, ...]    # s_k, latent space
    lat_end: Tuple[int, ...]      # e_k

    @property
    def sizes(self) -> Tuple[int, ...]:
        """ell_k = e_k - s_k, latent units."""
        return tuple(e - s for s, e in zip(self.lat_start, self.lat_end))

    @property
    def core_lat_start(self) -> Tuple[int, ...]:
        return tuple(a * self.patch for a in self.core_start)

    @property
    def core_lat_end(self) -> Tuple[int, ...]:
        # A core ending at the last patch absorbs the remainder D mod p, so
        # the latent tail is always inside some core region.
        return tuple(
            self.extent if b == self.num_patches else b * self.patch
            for b in self.core_end
        )

    @property
    def delta_start(self) -> Tuple[int, ...]:
        """Front overlap lengths (latent units), Eq. 11."""
        return tuple(
            c - s for c, s in zip(self.core_lat_start, self.lat_start)
        )

    @property
    def delta_end(self) -> Tuple[int, ...]:
        """Rear overlap lengths (latent units), Eq. 11."""
        return tuple(e - c for c, e in zip(self.core_lat_end, self.lat_end))

    def validate(self) -> None:
        assert len(self.lat_start) == self.num_partitions
        covered = np.zeros(self.extent, dtype=bool)
        for s, e in zip(self.lat_start, self.lat_end):
            assert 0 <= s <= e <= self.extent, (s, e, self.extent)
            covered[s:e] = True
        assert covered.all(), "partition does not cover the latent extent"
        for s, e, a, b in zip(
            self.lat_start, self.lat_end, self.core_lat_start, self.core_lat_end
        ):
            assert s <= a <= b <= e, "core region must lie inside the partition"


def _finalize(
    dim: int,
    extent: int,
    patch: int,
    K: int,
    r: float,
    L: int,
    O: int,
    core_start: List[int],
    core_end: List[int],
) -> PartitionPlan:
    N = extent // patch
    ext_start = [max(0, a - O) for a in core_start]
    ext_end = [min(N, b + O) for b in core_end]
    lat_start = [a * patch for a in ext_start]
    lat_end = [b * patch for b in ext_end]
    # Absorb the remainder D mod p into any partition touching the last patch
    # (the paper assumes p | D; real latents are padded but we stay general).
    for k in range(K):
        if ext_end[k] == N:
            lat_end[k] = extent
    plan = PartitionPlan(
        dim=dim,
        extent=extent,
        patch=patch,
        num_partitions=K,
        overlap_ratio=r,
        num_patches=N,
        core_patches=L,
        overlap_patches=O,
        core_start=tuple(core_start),
        core_end=tuple(core_end),
        ext_start=tuple(ext_start),
        ext_end=tuple(ext_end),
        lat_start=tuple(lat_start),
        lat_end=tuple(lat_end),
    )
    plan.validate()
    return plan


def plan_partition(
    extent: int, patch: int, num_partitions: int, overlap_ratio: float, dim: int = 0
) -> PartitionPlan:
    """Paper-exact partition (Eqs. 7-10).

    ``alpha_k = (k-1) * L``, ``beta_k = alpha_k + L`` with
    ``L = ceil(N / K)``; extended bounds clipped to ``[0, N)``.  ``beta_k``
    is additionally clamped to ``N`` so trailing partitions stay valid when
    ``K * L > N`` (the paper's formula leaves them dangling past the array).
    """
    K, r = num_partitions, overlap_ratio
    if K < 1:
        raise ValueError(f"need at least one partition, got K={K}")
    if not 0.0 <= r <= max(0, K - 1):
        raise ValueError(f"overlap ratio must be in [0, K-1], got r={r}")
    N = extent // patch
    if N < 1:
        raise ValueError(f"latent extent {extent} shorter than one patch {patch}")
    L = math.ceil(N / K)
    O = math.floor(L * r)
    core_start = [min((k - 1) * L, N) for k in range(1, K + 1)]
    core_end = [min(a + L, N) for a in core_start]
    return _finalize(dim, extent, patch, K, r, L, O, core_start, core_end)


def plan_partition_balanced(
    extent: int, patch: int, num_partitions: int, overlap_ratio: float, dim: int = 0
) -> PartitionPlan:
    """Balanced cores: the first ``N mod K`` partitions take ``ceil(N/K)``
    patches, the rest ``floor(N/K)``.  Every partition is non-empty when
    ``N >= K``.  Overlap ``O`` uses the max core size, matching the paper's
    ``O = floor(L * r)`` scaling."""
    K, r = num_partitions, overlap_ratio
    if K < 1:
        raise ValueError(f"need at least one partition, got K={K}")
    if not 0.0 <= r <= max(0, K - 1):
        raise ValueError(f"overlap ratio must be in [0, K-1], got r={r}")
    N = extent // patch
    if N < K:
        raise ValueError(
            f"balanced partition needs at least one patch per partition "
            f"(N={N} < K={K}); drop this dim from the rotation instead"
        )
    base, extra = divmod(N, K)
    L = base + (1 if extra else 0)
    O = math.floor(L * r)
    core_start, core_end = [], []
    pos = 0
    for k in range(K):
        size = base + (1 if k < extra else 0)
        core_start.append(pos)
        core_end.append(pos + size)
        pos += size
    assert pos == N
    return _finalize(dim, extent, patch, K, r, L, O, core_start, core_end)


def slice_bounds(plan: PartitionPlan, k: int) -> Tuple[int, int]:
    """Latent-space bounds ``[s_k, e_k)`` of partition ``k`` (0-indexed)."""
    return plan.lat_start[k], plan.lat_end[k]


def extract(z, plan: PartitionPlan, k: int, axis: int):
    """``z_t^(k) = z_t[R_k]`` (Eq. 10): slice partition ``k`` along ``axis``."""
    s, e = slice_bounds(plan, k)
    idx = [slice(None)] * z.ndim
    idx[axis] = slice(s, e)
    return z[tuple(idx)]
