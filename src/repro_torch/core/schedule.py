"""Dynamic rotating partition schedule (paper Eq. 3).

At forward pass ``i`` (1-indexed; ``i = T + 1 - t`` for diffusion timestep
``t`` counting down from ``T``) the partitioning dimension is

    d_i = M[(i - 1) mod 3 + 1]

where ``M`` maps 1, 2, 3 to temporal, height, width.  Rotation guarantees
2-completeness of the receptive field (paper supplementary Thm. 1): any two
consecutive steps partition along different dimensions, so information
reaches the whole latent within two steps.
"""
from __future__ import annotations

from typing import Sequence, Tuple

#: Canonical order of latent dimensions, matching the paper's M(.) mapping.
DIM_NAMES: Tuple[str, str, str] = ("temporal", "height", "width")
TEMPORAL, HEIGHT, WIDTH = 0, 1, 2


def rotation_dim(i: int, dims: Sequence[int] = (TEMPORAL, HEIGHT, WIDTH)) -> int:
    """Partition dimension for the ``i``-th forward pass (1-indexed).

    ``dims`` restricts the rotation cycle (e.g. a latent whose temporal
    extent is too small to split K ways rotates over height/width only).
    The paper's Eq. 3 is the default ``dims=(0, 1, 2)`` case.
    """
    if i < 1:
        raise ValueError(f"forward pass index is 1-indexed, got {i}")
    if not dims:
        raise ValueError("rotation requires at least one dimension")
    return dims[(i - 1) % len(dims)]


def rotation_schedule(
    num_steps: int, dims: Sequence[int] = (TEMPORAL, HEIGHT, WIDTH)
) -> Tuple[int, ...]:
    """Partition dimension for every forward pass of a ``num_steps`` run."""
    return tuple(rotation_dim(i, dims) for i in range(1, num_steps + 1))


def usable_dims(
    latent_dims: Sequence[int],
    patch_sizes: Sequence[int],
    num_partitions: int,
    dims: Sequence[int] = (TEMPORAL, HEIGHT, WIDTH),
) -> Tuple[int, ...]:
    """Dims with at least one patch per partition (``N_d >= K``).

    The paper evaluates K=4 GPUs where every dimension qualifies; at K=16 a
    short temporal extent (e.g. 13 latent frames for a 3 s video) cannot be
    split 16 ways, so the rotation cycle drops it.  Dropping a dim preserves
    2-completeness as long as >= 2 dims remain (consecutive steps still
    partition along different dimensions).
    """
    out = []
    for d in dims:
        n_patches = latent_dims[d] // patch_sizes[d]
        if n_patches >= num_partitions:
            out.append(d)
    return tuple(out)
