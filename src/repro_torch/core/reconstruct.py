"""Position-aware latent reconstruction (paper §3.4, Eqs. 13-17).

Given the K local noise predictions and the partition plan, compute

    A(x) = sum_k I_k(x) * W^(k)_{pi_k(x)} * pred_k[pi_k(x)]     (Eq. 15)
    Z(x) = sum_k I_k(x) * W^(k)_{pi_k(x)}                       (Eq. 16)
    F(x) = A(x) / Z(x)                                          (Eq. 17)

The single-host reference for paper-exact (unequal) partitions: a loop
over partitions with slice-adds.  Uniform windows go through
``core/spmd.blend_windows`` and its kernel instead.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .partition import PartitionPlan
from .weights import global_normalizer, partition_weights


def _shape_weight(w: np.ndarray, ndim: int, axis: int, device) -> torch.Tensor:
    """Broadcast a 1-D weight along ``axis`` of an ``ndim``-rank tensor."""
    shape = [1] * ndim
    shape[axis] = w.shape[0]
    return torch.from_numpy(w).to(device).reshape(shape)


def reconstruct(
    preds: Sequence[torch.Tensor],
    plan: PartitionPlan,
    axis: int,
    accumulate_dtype=torch.float32,
) -> torch.Tensor:
    """Stitch K local predictions into the global prediction (Eq. 17)."""
    if len(preds) != plan.num_partitions:
        raise ValueError(
            f"got {len(preds)} predictions for K={plan.num_partitions}"
        )
    ref = preds[0]
    out_shape = list(ref.shape)
    out_shape[axis] = plan.extent
    acc = torch.zeros(out_shape, dtype=accumulate_dtype, device=ref.device)
    weights = partition_weights(plan)
    for k, pred in enumerate(preds):
        s, e = plan.lat_start[k], plan.lat_end[k]
        if pred.shape[axis] != e - s:
            raise ValueError(
                f"partition {k}: prediction extent {pred.shape[axis]} != "
                f"plan extent {e - s} along axis {axis}"
            )
        w = _shape_weight(weights[k], pred.ndim, axis, ref.device)
        acc.narrow(axis, s, e - s).add_(pred.to(accumulate_dtype) * w)
    z = _shape_weight(global_normalizer(plan), acc.ndim, axis, ref.device)
    return (acc / z).to(ref.dtype)
