"""End-to-end denoising pipelines: centralized and Latent-Parallel.

A port of ``repro/diffusion/pipeline.py``.  ``dit`` is any callable
``dit(z, t, context) -> pred`` (a ``models.dit.DiT``).  Guidance is
batched on the device: cond and uncond run as one DiT call.  When the
LP loop stacks K windows on the batch axis, the guided denoisers tile
their conditioning K times to match (``core/lp_step.py``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import LPStepCompiler, lp_denoise, lp_denoise_reference
from repro_torch.diffusion.cfg import cfg_combine
from repro_torch.diffusion.sampler import FlowMatchEuler


def _tile(cond: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat per-request conditioning to a batch of ``n`` stacked windows
    (window ``k*B + b`` belongs to request ``b``)."""
    if n % cond.shape[0]:
        raise ValueError(f"batch {n} is not a multiple of {cond.shape[0]} requests")
    return cond.repeat((n // cond.shape[0],) + (1,) * (cond.ndim - 1))


def make_guided_denoiser(dit: Callable, context: torch.Tensor,
                         null_context: torch.Tensor, guidance: float = 5.0):
    """Returns f~(z, t) with CFG batched on-device (cond+uncond stacked)."""

    def guided(z, t):
        b = z.shape[0]
        z2 = torch.cat([z, z], dim=0)
        t2 = torch.cat([t, t], dim=0)
        ctx = torch.cat([_tile(context, b), _tile(null_context, b)], dim=0)
        pred = dit(z2, t2, ctx)
        return cfg_combine(pred[:b], pred[b:], guidance)

    return guided


def make_guided_step_denoiser(dit: Callable, guidance_default: float = 5.0):
    """Guided denoiser for the LP step cache: ``(window, t, context,
    null_context, guidance)`` are all call arguments, so one denoiser
    serves every batch (the serving engine builds it once)."""

    def guided(window, t, context, null_context, guidance=None):
        g = guidance_default if guidance is None else guidance
        b = window.shape[0]
        z2 = torch.cat([window, window], dim=0)
        t2 = torch.full((2 * b,), float(t), dtype=torch.float32, device=window.device)
        ctx = torch.cat([_tile(context, b), _tile(null_context, b)], dim=0)
        pred = dit(z2, t2, ctx)
        return cfg_combine(pred[:b], pred[b:], g)

    return guided


def generate_centralized(guided_denoiser: Callable, z_T: torch.Tensor,
                         num_steps: int,
                         sampler: Optional[FlowMatchEuler] = None) -> torch.Tensor:
    sampler = sampler or FlowMatchEuler(num_steps)
    z = z_T
    for i in range(1, num_steps + 1):
        t = torch.full((z.shape[0],), sampler.timestep(i), dtype=torch.float32,
                       device=z.device)
        z = sampler.step(z, guided_denoiser(z, t), i)
    return z


def generate_lp(
    guided_denoiser: Callable,
    z_T: torch.Tensor,
    num_steps: int,
    num_partitions: int,
    overlap_ratio: float,
    patch_sizes: Sequence[int],
    sampler: Optional[FlowMatchEuler] = None,
    spatial_axes: Sequence[int] = (1, 2, 3),   # (B, T, H, W, C) layout
    uniform: bool = False,
    compiled: bool = True,
    compiler: Optional[LPStepCompiler] = None,
) -> torch.Tensor:
    """Latent-Parallel generation (paper Fig. 3 full loop).

    ``compiled=True`` rides ``lp_denoise`` and its step cache (pass
    ``compiler`` to share it across calls); ``compiled=False`` runs the
    eager reference loop.  The names follow the reference API.
    """
    sampler = sampler or FlowMatchEuler(num_steps)

    def batched(sub, t_val):
        t = torch.full((sub.shape[0],), t_val, dtype=torch.float32, device=sub.device)
        return guided_denoiser(sub, t)

    if not compiled:
        return lp_denoise_reference(
            lambda i, dim: (lambda sub: batched(sub, sampler.timestep(i))),
            z_T, lambda z, pred, i: sampler.step(z, pred, i),
            num_steps, num_partitions, overlap_ratio, patch_sizes,
            spatial_axes, uniform=uniform,
        )
    return lp_denoise(
        batched, z_T, sampler, num_steps, num_partitions, overlap_ratio,
        patch_sizes, spatial_axes, uniform=uniform, compiler=compiler,
    )
