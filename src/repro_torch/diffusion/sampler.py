"""Sampling schedulers S(.) (paper Eq. 1/6), a port of
``repro/diffusion/sampler.py``.

Schedules are numpy, exactly as in the reference; updates are f32 math
on tensors, cast back to ``z``'s dtype.  Two call forms per scheduler:
``step(z, pred, i)`` and ``step_scalars(i)`` + ``update(z, pred, scalars)``
(the form the LP step cache uses).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchEuler:
    """sigma_i linearly spaced 1 -> 0 over num_steps (shifted optional)."""

    num_steps: int
    shift: float = 3.0  # WAN uses a shifted schedule

    def sigmas(self) -> np.ndarray:
        s = np.linspace(1.0, 0.0, self.num_steps + 1)
        if self.shift != 1.0:
            s = self.shift * s / (1 + (self.shift - 1) * s)
        return s.astype(np.float32)

    def timestep(self, i: int) -> float:
        """Model conditioning timestep for forward pass i (1-indexed)."""
        return float(self.sigmas()[i - 1] * 1000.0)

    def step(self, z: torch.Tensor, velocity: torch.Tensor, i: int) -> torch.Tensor:
        s = self.sigmas()
        dt = float(s[i] - s[i - 1])  # negative
        return z + dt * velocity.to(z.dtype)

    def step_scalars(self, i: int) -> np.float32:
        s = self.sigmas()
        return np.float32(s[i] - s[i - 1])

    def update(self, z: torch.Tensor, velocity: torch.Tensor, dt) -> torch.Tensor:
        """Euler step in f32, cast back to z.dtype."""
        return (z.float() + float(dt) * velocity.float()).to(z.dtype)


@dataclasses.dataclass(frozen=True)
class DDIM:
    """Deterministic DDIM over a linear-beta DDPM schedule, eps-pred."""

    num_steps: int
    beta_start: float = 8.5e-4
    beta_end: float = 1.2e-2
    train_steps: int = 1000

    def _alphas(self) -> np.ndarray:
        betas = np.linspace(self.beta_start, self.beta_end, self.train_steps)
        return np.cumprod(1.0 - betas).astype(np.float32)

    def _schedule(self) -> np.ndarray:
        return np.linspace(self.train_steps - 1, 0, self.num_steps).astype(int)

    def timestep(self, i: int) -> float:
        return float(self._schedule()[i - 1])

    def step(self, z: torch.Tensor, eps: torch.Tensor, i: int) -> torch.Tensor:
        sched = self._schedule()
        ab = self._alphas()
        t = sched[i - 1]
        t_next = sched[i] if i < self.num_steps else -1
        a_t = float(ab[t])
        a_next = float(ab[t_next]) if t_next >= 0 else 1.0
        eps = eps.float()
        x0 = (z.float() - float(np.sqrt(1 - a_t)) * eps) / float(np.sqrt(a_t))
        out = float(np.sqrt(a_next)) * x0 + float(np.sqrt(1 - a_next)) * eps
        return out.to(z.dtype)

    def step_scalars(self, i: int) -> Tuple[np.float32, np.float32]:
        sched = self._schedule()
        ab = self._alphas()
        t = sched[i - 1]
        t_next = sched[i] if i < self.num_steps else -1
        a_next = float(ab[t_next]) if t_next >= 0 else 1.0
        return (np.float32(ab[t]), np.float32(a_next))

    def update(self, z: torch.Tensor, eps: torch.Tensor, scalars) -> torch.Tensor:
        """The reference's traced-scalar form: the square roots are f32."""
        a_t, a_next = (np.float32(a) for a in scalars)
        one = np.float32(1.0)
        eps = eps.float()
        x0 = (z.float() - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
        out = float(np.sqrt(a_next)) * x0 + float(np.sqrt(one - a_next)) * eps
        return out.to(z.dtype)
