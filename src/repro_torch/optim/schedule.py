"""LR schedules."""
from __future__ import annotations

import math


def warmup_cosine(step, peak_lr: float, warmup: int = 100, total: int = 10_000,
                  floor_frac: float = 0.1) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor_frac * peak_lr`` at ``total``; a host float."""
    s = float(step)
    warm = peak_lr * min(1.0, s / max(warmup, 1))
    prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + math.cos(math.pi * prog))
    return warm if s < warmup else peak_lr * cos
