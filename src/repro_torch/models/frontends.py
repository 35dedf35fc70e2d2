"""Stub text frontend of the video model (the umT5 encoder is not run:
the prompt arrives as precomputed embeddings)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device


def text_context(generator: Optional[torch.Generator], batch: int,
                 cfg: ArchConfig, device: DeviceLike = None) -> torch.Tensor:
    """Encoded text prompt (B, L_ctx, ctx_dim), f32, N(0, 0.02^2).
    ``generator`` must live on ``device``."""
    device = resolve_device(device)
    return torch.randn((batch, cfg.context_len, cfg.context_dim),
                       generator=generator, device=device) * 0.02
