"""Stub modality frontends: the text encoder of the video model (the umT5
encoder is not run: the prompt arrives as precomputed embeddings) and the
VLM's vision encoder (InternViT is not run: patch embeddings arrive
projected to ``d_model``).  The audio frontend waits for the audio family
(ROADMAP Queue 1 item 12)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from .dit import model_dtype


def text_context(generator: Optional[torch.Generator], batch: int,
                 cfg: ArchConfig, device: DeviceLike = None) -> torch.Tensor:
    """Encoded text prompt (B, L_ctx, ctx_dim), f32, N(0, 0.02^2).
    ``generator`` must live on ``device``."""
    device = resolve_device(device)
    return torch.randn((batch, cfg.context_len, cfg.context_dim),
                       generator=generator, device=device) * 0.02


def vision_patches(generator: Optional[torch.Generator], batch: int,
                   cfg: ArchConfig, device: DeviceLike = None) -> torch.Tensor:
    """InternViT patch embeddings projected to ``d_model``: (B, N_vis, d),
    N(0, 0.02^2) in the model dtype.  ``generator`` must live on
    ``device``."""
    device = resolve_device(device)
    return (torch.randn((batch, cfg.num_vision_tokens, cfg.d_model), generator=generator,
                        device=device) * 0.02).to(model_dtype(cfg))
