"""Classifier-free guidance (paper Eq. 2/4)."""
from __future__ import annotations

import torch


def cfg_combine(cond: torch.Tensor, uncond: torch.Tensor, w: float) -> torch.Tensor:
    """f~ = f_uncond + w (f_cond - f_uncond), in f32, cast to cond's dtype."""
    u = uncond.float()
    return (u + float(w) * (cond.float() - u)).to(cond.dtype)
