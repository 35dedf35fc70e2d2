"""Where the port runs.

Entry points (``init_params``, ``text_context``, ``LPServingEngine``,
``launch/serve.py``) default to the GPU.  Without one they raise unless
the caller asked for the CPU explicitly: nothing carries on quietly on
the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
