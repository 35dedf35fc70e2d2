"""Config registry of the port.

``get_config(arch)`` returns the exact published config of the video
model (``wan21-dit-1.3b``), of the hybrid LM (``zamba2-2.7b``) or of the
dense LM (``granite-3-2b``); the other LM architectures of the
reference registry are not ported yet (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from .base import LM_SHAPES, VDM_SHAPES, ArchConfig, ParallelConfig, ShapeConfig
from .granite_3_2b import CONFIG as _GRANITE
from .wan21_dit_1p3b import CONFIG as _WAN21
from .zamba2_2p7b import CONFIG as _ZAMBA2

_CONFIGS = {"wan21-dit-1.3b": _WAN21, "zamba2-2.7b": _ZAMBA2, "granite-3-2b": _GRANITE}


def get_config(arch: str) -> ArchConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; the port has: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


def get_shape(name: str) -> ShapeConfig:
    if name in LM_SHAPES:
        return LM_SHAPES[name]
    if name in VDM_SHAPES:
        return VDM_SHAPES[name]
    raise KeyError(f"unknown shape {name!r}; the port has: "
                   f"{sorted(LM_SHAPES) + sorted(VDM_SHAPES)}")
