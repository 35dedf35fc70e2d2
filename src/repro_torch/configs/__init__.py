"""Config registry of the port: the video model only.

``get_config("wan21-dit-1.3b")`` returns the exact published config;
the LM architectures of the reference registry are not ported yet
(ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from .base import VDM_SHAPES, ArchConfig, ShapeConfig
from .wan21_dit_1p3b import CONFIG as _WAN21

_CONFIGS = {"wan21-dit-1.3b": _WAN21}


def get_config(arch: str) -> ArchConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; the port has: {sorted(_CONFIGS)}")
    return _CONFIGS[arch]


def get_shape(name: str) -> ShapeConfig:
    if name not in VDM_SHAPES:
        raise KeyError(f"unknown shape {name!r}; the port has: {sorted(VDM_SHAPES)}")
    return VDM_SHAPES[name]
