"""Config registry of the port.

``get_config(arch)`` returns the exact published config of the video
model (``wan21-dit-1.3b``) and of the LM architectures the port runs:
the hybrid ``zamba2-2.7b``, the dense ``granite-3-2b``,
``h2o-danube-1.8b`` (sliding-window attention), ``minitron-4b`` and
``llama3-405b``, the MoE ``granite-moe-3b-a800m`` and
``llama4-maverick-400b-a17b``, the VLM ``internvl2-26b`` and the xLSTM
``xlstm-1.3b``.  The reference registry's ``whisper-small`` is not
ported yet (ROADMAP Queue 1 item 12); asking for it raises ``KeyError``.
"""
from __future__ import annotations

from .base import LM_SHAPES, VDM_SHAPES, ArchConfig, ParallelConfig, ShapeConfig
from .granite_3_2b import CONFIG as _GRANITE
from .granite_moe_3b_a800m import CONFIG as _GRANITE_MOE
from .h2o_danube_1p8b import CONFIG as _DANUBE
from .internvl2_26b import CONFIG as _INTERNVL2
from .llama3_405b import CONFIG as _LLAMA3
from .llama4_maverick_400b_a17b import CONFIG as _LLAMA4
from .minitron_4b import CONFIG as _MINITRON
from .wan21_dit_1p3b import CONFIG as _WAN21
from .xlstm_1p3b import CONFIG as _XLSTM
from .zamba2_2p7b import CONFIG as _ZAMBA2

_CONFIGS = {c.name: c for c in (_WAN21, _ZAMBA2, _GRANITE, _GRANITE_MOE, _LLAMA4, _INTERNVL2,
                                _DANUBE, _MINITRON, _LLAMA3, _XLSTM)}
_UNPORTED = ("whisper-small",)


def get_config(arch: str) -> ArchConfig:
    if arch in _UNPORTED:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP Queue 1 item 12); the port "
                       f"has: {sorted(_CONFIGS)}")
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
