"""Optimizers of the port: AdamW, Adafactor and the LR schedule
(``repro/optim``: the same math on the same tree structure, f32 moments).

States mirror the parameter tree.  Unlike the reference, which returns new
arrays, an update writes the new parameters and moments into the given
tensors (and returns them), so a full-width model keeps one copy of its
parameters and optimizer state on the card.
"""
from .adafactor import adafactor_init, adafactor_update  # noqa: F401
from .adamw import adamw_init, adamw_update  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401


def get_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
