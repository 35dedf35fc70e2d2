"""Failure types of the port's runtime (the part of ``repro/runtime/ft.py``
the serving engine needs; the checkpointing training loop is ROADMAP
Queue 1 item 12)."""
from __future__ import annotations


class DeviceFailure(RuntimeError):
    """Device or host loss: the serving engine retries the batch from its
    last boundary snapshot."""
