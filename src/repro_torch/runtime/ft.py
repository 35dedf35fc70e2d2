"""Fault-tolerant training loop and the failure type the serving engine
retries on (``repro/runtime/ft.py``).

Failures are injected as exceptions from a ``FailureInjector``, so the
restart logic runs end to end.  ``run_training`` guarantees:

  * training state after recovery == state replayed from the checkpoint
    step (the data stream is random-access by step, so no data is skipped
    or counted twice);
  * at most ``max_restarts`` recoveries before surfacing the failure;
  * the checkpoint cadence bounds lost work to ``ckpt_every`` steps.

On the card a recovered run equals a clean one bit for bit only where
every kernel of the step is deterministic: the port's flash kernels and
the SSD scan's forward and backward (``mamba_ssd``, ``mamba_ssd_bwd``)
are, and ``torch.use_deterministic_algorithms(True)`` makes PyTorch's own
(the embedding's gradient) so.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from .checkpoint import AsyncCheckpointer, latest_step, restore


class DeviceFailure(RuntimeError):
    """Device or host loss: the serving engine retries the batch from its
    last boundary snapshot; ``run_training`` restarts from the last
    checkpoint."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at given steps (each fires once)."""

    fail_at: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise DeviceFailure(f"injected device failure at step {step}")


@dataclasses.dataclass
class RunReport:
    final_step: int
    restarts: int
    losses: Dict[int, float]


def run_training(
    train_step: Callable,
    init_state: Callable[[], Any],      # () -> (params, opt_state)
    batch_for_step: Callable[[int], Any],
    num_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_restarts: int = 3,
    injector: Optional[FailureInjector] = None,
    keep_last: int = 3,
) -> RunReport:
    """Run ``num_steps``, surviving injected failures via restart."""
    ckpt = AsyncCheckpointer(ckpt_dir, keep_last=keep_last)
    restarts = 0
    losses: Dict[int, float] = {}

    while True:
        # ---- (re)start: restore or init
        start = latest_step(ckpt_dir)
        params, opt_state = init_state()
        step = 0
        if start is not None:
            (params, opt_state), _ = restore(ckpt_dir, (params, opt_state), step=start)
            step = start
        try:
            while step < num_steps:
                if injector is not None:
                    injector.check(step)
                batch = batch_for_step(step)
                params, opt_state, metrics = train_step(params, opt_state, batch, step)
                losses[step] = float(metrics["loss"])
                step += 1
                if step % ckpt_every == 0 or step == num_steps:
                    ckpt.save(step, (params, opt_state), {"note": "auto"})
            ckpt.wait()
            return RunReport(final_step=step, restarts=restarts, losses=losses)
        except DeviceFailure:
            restarts += 1
            ckpt.wait()
            if restarts > max_restarts:
                raise
