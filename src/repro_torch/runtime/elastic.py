"""Mid-request elastic re-planning: the serving half of
``repro/runtime/elastic.py``.  ``reshard_tree`` and ``restore_elastic``
restore training checkpoints onto another mesh; they go with the training
loop (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Optional


def replan_lp_compiler(compiler, new_mesh_shape, forward=None, forward_factory=None,
                       recorder=None, lp_rank: Optional[int] = None) -> bool:
    """Retarget a live ``core/lp_step.LPStepCompiler`` at a new ``(lp, tp)``
    mesh shape (``elastic.py:33``): a straggler or dead group evicted, a
    scale-up.  The lp size becomes the new K.

    * The full geometry is in the step-cache key, so no entry made for the
      old shape is served again.
    * The compiler's ``plan_epoch`` bump makes an in-flight ``lp_denoise``
      re-derive its rotation dims and re-zero the codec state exactly once
      at the next step boundary.
    * A compiler with a group-bound ``forward`` hook, or a group-bound
      ``forward_factory`` (the scheduled twin), must be given one re-bound
      to the new group whenever K changes: this raises at once instead of
      mid-denoise.
      ``lp_rank`` re-binds the rank whose slice of the residual state the
      process threads (the survivors are re-indexed).

    ``recorder`` (``obs.FlightRecorder``, duck-typed) gets an
    ``elastic.replan`` instant when the compiler changed.  Returns True
    when the compiler changed.
    """
    new_mesh_shape = tuple(new_mesh_shape)
    if new_mesh_shape[0] != compiler.num_partitions:
        if compiler.forward is not None and forward is None:
            raise ValueError(
                "re-planning the lp-axis size of a mesh-bound compiler needs a re-bound "
                f"forward hook (the old hook closes over a mesh with lp="
                f"{compiler.num_partitions}, new plan wants lp={new_mesh_shape[0]})")
        if compiler.forward_factory is not None and forward_factory is None:
            raise ValueError(
                "re-planning the lp-axis size of a schedule compiler whose forward_factory "
                "is mesh-bound needs a re-bound factory (the old one binds hooks to a mesh "
                f"with lp={compiler.num_partitions}, new plan wants lp={new_mesh_shape[0]})")
    changed = compiler.replan(num_partitions=new_mesh_shape[0], mesh_shape=new_mesh_shape,
                              forward=forward, forward_factory=forward_factory,
                              lp_rank=lp_rank)
    if changed and recorder is not None:
        recorder.instant("elastic.replan", cat="elastic", new_mesh_shape=list(new_mesh_shape),
                         epoch=compiler.plan_epoch)
    return changed
