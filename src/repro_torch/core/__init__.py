"""Latent Parallelism (LP) on one GPU or across an lp group: the port of
``repro.core``.

  schedule / partition / weights / uniform — framework-free geometry,
      copied from the reference (the port never imports it)
  comm_model  — the analytic byte model, copied (numpy only)
  reconstruct — paper-exact stitching (Eqs. 13-17)
  spmd        — uniform windows: slice, and stitch through the
                ``latent_blend`` kernel (``blend_windows_coded``: through
                ``int8_quantize`` + ``dequant_blend`` for an int8 wire);
                across ranks the psum (``lp_forward_shard_map``) and halo
                (``lp_forward_halo``) engines
  lp_step     — the LP loops, the step cache and boundary snapshots;
                ``codec=`` runs the halo wire mirror (``comm/wire.py``),
                ``forward=`` an engine bound to an lp group
"""
from .schedule import (  # noqa: F401
    DIM_NAMES,
    HEIGHT,
    TEMPORAL,
    WIDTH,
    rotation_dim,
    rotation_schedule,
    usable_dims,
)
from .partition import (  # noqa: F401
    PartitionPlan,
    extract,
    plan_partition,
    plan_partition_balanced,
)
from .weights import blend_weight_1d, global_normalizer, partition_weights  # noqa: F401
from .reconstruct import reconstruct  # noqa: F401
from .uniform import UniformPlan, expansion_factor, plan_uniform  # noqa: F401
from .spmd import blend_windows, blend_windows_coded, stack_windows  # noqa: F401
from .lp_step import (  # noqa: F401
    DenoiseSnapshot,
    LPStepCompiler,
    lp_denoise,
    lp_denoise_reference,
    lp_forward,
    lp_forward_uniform,
)
