"""Step-policy subsystem: per-denoise decisions the engine used to freeze.
A port of ``repro/policy/`` (framework-free: copies, held to the
reference by ``tests/test_torch_policy.py``).

The paper's comm wins come from exploiting what the denoising trajectory
tolerates at each timestep.  A fixed wire codec is chosen once per
request; this package owns two decisions per denoise instead:

  * ``schedule`` — a **codec schedule over timesteps**: sigma-threshold
    segments (e.g. int8-residual while sigma >= s_hi, int8 mid, bf16
    tail), with segment boundaries resolved against the sampler's actual
    sigma trajectory.  ``core/lp_step.lp_denoise`` executes a schedule
    as segmented runs: one run per (rotation-dim run x codec segment),
    residual codec state reset exactly once per segment boundary, the
    segment codec in the step-cache key (misses <= 3 x num_segments per
    denoise).
  * ``envelope`` — the conformance-matrix PSNR envelope (the per-codec
    floors the reference's ``tests/test_lp_conformance.py`` gates: bf16 >= 50 dB,
    int8* >= 40 dB, int4* >= 24 dB) plus the sigma-credit model that
    says how much of that floor a high-noise step can spend.
  * ``autotune`` — the cost-model-driven planner: picks (engine, codec
    schedule) by minimizing ``core/comm_model`` analytic wire bytes
    subject to a caller PSNR floor against the envelope.

Wired through ``LPStepCompiler(schedule=)``, ``LPServingEngine
(codec_schedule=)``, and ``--codec-schedule auto|<spec>`` /
``--psnr-floor`` in ``launch/serve.py``.
"""
from .envelope import (  # noqa: F401
    HIGH_NOISE_CREDIT_DB,
    PSNR_ENVELOPE_DB,
    codec_floor_db,
    effective_floor_db,
    schedule_envelope_db,
)
from .schedule import (  # noqa: F401
    CodecSchedule,
    ScheduleSegment,
    parse_schedule,
    segment_steps,
)
from .autotune import (  # noqa: F401
    DEFAULT_LINKS,
    LinkModel,
    StepPolicyPlan,
    auto_plan,
    resolve_cli_schedule,
)
