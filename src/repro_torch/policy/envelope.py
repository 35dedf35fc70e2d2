"""The PSNR envelope: what quality each wire codec is good for, per sigma.
A copy of ``repro/policy/envelope.py`` (``math`` only);
``tests/test_torch_policy.py`` holds it to the reference.

Two facts combine into the admissibility rule the autotuner uses:

1. **Per-codec floors** — the conformance matrix
   (``tests/test_lp_conformance.py``) gates every engine x codec cell at
   a documented single-forward-pass PSNR floor on N(0,1) latents.  Those
   floors ARE the envelope: they are the worst-case reconstruction
   quality a codec is allowed to deliver, enforced in CI for every
   engine, so the planner can rely on them without profiling.

2. **Sigma credit** — a quantization error injected while the latent is
   still mostly noise is cheaper than the same error near the end of the
   trajectory.  Early high-noise forward passes see a z that is sigma
   parts noise; the denoiser re-estimates from the perturbed latent at
   every subsequent step, so per-step wire error at noise level sigma is
   attenuated before it reaches z_0, while tail-step error (sigma -> 0)
   lands on the output unlaundered.  We model the relaxation as linear
   in sigma: a segment whose smallest sigma is s may use a codec whose
   floor is up to ``HIGH_NOISE_CREDIT_DB * s`` dB below the requested
   end-to-end floor.  The constant is calibrated against measured
   end-to-end PSNR of scheduled runs on the reduced WAN DiT
   (``benchmarks/codec_schedule.py`` gates the result at >= 40 dB), and
   deliberately conservative: at sigma = 0 the credit vanishes, so the
   tail segment must meet the requested floor outright.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple

#: Conformance-matrix floors (dB), single forward pass vs the fp32 psum
#: reference — the reference's ``tests/test_lp_conformance`` gates its
#: engines at these floors.
PSNR_ENVELOPE_DB = {
    "fp32": math.inf,
    "bf16": 50.0,
    "int8": 40.0,
    "int8-residual": 40.0,
    "int4": 24.0,
    "int4-residual": 24.0,
    # Displaced halo (``comm/wire.py``): the exchange blends one-step-
    # stale slabs through the residual EF carry, so per-step error is a
    # full Euler increment of the boundary rows — staleness dominates
    # quantization, which is why the int8/int4 variants sit within 2 dB
    # of each other and FAR below their synchronous bases.  Calibrated
    # against multi-step scheduled runs (tests/test_wire_codec.py): a
    # fully-displaced 6-step denoise measures ~17 dB with min sigma
    # ~0.17, bounding the int8 floor at 14; prefix schedules confined
    # to sigma >= 0.75 recover 40+ dB, which the sigma credit predicts.
    # The planner therefore only admits displaced segments where the
    # credit is large (early, noise-dominated steps).
    "displaced:int8-residual": 14.0,
    "displaced:int4-residual": 12.0,
}

#: dB of floor a segment may give back per unit of (minimum) sigma.
HIGH_NOISE_CREDIT_DB = 20.0


def codec_floor_db(name: str) -> float:
    """Envelope floor of one codec (KeyError on unknown names is a bug
    guard: a codec without a conformance floor cannot be scheduled)."""
    try:
        return PSNR_ENVELOPE_DB[name]
    except KeyError:
        raise ValueError(
            f"codec {name!r} has no conformance-envelope floor; know "
            f"{sorted(PSNR_ENVELOPE_DB)}"
        ) from None


def effective_floor_db(
    name: str,
    sigma_min: float,
    credit_db: float = HIGH_NOISE_CREDIT_DB,
) -> float:
    """Envelope floor of ``name`` credited for running at noise level
    >= ``sigma_min``: the quality the codec is good for *end to end*
    when every step it covers still carries that much noise."""
    return codec_floor_db(name) + credit_db * max(float(sigma_min), 0.0)


def admissible_codecs(
    psnr_floor_db: float,
    sigma_min: float,
    names: Iterable[str] = None,
    credit_db: float = HIGH_NOISE_CREDIT_DB,
) -> Tuple[str, ...]:
    """Codecs whose credited floor meets ``psnr_floor_db`` at
    ``sigma_min`` (candidate set for one schedule segment)."""
    if names is None:
        names = PSNR_ENVELOPE_DB.keys()
    return tuple(
        n for n in names
        if effective_floor_db(n, sigma_min, credit_db) >= psnr_floor_db
    )


def schedule_envelope_db(
    step_codecs: Sequence[str],
    sigmas: Sequence[float],
    credit_db: float = HIGH_NOISE_CREDIT_DB,
) -> float:
    """Conservative end-to-end envelope of a resolved schedule: the
    minimum credited floor over steps (the worst step bounds the run).

    ``step_codecs[i]`` is the codec of forward pass ``i+1``;
    ``sigmas[i]`` the noise level that pass runs at.
    """
    if len(step_codecs) != len(sigmas):
        raise ValueError(
            f"{len(step_codecs)} step codecs vs {len(sigmas)} sigmas"
        )
    if not step_codecs:
        raise ValueError("empty schedule has no envelope")
    return min(
        effective_floor_db(c, s, credit_db)
        for c, s in zip(step_codecs, sigmas)
    )
