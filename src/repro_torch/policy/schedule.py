"""Sigma-scheduled wire codecs: the spec grammar and its resolution
against a sampler's sigma trajectory.  A copy of
``repro/policy/schedule.py`` (numpy only), its codec names checked by the
port's ``comm.codecs``; ``tests/test_torch_policy.py`` holds it to the
reference.

A schedule is an ordered list of **sigma-threshold segments**::

    int4-residual@0.85,int8-residual@0.45,bf16

reads "int4-residual while sigma >= 0.85, int8-residual while
sigma >= 0.45, bf16 for the rest (the tail)".  Thresholds must be
strictly decreasing and the last segment must be thresholdless so every
sigma is covered.  ``fp32`` (or a bare codec name with no thresholds)
is the degenerate single-segment schedule — fixed-codec behaviour.

Resolution is **trajectory-derived**: forward pass ``i`` (1-indexed)
runs at the sampler's ``sigma_i``, so the same spec maps to different
step ranges for different samplers / step counts / shifts — e.g. WAN's
shift=3 schedule spends half its steps above sigma 0.75, so a 0.85
threshold covers a third of the run rather than the naive 15%.
``segment_steps`` returns the contiguous per-codec step runs that
``core/lp_step.lp_denoise`` turns into segmented runs (one run per
dim-run x segment, residual state reset at each boundary).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np

#: Default sigma thresholds (see docs/step_policy.md): calibrated so the
#: WAN shift=3 trajectory splits roughly into thirds — high-noise head,
#: mid, and precision tail.
DEFAULT_S_HI = 0.85
DEFAULT_S_LO = 0.45


@dataclasses.dataclass(frozen=True)
class ScheduleSegment:
    """One spec segment: use ``codec`` while sigma >= ``sigma_lo``."""

    codec: str
    sigma_lo: float  # 0.0 for the tail segment


@dataclasses.dataclass(frozen=True)
class StepRun:
    """A resolved contiguous run of forward passes on one codec.
    ``start``/``stop`` are 1-indexed inclusive pass numbers."""

    codec: str
    start: int
    stop: int

    @property
    def num_steps(self) -> int:
        return self.stop - self.start + 1


@dataclasses.dataclass(frozen=True)
class CodecSchedule:
    """Validated sigma-threshold codec schedule."""

    segments: Tuple[ScheduleSegment, ...]

    def __post_init__(self):
        from repro_torch.comm.codecs import get_codec

        if not self.segments:
            raise ValueError("schedule needs at least one segment")
        if self.segments[-1].sigma_lo != 0.0:
            raise ValueError(
                "the last schedule segment must be thresholdless (it is "
                "the tail covering sigma down to 0)"
            )
        prev = 1.0  # sigma never exceeds 1: a larger threshold is a typo
        for seg in self.segments:
            get_codec(seg.codec)  # unknown names fail loudly here
            if not 0.0 <= seg.sigma_lo < prev:
                raise ValueError(
                    f"sigma thresholds must be strictly decreasing in "
                    f"[0, 1): got {[s.sigma_lo for s in self.segments]}"
                )
            prev = seg.sigma_lo

    # ------------------------------------------------------------ queries
    @property
    def spec(self) -> str:
        """Round-trippable spec string (``parse_schedule(s.spec) == s``)."""
        return ",".join(
            seg.codec if seg.sigma_lo == 0.0 else f"{seg.codec}@{seg.sigma_lo:g}"
            for seg in self.segments
        )

    @property
    def fixed_codec(self) -> Union[str, None]:
        """The codec name if this is a single-segment (fixed) schedule."""
        return self.segments[0].codec if len(self.segments) == 1 else None

    def codec_for_sigma(self, sigma: float) -> str:
        for seg in self.segments:
            if sigma >= seg.sigma_lo:
                return seg.codec
        return self.segments[-1].codec  # sigma < 0 never happens; guard

    def step_codecs(self, sigmas: Sequence[float]) -> Tuple[str, ...]:
        """Per-forward-pass codec names for a sigma trajectory
        (``sigmas[i]`` is the noise level of pass ``i+1``)."""
        return tuple(self.codec_for_sigma(float(s)) for s in sigmas)

    @classmethod
    def fixed(cls, codec: str) -> "CodecSchedule":
        return cls((ScheduleSegment(codec, 0.0),))


def parse_schedule(spec: Union[str, CodecSchedule, None]) -> CodecSchedule:
    """Parse a CLI spec (``codec[@sigma],...``) into a schedule.

    ``None`` means fp32 everywhere (the exact baseline), mirroring
    ``comm.codecs.get_codec(None)``.  A bare codec name is the fixed
    single-segment schedule of that codec.
    """
    if spec is None:
        return CodecSchedule.fixed("fp32")
    if isinstance(spec, CodecSchedule):
        return spec
    segments = []
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty schedule spec {spec!r}")
    for i, part in enumerate(parts):
        if "@" in part:
            codec, _, thr = part.partition("@")
            if i == len(parts) - 1:
                raise ValueError(
                    f"schedule spec {spec!r}: the last segment is the "
                    f"tail and must not carry a sigma threshold"
                )
            try:
                sigma_lo = float(thr)
            except ValueError:
                raise ValueError(
                    f"schedule spec {spec!r}: bad sigma threshold {thr!r}"
                ) from None
        else:
            codec, sigma_lo = part, 0.0
            if i != len(parts) - 1:
                raise ValueError(
                    f"schedule spec {spec!r}: only the tail segment may "
                    f"omit its sigma threshold"
                )
        segments.append(ScheduleSegment(codec.strip(), sigma_lo))
    return CodecSchedule(tuple(segments))


def trajectory_sigmas(sampler, num_steps: int) -> Tuple[float, ...]:
    """Per-forward-pass noise levels from the sampler.

    Flow-matching samplers expose ``sigmas()`` directly (pass ``i`` runs
    at ``sigmas()[i-1]``).  Timestep-indexed samplers (DDIM) fall back
    to the normalized conditioning timestep — monotone in noise level,
    which is all the threshold comparison needs.
    """
    if hasattr(sampler, "sigmas"):
        s = np.asarray(sampler.sigmas(), np.float64)
        if len(s) < num_steps:
            raise ValueError(
                f"sampler provides {len(s)} sigmas for {num_steps} steps"
            )
        return tuple(float(x) for x in s[:num_steps])
    tmax = max(float(sampler.timestep(i)) for i in range(1, num_steps + 1))
    return tuple(
        float(sampler.timestep(i)) / max(tmax, 1e-9)
        for i in range(1, num_steps + 1)
    )


def segment_steps(
    schedule: CodecSchedule, sigmas: Sequence[float]
) -> Tuple[StepRun, ...]:
    """Contiguous per-codec step runs of a resolved schedule.

    Adjacent spec segments that resolve to the same codec merge (one
    run, one residual state): ``num_segments`` for the compile-count
    contract (<= 3 x num_segments per denoise) is ``len()`` of this.
    """
    codecs = schedule.step_codecs(sigmas)
    runs = []
    for i, c in enumerate(codecs, start=1):
        if runs and runs[-1][0] == c:
            runs[-1][2] = i
        else:
            runs.append([c, i, i])
    return tuple(StepRun(c, lo, hi) for c, lo, hi in runs)
