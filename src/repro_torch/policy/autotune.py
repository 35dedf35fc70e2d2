"""Cost-model-driven plan autotuning: pick (engine, codec schedule) by
minimizing analytic wire bytes subject to a PSNR floor.  A copy of
``repro/policy/autotune.py`` over the port's ``core/comm_model`` (itself a
copy) and ``core/schedule.usable_dims``; ``tests/test_torch_policy.py``
holds every plan field to the reference's.  On a mesh every rank resolves
the same plan from the same inputs (the function is deterministic), and
the serving engine checks that they agree.

The search space is small and the cost model is exact, so this is a
closed-form walk rather than a search:

1. Rank candidate codecs by their fixed-codec per-denoise wire bytes
   (``comm_model.comm_lp_halo_codec`` — bits dominate, residual variants
   tie with their base and win the tie on measured quality).
2. For each codec, the envelope gives the *lowest sigma it is admissible
   at* for the requested floor: ``(floor - codec_floor) / credit``
   (``policy/envelope``).  The byte-minimal schedule is then "cheapest
   admissible codec at every sigma", which is exactly a stack of
   sigma-threshold segments — cheaper codecs on top (high noise),
   precision codecs at the tail.
3. Resolve the schedule against the sampler's sigma trajectory and
   charge it with ``comm_model.comm_lp_halo_scheduled``; if the psum
   engine's fp32 bytes (``comm_lp_spmd``) undercut the scheduled halo
   bytes (short schedules at K=2 with a strict floor), the plan keeps
   the psum engine instead — the same break-even rule
   ``core/spmd.select_lp_impl`` hardcodes, now derived per request.
4. On hybrid ``(M, T)`` meshes, price the two link tiers separately
   (:class:`LinkModel`: ``inter_gbps`` for the slow inter-group links,
   ``intra_gbps`` for the fast intra-group fabric) and rank the
   wire-shard choice by **weighted wire time**, not raw bytes: sharding
   the halo wire over the tp axis cuts inter-group bytes T-fold but
   adds an intra-group reassembly gather
   (``comm_model.lp_halo_wire_profile``), so it wins exactly when the
   inter links are the binding constraint — at T=4 with the default
   10:1 ratio the sharded wire dominates every unsharded plan, while
   equal-bandwidth links flip the decision back (the reassembly gather
   then costs more than the inter saving).
5. ``displaced:*`` candidates (stale-slab halo, ``comm/wire.py``) tie
   their residual bases on bytes but zero out the slab-ppermute term of
   the EXPOSED wire profile (``lp_halo_wire_profile``'s ``hidden``
   tier), so the ranking schedules them wherever the envelope's sigma
   credit admits the staleness floor — trading quality headroom at the
   noise-dominated head for wire time the compute can hide.  They are
   only offered on single-rotation-dim geometries (a dim switch forces
   a synchronous first step, so length-1 runs hide nothing) and pin the
   plan to the halo family (psum/gspmd keep no slab carry).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core import comm_model as cm
from repro_torch.core.schedule import usable_dims

from .envelope import (
    HIGH_NOISE_CREDIT_DB,
    codec_floor_db,
    schedule_envelope_db,
)
from .schedule import (
    CodecSchedule,
    ScheduleSegment,
    StepRun,
    parse_schedule,
    segment_steps,
    trajectory_sigmas,
)

#: Candidate codecs the planner may schedule, all conformance-gated.
#: The ``displaced:*`` variants move the same bytes as their residual
#: bases but hide the slab-ppermute portion behind compute (see
#: ``comm_model.lp_halo_wire_profile``'s ``hidden`` tier), at a steep
#: quality floor — the envelope's sigma credit confines them to the
#: high-noise head.  They are dropped on multi-rotation-dim geometries,
#: where every (dim x codec) run has length 1 and the mandatory
#: synchronous first step means nothing would ever be hidden.
DEFAULT_CANDIDATES = (
    "displaced:int4-residual", "displaced:int8-residual",
    "int4-residual", "int4", "int8-residual", "int8", "bf16", "fp32",
)


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Two-tier link bandwidths (GB/s per device) for the weighted
    wire-time ranking.

    ``inter_gbps`` prices the inter-group links the lp-axis collectives
    cross (DCN / inter-host ICI — the binding constraint the paper and
    DualParal identify); ``intra_gbps`` the intra-group fabric the tp
    reassembly gathers ride (NVLink / same-host ICI).  The default 10:1
    ratio is the conventional fast-fabric : network gap; operators
    should calibrate both to their topology.
    """

    inter_gbps: float = 25.0
    intra_gbps: float = 250.0

    def wire_time_ms(self, inter_bytes: float, intra_bytes: float) -> float:
        """Per-device wire time of (inter, intra) bytes, milliseconds."""
        return (inter_bytes / (self.inter_gbps * 1e9)
                + intra_bytes / (self.intra_gbps * 1e9)) * 1e3


DEFAULT_LINKS = LinkModel()


@dataclasses.dataclass(frozen=True)
class StepPolicyPlan:
    """One denoise's resolved policy: engine + codec schedule + the
    analytic bytes that justified it."""

    lp_impl: str                        # halo | halo_hybrid | shard_map
    schedule: CodecSchedule
    step_codecs: Tuple[str, ...]        # resolved, one per forward pass
    segments: Tuple[StepRun, ...]       # contiguous same-codec step runs
    wire_bytes: int                     # analytic bytes of this plan
    fp32_halo_bytes: int                # fp32 halo baseline, same steps
    psum_bytes: int                     # fp32 psum engine, same steps
    psnr_floor_db: Optional[float]      # the constraint (None = unchecked)
    envelope_db: float                  # conservative schedule envelope
    # two-tier wire profile (hybrid meshes; zeros when tp == 1):
    wire_shard: bool = False            # shard the halo wire over tp
    inter_bytes: int = 0                # per-device EXPOSED inter bytes
    intra_bytes: int = 0                # per-device intra-group LP bytes
    wire_time_ms: float = 0.0           # weighted two-tier wire time
    # displaced-halo slab ppermutes that overlap compute instead of
    # gating the step (``lp_halo_wire_profile``'s hidden tier); the
    # compiled HLO still moves inter_bytes + hidden_bytes on the inter
    # links, but wire_time_ms prices only the exposed portion
    hidden_bytes: int = 0

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def reduction_vs_fp32_halo(self) -> float:
        return self.fp32_halo_bytes / max(self.wire_bytes, 1)

    def describe(self) -> str:
        segs = " ".join(
            f"{s.codec}[{s.start}..{s.stop}]" for s in self.segments
        )
        shard = " wire_shard" if self.wire_shard else ""
        hidden = (f", {self.hidden_bytes} B hidden"
                  if self.hidden_bytes else "")
        return (
            f"{self.lp_impl}{shard} schedule={self.schedule.spec} -> {segs} "
            f"({self.reduction_vs_fp32_halo:.2f}x vs fp32 halo, "
            f"envelope {self.envelope_db:.0f} dB{hidden})"
        )


def _rank_candidates(
    cfg: cm.VDMCommConfig, K: int, r: float, names: Sequence[str]
) -> Tuple[str, ...]:
    """Cheapest-first by fixed-codec denoise bytes; displaced variants
    win byte ties over their bases (same wire layout, strictly less
    EXPOSED wire time — and sorting them first is what lets the
    sigma-threshold stacker give them the high-noise head while the
    synchronous base covers the range below), then residual variants
    over plain (same layout, strictly better measured PSNR)."""
    def key(name):
        return (
            cm.comm_lp_halo_codec(cfg, K, r, name),
            0 if name.startswith("displaced") else 1,
            0 if name.endswith("-residual") else 1,
            -codec_floor_db(name),
        )
    return tuple(sorted(names, key=key))


def schedule_for_floor(
    cfg: cm.VDMCommConfig,
    K: int,
    r: float,
    psnr_floor_db: float,
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    credit_db: float = HIGH_NOISE_CREDIT_DB,
) -> CodecSchedule:
    """Byte-minimal sigma-threshold schedule meeting the floor.

    Each candidate is admissible down to sigma = (floor - codec_floor)
    / credit; stacking candidates cheapest-first yields the optimal
    segments directly (per-step byte costs are additive and the
    admissible set only shrinks as sigma falls).
    """
    segments = []
    covered_down_to = float("inf")
    for name in _rank_candidates(cfg, K, r, candidates):
        floor = codec_floor_db(name)
        if floor >= psnr_floor_db:
            adm = 0.0
        else:
            adm = (psnr_floor_db - floor) / credit_db
        if adm >= min(covered_down_to, 1.0):
            continue  # a cheaper codec already covers every sigma <= 1
        segments.append(ScheduleSegment(name, adm))
        covered_down_to = adm
        if adm == 0.0:
            break
    if not segments or segments[-1].sigma_lo != 0.0:
        raise ValueError(
            f"no candidate codec meets psnr_floor={psnr_floor_db} dB at "
            f"the tail (envelope tops out below the floor): {candidates}"
        )
    return CodecSchedule(tuple(segments))


def _plan_from_schedule(
    cfg: cm.VDMCommConfig,
    K: int,
    r: float,
    schedule: CodecSchedule,
    sigmas: Sequence[float],
    tp: int,
    psnr_floor_db: Optional[float],
    credit_db: float,
    allow_engine_flip: bool = True,
    links: LinkModel = DEFAULT_LINKS,
    wire_shard: Optional[bool] = None,
) -> StepPolicyPlan:
    from repro_torch.core.spmd import select_lp_impl

    num_steps = len(sigmas)
    step_codecs = schedule.step_codecs(sigmas)
    segments = segment_steps(schedule, sigmas)
    displaced = any(str(c).startswith("displaced") for c in step_codecs)
    wire = cm.comm_lp_halo_scheduled(cfg, K, r, step_codecs)
    fp32_halo = cm.comm_lp_halo_scheduled(cfg, K, r, ("fp32",) * num_steps)
    cfg_t = dataclasses.replace(cfg, num_steps=num_steps)
    psum = cm.comm_lp_spmd(cfg_t, K, r)
    envelope = schedule_envelope_db(step_codecs, sigmas, credit_db)
    if set(step_codecs) == {"fp32"}:
        # nothing to compress: fall back to the static break-even rule
        lp_impl = select_lp_impl(K, tp)
        if lp_impl == "shard_map":
            wire = psum
    elif allow_engine_flip and psum < wire and tp == 1 and not displaced:
        # (``not displaced``: a displaced schedule was chosen to HIDE
        # wire time behind compute — a raw-bytes comparison against the
        # psum ring would discard exactly that, and the psum engine has
        # no carry-resident slab state to run it on anyway)
        # a strict floor shrank the compressible range enough that the
        # psum engine's fp32 ring beats the codec'd halo schedule.
        # Auto plans only: an explicit operator schedule is a pin, not
        # a suggestion — silently swapping it for fp32/psum would drop
        # the codecs the operator asked for.
        lp_impl = "shard_map"
        schedule = CodecSchedule.fixed("fp32")
        step_codecs = ("fp32",) * num_steps
        segments = segment_steps(schedule, sigmas)
        wire = psum
        envelope = float("inf")
    else:
        lp_impl = "halo_hybrid" if tp > 1 else "halo"
    if displaced and lp_impl not in ("halo", "halo_hybrid"):
        raise ValueError(
            f"schedule {schedule.spec!r} uses a displaced halo codec, "
            f"which needs carry-resident slab state — the {lp_impl!r} "
            "engine keeps none (psum/gspmd family)"
        )
    # two-tier wire profile + the wire-shard decision (weighted TIME,
    # not bytes: sharding trades inter-group bytes for an intra-group
    # reassembly gather, and only the link ratio says which wins).  The
    # profile's ``inter`` is the EXPOSED portion — displaced steps'
    # hidden slab ppermutes are priced at zero, which is exactly how
    # displaced wins the ranking without moving fewer bytes.
    ws = False
    inter = intra = hidden = 0
    if lp_impl == "halo_hybrid" and tp > 1:
        prof_off = cm.lp_halo_wire_profile(cfg, K, tp, r, step_codecs,
                                           wire_shard=False)
        prof_on = cm.lp_halo_wire_profile(cfg, K, tp, r, step_codecs,
                                          wire_shard=True)
        t_off = links.wire_time_ms(prof_off["inter"], prof_off["intra"])
        t_on = links.wire_time_ms(prof_on["inter"], prof_on["intra"])
        ws = (t_on < t_off) if wire_shard is None else bool(wire_shard)
        prof = prof_on if ws else prof_off
        inter, intra, hidden = prof["inter"], prof["intra"], prof["hidden"]
    elif lp_impl == "halo":
        prof = cm.lp_halo_wire_profile(cfg, K, 1, r, step_codecs,
                                       wire_shard=False)
        inter, hidden = prof["inter"], prof["hidden"]
    else:  # shard_map: the psum ring, per device
        inter = psum // K
    return StepPolicyPlan(
        lp_impl=lp_impl,
        schedule=schedule,
        step_codecs=tuple(step_codecs),
        segments=segments,
        wire_bytes=int(wire),
        fp32_halo_bytes=int(fp32_halo),
        psum_bytes=int(psum),
        psnr_floor_db=psnr_floor_db,
        envelope_db=envelope,
        wire_shard=ws,
        inter_bytes=int(inter),
        intra_bytes=int(intra),
        wire_time_ms=links.wire_time_ms(inter, intra),
        hidden_bytes=int(hidden),
    )


def auto_plan(
    cfg: cm.VDMCommConfig,
    K: int,
    r: float,
    sampler,
    num_steps: int,
    psnr_floor_db: float = 40.0,
    tp: int = 1,
    candidates: Sequence[str] = DEFAULT_CANDIDATES,
    credit_db: float = HIGH_NOISE_CREDIT_DB,
    links: LinkModel = DEFAULT_LINKS,
    wire_shard: Optional[bool] = None,
    recorder=None,
) -> StepPolicyPlan:
    """The auto-plan: byte-minimal (engine, codec schedule) meeting the
    PSNR floor on this workload geometry and sigma trajectory.  On
    hybrid meshes (``tp > 1``) the wire-shard decision is made by
    weighted wire time under ``links`` (``wire_shard=None``); pass a
    bool to pin it.

    ``recorder`` (``repro_torch.obs.FlightRecorder``, optional) gets the
    chosen plan plus the autotuner's ranked candidate field — cheapest
    first, each priced by its fixed-codec denoise bytes — so a trace
    shows not just what was picked but what it beat."""
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, K)
    if not dims:
        raise ValueError(
            f"no latent dim of {cfg.latent_dims} has >= {K} patches"
        )
    if len(dims) > 1:
        # the dim rotation re-inits wire state every step here, so every
        # (dim x codec) run has length 1 and its mandatory synchronous
        # first step is the WHOLE run: displaced would hide zero bytes
        # while still paying the staleness floor — never worth offering
        candidates = tuple(
            c for c in candidates if not str(c).startswith("displaced")
        )
    sigmas = trajectory_sigmas(sampler, num_steps)
    schedule = schedule_for_floor(cfg, K, r, psnr_floor_db, candidates,
                                  credit_db)
    plan = _plan_from_schedule(cfg, K, r, schedule, sigmas, tp,
                               psnr_floor_db, credit_db, links=links,
                               wire_shard=wire_shard)
    if recorder is not None:
        ranked = [
            {"codec": name,
             "denoise_bytes": int(cm.comm_lp_halo_codec(cfg, K, r, name)),
             "floor_db": float(codec_floor_db(name))}
            for name in _rank_candidates(cfg, K, r, candidates)
        ]
        recorder.record_plan(plan, candidates=ranked, context="auto")
    return plan


def resolve_cli_schedule(
    spec: Union[str, CodecSchedule, None],
    cfg: cm.VDMCommConfig,
    K: int,
    r: float,
    sampler,
    num_steps: int,
    psnr_floor_db: Optional[float] = None,
    tp: int = 1,
    links: LinkModel = DEFAULT_LINKS,
    wire_shard: Optional[bool] = None,
    recorder=None,
) -> StepPolicyPlan:
    """Shared ``--codec-schedule`` resolution for serve/dryrun.

    ``"auto"`` runs :func:`auto_plan` (floor defaults to 40 dB, the
    serving-tolerance gate).  An explicit spec is parsed and charged;
    it is validated against the envelope only when the caller also
    passed a floor — an explicit spec is an operator override, but an
    explicit spec AND an explicit floor that contradict each other is
    a config error worth failing loudly on.  ``wire_shard`` follows the
    same convention: ``None`` lets the two-tier cost model decide on
    hybrid meshes, a bool pins the operator's choice.
    """
    if isinstance(spec, str) and spec.strip().lower() == "auto":
        return auto_plan(cfg, K, r, sampler, num_steps,
                         psnr_floor_db=40.0 if psnr_floor_db is None
                         else psnr_floor_db, tp=tp, links=links,
                         wire_shard=wire_shard, recorder=recorder)
    schedule = parse_schedule(spec)
    sigmas = trajectory_sigmas(sampler, num_steps)
    plan = _plan_from_schedule(cfg, K, r, schedule, sigmas, tp,
                               psnr_floor_db, HIGH_NOISE_CREDIT_DB,
                               allow_engine_flip=False, links=links,
                               wire_shard=wire_shard)
    if psnr_floor_db is not None and plan.envelope_db < psnr_floor_db:
        raise ValueError(
            f"schedule {schedule.spec!r} has envelope "
            f"{plan.envelope_db:.0f} dB < requested floor "
            f"{psnr_floor_db:.0f} dB (see docs/step_policy.md)"
        )
    if recorder is not None:
        # explicit spec: an operator pin, so there is no candidate field
        recorder.record_plan(plan, context="explicit")
    return plan
