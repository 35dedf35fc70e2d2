"""Analytic communication-overhead model (paper §7 + SPMD variants).

A copy of ``repro/core/comm_model.py`` (numpy only), its lazy imports
pointed at the port's ``distributed.collectives`` and ``comm.codecs``;
``tests/test_torch_comm_model.py`` holds every public function to the
reference's numbers.  The port measures what these functions predict
with the byte-counting wrapper of ``distributed/collectives.py``
(``WireCounter``): its ``payload`` per collective kind is the
"HLO output-shape" accounting of the ``*_step_collectives`` functions,
its ``sent`` bytes summed over a group the ``comm_lp_*`` group totals.

Reproduces the paper's closed forms:

    C_NMP = 2 T (K-1) S_H                                   (Eq. 22)
    C_PP  = 2 T (K-1) S_H                                   (Eq. 23)
    C_LP  = 4 T sum_{k>=2} S_sub^(k)                        (Eq. 27)
    R     ~ 2 gamma(r,K) / K * (S_z / S_H)                  (Eq. 31)
    C_hyb ~ 2 T S_H' (K - M)                                (Eq. 53)

plus models the paper measures but does not derive (HP ~ tensor-parallel
collectives inside DiT blocks) and the TPU-SPMD LP variant (one ring
all-reduce of the weighted predictions per step; scatter is free because
the latent is replicated along the lp axis).

Everything returns **bytes**.  ``bytes_per_el`` defaults to 4 (the paper's
fp32 transfers; WAN2.1 inference moves fp32 latents/noise between devices).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .partition import plan_partition
from .schedule import rotation_dim, usable_dims


@dataclasses.dataclass(frozen=True)
class VDMCommConfig:
    """Workload geometry for the communication model."""

    latent_dims: Tuple[int, int, int]   # (T_lat, H_lat, W_lat)
    latent_channels: int                # C
    patch_sizes: Tuple[int, int, int]   # (p_T, p_H, p_W)
    d_model: int                        # DiT hidden width
    num_blocks: int                     # DiT depth
    text_len: int = 512                 # encoded prompt length (context)
    num_steps: int = 60                 # T (denoising iterations)
    cfg_passes: int = 2                 # conditional + unconditional
    bytes_per_el: int = 4               # fp32 on the wire (paper setup)

    @property
    def latent_elems(self) -> int:
        t, h, w = self.latent_dims
        return t * h * w * self.latent_channels

    @property
    def latent_bytes(self) -> int:
        """S_z."""
        return self.latent_elems * self.bytes_per_el

    @property
    def num_tokens(self) -> int:
        t, h, w = self.latent_dims
        pt, ph, pw = self.patch_sizes
        return (t // pt) * (h // ph) * (w // pw)

    @property
    def activation_bytes(self) -> int:
        """S_H: the hidden activation crossing a DiT block boundary."""
        return self.num_tokens * self.d_model * self.bytes_per_el


def comm_nmp(cfg: VDMCommConfig, K: int) -> int:
    """Eq. 22: every CFG pass crosses K-1 boundaries carrying S_H."""
    return cfg.cfg_passes * cfg.num_steps * (K - 1) * cfg.activation_bytes


def comm_pp(cfg: VDMCommConfig, K: int) -> int:
    """Eq. 23: pipelining overlaps transfers but moves the same bytes."""
    return comm_nmp(cfg, K)


def comm_tp(cfg: VDMCommConfig, K: int, collectives_per_block: int = 2) -> int:
    """Tensor-parallel (the paper's HP is FSDP+xDiT; TP collectives dominate).

    Per DiT block: ``collectives_per_block`` ring all-reduces of the hidden
    activation (attention out-proj + MLP down-proj).  Ring all-reduce wire
    bytes across the group = 2 (K-1) S per collective.
    """
    per_allreduce = 2 * (K - 1) * cfg.activation_bytes
    return (
        cfg.num_steps
        * cfg.cfg_passes
        * cfg.num_blocks
        * collectives_per_block
        * per_allreduce
    )


def comm_hp_xdit(cfg: VDMCommConfig, K: int) -> int:
    """The paper's HP baseline (WAN's FSDP + xDiT), calibrated.

    xDiT's patch-level pipelining (PipeFusion) communicates *latent-scale*
    tensors per step, not per-block activations.  Paper Table 1 fits
    ``3 * S_z`` per worker per step and ``7 * S_z`` for the master to
    <0.5% for both 49- and 81-frame settings (891.21 MB and 1439.65 MB per
    worker respectively); we adopt that empirical per-step accounting:

        C_HP = T * S_z * (7 + 3 * (K - 1))
    """
    return cfg.num_steps * cfg.latent_bytes * (7 + 3 * (K - 1))


def _sub_latent_bytes(cfg: VDMCommConfig, K: int, r: float, dim: int) -> Tuple[int, ...]:
    """S_sub^(k) for the paper-exact partition along ``dim``."""
    extent = cfg.latent_dims[dim]
    plan = plan_partition(extent, cfg.patch_sizes[dim], K, r, dim)
    other = cfg.latent_elems // extent
    return tuple(sz * other * cfg.bytes_per_el for sz in plan.sizes)


def comm_lp_hub(
    cfg: VDMCommConfig,
    K: int,
    r: float,
    scatter_gather_factor: int = 2,
) -> int:
    """Eq. 27 with the true rotating geometry (exact, not the Eq. 28 approx).

    Master scatters K-1 sub-latents and gathers K-1 predictions; the paper
    multiplies by 2 for the CFG passes (``scatter_gather_factor``).  Each
    step's S_sub depends on the rotation dimension, so we sum the actual
    schedule rather than assuming balance.
    """
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, K)
    total = 0
    for i in range(1, cfg.num_steps + 1):
        dim = rotation_dim(i, dims)
        subs = _sub_latent_bytes(cfg, K, r, dim)
        step = 2 * sum(subs[1:])  # scatter + gather, workers only (Eq. 26)
        total += scatter_gather_factor * step
    return total


def comm_lp_measured(cfg: VDMCommConfig, K: int, r: float) -> int:
    """LP as the paper's system *measures* it (Table 1 per-GPU accounting).

    The implementation batches the CFG passes on-device, so sub-latents are
    scattered once and predictions gathered once per step.  Workers tally
    send+recv (2 * S_sub each); the master row tallies its sends only
    (sum_{k>=2} S_sub).  Total = 3 * T * sum_{k>=2} S_sub, which matches
    Table 1 to a few percent for both r=0.5 and r=1.0 (the paper's Eq. 26
    theory doubles this by charging CFG twice).
    """
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, K)
    total = 0
    for i in range(1, cfg.num_steps + 1):
        dim = rotation_dim(i, dims)
        subs = _sub_latent_bytes(cfg, K, r, dim)
        total += 3 * sum(subs[1:])
    return total


def comm_lp_spmd(cfg: VDMCommConfig, K: int, r: float) -> int:
    """TPU-SPMD LP: latent replicated on the lp axis => scatter is local.

    Reconstruction = one ring all-reduce of the (weight-masked, scattered)
    prediction buffer of size S_z per step; CFG is combined locally before
    the reduce, so the factor-2 of Eq. 26 disappears.  Wire bytes per step
    across the group = 2 (K-1)/K * S_z * K = 2 (K-1) S_z.
    """
    per_step = 2 * (K - 1) * cfg.latent_bytes
    return cfg.num_steps * per_step


def _halo_plan(cfg: VDMCommConfig, K: int, r: float, dim: int):
    from .uniform import plan_uniform

    return plan_uniform(cfg.latent_dims[dim], cfg.patch_sizes[dim], K, r, dim)


def _row_bytes(cfg: VDMCommConfig, dim: int) -> int:
    """Bytes of one latent-unit slab orthogonal to ``dim``."""
    return (cfg.latent_elems // cfg.latent_dims[dim]) * cfg.bytes_per_el


def lp_halo_step_collectives(
    cfg: VDMCommConfig, K: int, r: float, dim: int
) -> dict:
    """Per-device collective payloads of ONE halo LP step along ``dim``.

    Accounted the way ``analysis/hlo_analyzer.py`` measures compiled HLO:
    each collective contributes its **output shape** bytes.  The halo step
    lowers to one all-gather of the padded core slice — output is the
    gathered (K, core_pad) stack — plus one collective-permute per
    transfer round with a slab-shaped output.  Cross-checked against the
    dry-run HLO in tests/test_fast_lp_step.py.
    """
    from repro_torch.distributed.collectives import halo_spec

    spec = halo_spec(_halo_plan(cfg, K, r, dim))
    row = _row_bytes(cfg, dim)
    return {
        "all-gather": K * spec.core_pad * row,
        "collective-permute": sum(t.length * row for t in spec.transfers),
    }


def comm_lp_halo(cfg: VDMCommConfig, K: int, r: float = 0.5) -> int:
    """Halo-exchange LP (``core/spmd.lp_forward_halo``): group wire bytes.

    Per step, reconstruction is (a) a ring all-gather of the padded core
    slices — every rank's core_pad shard crosses K-1 links — and (b) the
    ppermute halo rounds, where each scheduled (src, dst) pair moves one
    padded slab.  No buffer of size S_z ever crosses the wire:

        C_halo_step = K (K-1) core_pad row  +  sum_t |perm_t| len_t row

    vs the psum engine's ``2 (K-1) S_z`` (``comm_lp_spmd``).  The overlap
    slabs scale with O ~ r L ~ r D/K, so the advantage grows with K.
    """
    from repro_torch.distributed.collectives import halo_spec

    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, K)
    per_dim = {}
    for dim in dims:
        spec = halo_spec(_halo_plan(cfg, K, r, dim))
        row = _row_bytes(cfg, dim)
        ag = K * (K - 1) * spec.core_pad * row
        pp = sum(len(t.perm) * t.length * row for t in spec.transfers)
        per_dim[dim] = ag + pp
    return sum(
        per_dim[rotation_dim(i, dims)] for i in range(1, cfg.num_steps + 1)
    )


def lp_halo_codec_step_collectives(
    cfg: VDMCommConfig, K: int, r: float, dim: int, codec="int8"
) -> dict:
    """Per-device collective payloads of ONE codec'd halo LP step.

    Same HLO output-shape accounting as :func:`lp_halo_step_collectives`
    but through a ``comm.codecs`` codec: every ppermute round ships the
    coded slab (``codec.bits`` per element) plus its per-slab scale
    meta, and the core all-gather ships K coded core slices plus K
    scales.  Matches ``analysis/hlo_analyzer`` on the compiled HLO
    exactly (the codecs pin their wire dtype to the collectives).
    """
    from repro_torch.comm.codecs import get_codec
    from repro_torch.distributed.collectives import halo_spec

    codec = get_codec(codec)
    spec = halo_spec(_halo_plan(cfg, K, r, dim))
    row_el = cfg.latent_elems // cfg.latent_dims[dim]  # elems per latent row
    pp = sum(
        codec.wire_bytes(t.length * row_el) for t in spec.transfers
    )
    ag = K * codec.wire_bytes(spec.core_pad * row_el)
    return {"all-gather": ag, "collective-permute": pp}


def _halo_codec_group_bytes_per_dim(
    cfg: VDMCommConfig, K: int, r: float, codec
) -> dict:
    """Group wire bytes of ONE codec'd halo step, per rotation dim.

    The single per-dim formula every halo byte model composes: each
    rank's coded core slice (+ scale meta) crosses K-1 links in the
    ring all-gather, and each scheduled ppermute pair moves one coded
    slab (+ meta).  Shared by :func:`comm_lp_halo_codec` (fixed codec)
    and :func:`lp_halo_scheduled_segments` (per-step codecs) so the
    "scheduled == sum of fixed-codec steps" exact-match contract can
    never drift between the two.
    """
    from repro_torch.comm.codecs import get_codec
    from repro_torch.distributed.collectives import halo_spec

    codec = get_codec(codec)
    out = {}
    for dim in usable_dims(cfg.latent_dims, cfg.patch_sizes, K):
        spec = halo_spec(_halo_plan(cfg, K, r, dim))
        row_el = cfg.latent_elems // cfg.latent_dims[dim]
        ag = K * (K - 1) * codec.wire_bytes(spec.core_pad * row_el)
        pp = sum(
            len(t.perm) * codec.wire_bytes(t.length * row_el)
            for t in spec.transfers
        )
        out[dim] = ag + pp
    return out


def comm_lp_halo_codec(
    cfg: VDMCommConfig, K: int, r: float = 0.5, codec="int8"
) -> int:
    """Codec-compressed halo LP: group wire bytes over the full schedule.

    :func:`comm_lp_halo` with every payload squeezed through a wire
    codec (``core/spmd.lp_forward_halo(..., codec=...)``).  With int8
    this is ~4x below the fp32 halo path — and the residual variants
    spend the same bytes on a temporally-delta-coded payload, so the
    quality cost shrinks without moving more data.
    """
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, K)
    per_dim = _halo_codec_group_bytes_per_dim(cfg, K, r, codec)
    return sum(
        per_dim[rotation_dim(i, dims)] for i in range(1, cfg.num_steps + 1)
    )


def comm_lp_halo_scheduled(
    cfg: VDMCommConfig, K: int, r: float, step_codecs: Sequence[str]
) -> int:
    """Sigma-scheduled halo LP: group wire bytes over a per-step codec
    assignment.

    ``step_codecs[i]`` names the wire codec of forward pass ``i + 1``
    (the ``policy/`` layer resolves sigma thresholds against the
    sampler's trajectory; this model is deliberately sigma-blind).  The
    step count is ``len(step_codecs)`` — it overrides ``cfg.num_steps``
    so a resolved schedule can never silently disagree with the model.
    Each step moves exactly the bytes of the fixed-codec halo step on
    its rotation dim (:func:`comm_lp_halo_codec` per-dim terms): a
    segment boundary changes which codec encodes, not the message
    layout, so per-segment totals are sums of fixed-codec step bytes —
    the property the conformance suite and
    ``benchmarks/codec_schedule.py`` check against measured HLO.
    """
    return sum(
        seg["wire_bytes"] for seg in
        lp_halo_scheduled_segments(cfg, K, r, step_codecs)
    )


def lp_halo_scheduled_segments(
    cfg: VDMCommConfig, K: int, r: float, step_codecs: Sequence[str]
) -> Tuple[dict, ...]:
    """Per-segment byte breakdown of :func:`comm_lp_halo_scheduled`.

    One entry per contiguous same-codec step run: ``{"codec", "start",
    "stop", "wire_bytes", "per_dim"}`` with 1-indexed inclusive step
    bounds and ``per_dim`` the single-step group bytes per rotation dim
    (each must match the measured HLO of the fixed-codec engine
    exactly).
    """
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, K)
    per_dim_by_codec: dict = {}

    def per_dim(codec_name: str) -> dict:
        if codec_name not in per_dim_by_codec:
            per_dim_by_codec[codec_name] = \
                _halo_codec_group_bytes_per_dim(cfg, K, r, codec_name)
        return per_dim_by_codec[codec_name]

    segments = []
    for i, name in enumerate(step_codecs, start=1):
        if segments and segments[-1]["codec"] == name:
            segments[-1]["stop"] = i
            segments[-1]["wire_bytes"] += per_dim(name)[rotation_dim(i, dims)]
        else:
            segments.append({
                "codec": name, "start": i, "stop": i,
                "wire_bytes": per_dim(name)[rotation_dim(i, dims)],
                "per_dim": dict(per_dim(name)),
            })
    return tuple(segments)


def lp_halo_sharded_step_collectives(
    cfg: VDMCommConfig, M: int, T: int, r: float, dim: int, codec="fp32"
) -> dict:
    """Per-device collective payloads of ONE wire-sharded hybrid step.

    The hierarchy-aware wire (``core/hybrid.lp_forward_halo_hybrid(...,
    wire_shard=True)``): every coded payload is chunked T ways over the
    tp axis, each tp rank ships only its chunk across the group
    boundary, and one intra-group all-gather reassembles the message.
    Same HLO output-shape accounting as
    :func:`lp_halo_codec_step_collectives`, split into the two link
    tiers:

    * ``inter`` (lp-axis collectives, replica groups of size M): one
      collective-permute of the (ceil-padded) 1/T chunk + the full meta
      per transfer round, and the core all-gather of M chunks + M metas.
    * ``intra`` (tp-axis all-gathers, replica groups of size T): the
      (T, chunk) reassembly per transfer round and the (T, M, chunk)
      core reassembly.  The Phi_m all-reduce (TP psums) is charged to
      the intra-group model (``comm_tp``), never here.

    Per device, ``inter`` is ~1/T of the unsharded hybrid step (exact up
    to chunk ceil-padding and the T-replicated meta): the T-fold
    inter-group saving ``BENCH_wire_shard.json`` gates.
    """
    from repro_torch.comm.codecs import get_codec
    from repro_torch.distributed.collectives import halo_spec, wire_shard_len

    if T < 2:
        raise ValueError(f"wire sharding needs a tp axis of size >= 2, T={T}")
    codec = get_codec(codec)
    spec = halo_spec(_halo_plan(cfg, M, r, dim))
    row_el = cfg.latent_elems // cfg.latent_dims[dim]
    C = cfg.latent_channels
    db = codec.wire_dtype_bytes
    pp_inter = 0
    tp_intra = 0
    for t in spec.transfers:
        s = wire_shard_len(codec.wire_elems(t.length * row_el, C), T)
        pp_inter += s * db + codec.meta_bytes
        tp_intra += T * s * db
    s_core = wire_shard_len(codec.wire_elems(spec.core_pad * row_el, C), T)
    ag_inter = M * s_core * db + M * codec.meta_bytes
    tp_intra += T * M * s_core * db
    return {
        "inter": {"collective-permute": pp_inter, "all-gather": ag_inter},
        "intra": {"all-gather": tp_intra},
    }


def _halo_sharded_group_bytes_per_dim(
    cfg: VDMCommConfig, M: int, T: int, r: float, codec
) -> dict:
    """Group wire bytes of ONE wire-sharded hybrid step, per rotation
    dim, split by link tier.

    Ring accounting mirrors :func:`_halo_codec_group_bytes_per_dim`:
    every scheduled ppermute pair moves one chunk (+ full meta) on each
    of the T lp rings, each device's core chunk (+ meta) crosses M-1
    links of its lp ring, and each intra-group reassembly moves every
    contribution across T-1 links of its tp ring (M tp rings per mesh).
    """
    from repro_torch.comm.codecs import get_codec
    from repro_torch.distributed.collectives import halo_spec, wire_shard_len

    codec = get_codec(codec)
    C = cfg.latent_channels
    db = codec.wire_dtype_bytes
    out = {}
    for dim in usable_dims(cfg.latent_dims, cfg.patch_sizes, M):
        spec = halo_spec(_halo_plan(cfg, M, r, dim))
        row_el = cfg.latent_elems // cfg.latent_dims[dim]
        inter = intra = 0
        for t in spec.transfers:
            s = wire_shard_len(codec.wire_elems(t.length * row_el, C), T)
            inter += T * len(t.perm) * (s * db + codec.meta_bytes)
            intra += M * T * (T - 1) * s * db
        s_core = wire_shard_len(codec.wire_elems(spec.core_pad * row_el, C), T)
        inter += T * M * (M - 1) * (s_core * db + codec.meta_bytes)
        intra += M * T * (T - 1) * M * s_core * db
        out[dim] = (inter, intra)
    return out


def comm_lp_halo_sharded(
    cfg: VDMCommConfig,
    M: int,
    T: int,
    r: float = 0.5,
    codec="fp32",
    step_codecs: Optional[Sequence[str]] = None,
) -> dict:
    """Wire-sharded hybrid LP×TP halo engine: group wire bytes over the
    full denoise, split into ``{"inter", "intra", "total"}``.

    The T-fold contrast with :func:`comm_lp_halo_hybrid` (whose group
    bytes are ``T x`` the 1D model because every tp rank ships the full
    slab on its own lp ring): here the T rings carry disjoint 1/T
    chunks, so ``inter`` collapses back to ~the 1D model (+ T-replicated
    meta + ceil padding) and the delta moves to ``intra`` — the
    trade the two-tier autotuner prices with ``inter_gbps`` /
    ``intra_gbps``.  ``step_codecs`` (one codec name per forward pass,
    as in :func:`comm_lp_halo_scheduled`) overrides the fixed ``codec``
    and ``cfg.num_steps``.
    """
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, M)
    if step_codecs is None:
        step_codecs = [codec] * cfg.num_steps
    per_dim_by_codec: dict = {}

    def per_dim(name):
        key = name if isinstance(name, str) else name.name
        if key not in per_dim_by_codec:
            per_dim_by_codec[key] = _halo_sharded_group_bytes_per_dim(
                cfg, M, T, r, name)
        return per_dim_by_codec[key]

    inter = intra = 0
    for i, name in enumerate(step_codecs, start=1):
        a, b = per_dim(name)[rotation_dim(i, dims)]
        inter += a
        intra += b
    return {"inter": inter, "intra": intra, "total": inter + intra}


def lp_halo_wire_profile(
    cfg: VDMCommConfig,
    M: int,
    T: int,
    r: float,
    step_codecs: Sequence[str],
    wire_shard: bool = False,
) -> dict:
    """Per-device wire bytes of a whole denoise, split by link tier.

    The quantity the two-tier autotuner turns into wire *time*: on a
    torus the T lp rings (and the M tp rings) are disjoint physical
    links, so per-device bytes — not group aggregates — are the
    time-like measure.  Unsharded: the per-device step payloads are the
    1D codec'd halo model on every tier-1 (inter-group) link and the
    intra tier carries nothing of LP's.  Sharded: the per-device split
    of :func:`lp_halo_sharded_step_collectives`.

    Returns ``{"inter", "intra", "hidden"}``.  ``hidden`` is the
    displaced-halo tier: for a ``displaced:*`` step that is NOT the
    first of its (rotation-dim x codec) run, the step consumes the
    previous step's slabs already in the carry, so its inter-group
    collective-permute bytes overlap the local compute instead of
    gating the step — they are moved from ``inter`` (exposed) to
    ``hidden``.  First-of-run steps stay fully exposed (the dim-rotation
    flush forces them synchronous), and the core all-gather is always
    exposed (the step cannot finish without the fresh cores).  The HLO
    contract is over ``inter + hidden``: displaced mode changes WHEN
    bytes gate the step, never how many cross the wire — the compiled
    collectives are identical per collective per tier.
    """
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, M)
    cache: dict = {}

    def step(name, dim):
        key = (name if isinstance(name, str) else name.name, dim)
        if key not in cache:
            if wire_shard:
                d = lp_halo_sharded_step_collectives(cfg, M, T, r, dim,
                                                     codec=name)
                cache[key] = (d["inter"]["collective-permute"],
                              d["inter"]["all-gather"],
                              sum(d["intra"].values()))
            else:
                d = lp_halo_codec_step_collectives(cfg, M, r, dim,
                                                   codec=name)
                cache[key] = (d["collective-permute"], d["all-gather"], 0)
        return cache[key]

    inter = intra = hidden = 0
    prev_run = None
    for i, name in enumerate(step_codecs, start=1):
        key = name if isinstance(name, str) else name.name
        dim = rotation_dim(i, dims)
        pp, ag, b = step(name, dim)
        run = (dim, key)
        if key.startswith("displaced") and run == prev_run:
            hidden += pp          # slab ppermutes overlap the compute
            inter += ag
        else:
            inter += pp + ag      # first-of-run / synchronous: all exposed
        intra += b
        prev_run = run
    return {"inter": inter, "intra": intra, "hidden": hidden}


def lp_halo_hybrid_step_collectives(
    cfg: VDMCommConfig, M: int, T: int, r: float, dim: int, codec="fp32"
) -> dict:
    """Per-device collective payloads of ONE hybrid LP×TP halo step.

    On the 2D ``(lp=M, tp=T)`` mesh every LP collective names only the
    group axis, so each device's halo payloads are **identical to the 1D
    codec'd halo step over M partitions** — T-independent by
    construction.  This is the exact analytic-bytes contract the hybrid
    engine is tested against: the all-gather / collective-permute entries
    of the compiled 2D-mesh HLO (``analysis/hlo_analyzer`` accounting)
    must match these numbers exactly; any all-reduce in that HLO belongs
    to the intra-group Phi_m (TP psums) and is charged to the intra-group
    model (``comm_tp``), not to LP.
    """
    if T < 1:
        raise ValueError(f"tp size T={T} must be >= 1")
    return lp_halo_codec_step_collectives(cfg, M, r, dim, codec=codec)


def comm_lp_halo_hybrid(
    cfg: VDMCommConfig, M: int, T: int, r: float = 0.5, codec="fp32"
) -> int:
    """Hybrid LP×TP halo engine: group wire bytes over the full schedule.

    §11 composition on an ``(M, T)`` mesh
    (``core/hybrid.lp_forward_halo_hybrid``): the inter-group halo
    schedule runs once per tp rank — T parallel lp rings, each moving the
    1D codec'd halo bytes — so the group aggregate is ``T x
    comm_lp_halo_codec(M)`` while per-device bytes (and therefore wire
    *time* on a torus, where the T rings are disjoint physical links)
    stay exactly at the 1D model.  Intra-group Phi_m traffic (TP psums,
    CFG-pair gathers) is intentionally excluded: Phi_m is a black box
    whose cost is the caller's intra-group model (``comm_tp`` /
    ``comm_nmp`` on the sub-latent, cf. Eq. 50).
    """
    if T < 1:
        raise ValueError(f"tp size T={T} must be >= 1")
    return T * comm_lp_halo_codec(cfg, M, r, codec=codec)


def comm_lp_gspmd_codec(cfg: VDMCommConfig, K: int, r: float,
                        codec="int8") -> int:
    """GSPMD stacked engine with a wire codec: bytes are UNCHANGED.

    ``lp_forward_gspmd(..., codec=...)`` round-trips every window through
    the codec before the stacked reduce (value-faithful to a codec'd
    wire), but the reduce the partitioner emits still ships f32 — GSPMD
    has no reduce-then-decode hook.  Kept as an explicit model so
    benchmark tables can show WHY the halo family is the codec path:
    same quality cost as the codec'd halo engine, zero byte savings.
    """
    from repro_torch.comm.codecs import get_codec

    get_codec(codec)  # validate the name
    return comm_lp_spmd(cfg, K, r)


def collective_wire_bytes(kind: str, payload_bytes: float, K: int) -> float:
    """HLO output-shape payload -> ring wire bytes per device.

    ``hlo_analyzer`` reports collective payloads as output sizes; on a ring
    an all-reduce moves 2 (K-1)/K of its buffer per device, an all-gather
    (K-1)/K of its *gathered* output, and a collective-permute exactly its
    payload.  Used to reconcile measured HLO bytes with the analytic
    ``comm_lp_*`` wire models.
    """
    if kind == "all-reduce":
        return 2.0 * (K - 1) / K * payload_bytes
    if kind in ("all-gather", "reduce-scatter"):
        return (K - 1) / K * payload_bytes
    if kind == "collective-permute":
        return float(payload_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def comm_hybrid(
    cfg: VDMCommConfig,
    K: int,
    M: int,
    r: float,
    intra: str = "nmp",
    wire_shard: bool = False,
) -> int:
    """§11: inter-group LP across M groups + intra-group NMP/TP (Eq. 50).

    ``S_H'`` is the activation of a 1/M sub-latent.  Exact inter-group term
    (rotating geometry with M partitions) + intra-group term per group.

    ``wire_shard`` models the hierarchy-aware wire on the paper's hub
    topology: every inter-group sub-latent transfer is striped over the
    group's ``k_m`` members (each member's NIC carries 1/k_m, so the
    per-link inter bytes drop k_m-fold even though the group total
    crossing the boundary is unchanged — the hub ships each sub-latent
    once either way), and the intra-group total honestly charges the
    reassembly all-gather: each striped transfer's chunks cross k_m - 1
    intra links per member, adding ``(k_m - 1)/k_m x`` the inter term
    alongside the NMP/TP collectives.  This is the accounting
    ``benchmarks/table1_comm.py`` reports so wire-shard rows include
    the gather term instead of pretending the reassembly is free.
    """
    if K % M != 0:
        raise ValueError(f"K={K} must divide into M={M} groups")
    k_m = K // M
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, M)
    inter = 0
    for i in range(1, cfg.num_steps + 1):
        dim = rotation_dim(i, dims)
        subs = _sub_latent_bytes(cfg, M, r, dim)
        inter += 2 * 2 * sum(subs[1:])
    # Intra-group activation: tokens of the (average) extended sub-latent.
    gamma_tokens = 0.0
    for i in range(1, cfg.num_steps + 1):
        dim = rotation_dim(i, dims)
        subs = _sub_latent_bytes(cfg, M, r, dim)
        gamma_tokens += sum(subs) / (M * cfg.latent_bytes)
    gamma = gamma_tokens / cfg.num_steps
    act_sub = int(cfg.activation_bytes * gamma)
    if intra == "nmp":
        intra_total = M * cfg.cfg_passes * cfg.num_steps * (k_m - 1) * act_sub
    elif intra == "tp":
        intra_total = (
            M
            * cfg.num_steps
            * cfg.cfg_passes
            * cfg.num_blocks
            * 2
            * 2
            * (k_m - 1)
            * act_sub
        )
    else:
        raise ValueError(f"unknown intra-group strategy {intra!r}")
    if wire_shard and k_m > 1:
        # the reassembly gather: every striped inter transfer's chunks
        # cross k_m - 1 intra links per member before Phi_m can run
        intra_total += inter * (k_m - 1) // k_m
    return inter + intra_total


def gamma_factor(cfg: VDMCommConfig, K: int, r: float) -> float:
    """gamma(r, K) = S_ext / S_z averaged over the rotation (Eq. 19)."""
    dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, K)
    tot = 0.0
    for i in range(1, cfg.num_steps + 1):
        dim = rotation_dim(i, dims)
        tot += sum(_sub_latent_bytes(cfg, K, r, dim)) / cfg.latent_bytes
    return tot / cfg.num_steps


def reduction_vs_nmp(cfg: VDMCommConfig, K: int, r: float) -> float:
    """1 - C_LP / C_NMP (the paper's headline 'up to 97%')."""
    return 1.0 - comm_lp_hub(cfg, K, r) / comm_nmp(cfg, K)


def wan21_comm_config(
    num_frames: int,
    height: int = 480,
    width: int = 832,
    num_steps: int = 60,
    bytes_per_el: int = 4,
) -> VDMCommConfig:
    """WAN2.1-1.3B geometry (paper §5.1): VAE stride (4, 8, 8), C=16,
    patchify (1, 2, 2), d_model 1536, 30 DiT blocks."""
    t_lat = (num_frames - 1) // 4 + 1
    return VDMCommConfig(
        latent_dims=(t_lat, height // 8, width // 8),
        latent_channels=16,
        patch_sizes=(1, 2, 2),
        d_model=1536,
        num_blocks=30,
        num_steps=num_steps,
        bytes_per_el=bytes_per_el,
    )
