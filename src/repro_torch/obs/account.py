"""Derived per-step wire accounting — replay ``comm_model``, don't probe.
A copy of ``repro/obs/account.py`` over the port's ``core/comm_model``.

Per-step wire bytes are *derived* by replaying the analytic byte model
against the geometry the engine actually executed.  ``core/comm_model``
equals what the port's byte counter
(``distributed/collectives.WireCounter``) measures per collective kind
and tier, exactly (the payloads below are its ``payload`` accounting, the
reference's HLO output-shape one), so the derived attribution is exact,
not an estimate: on a group, a rank's attribution of a step equals the
counter's payloads of that step on that rank, times the batch size.

The replay consumes a **geometry timeline** — ``[(from_step, K),
...]`` — recorded by the serving engine: one entry at batch start and
one per mid-request eviction (``shrink_hybrid_mesh`` replans change K
and therefore the rotation-dim sequence and halo plan of every later
step).  Step ``i`` is attributed under the geometry whose ``from_step``
is the largest one ``<= i`` — i.e. the geometry its *surviving*
execution used (snapshot-resumed retries re-run steps under the new
mesh; duplicated work from restarts is tracked by ``serve.restarts``,
not double-billed here).

All payloads are per-device, HLO output-shape accounted, per sample
(batch size 1) — the same basis as ``analysis/hlo_analyzer`` and the
``lp_halo_*`` models; records carry ``batch_size`` for scaling.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.comm_model import (
    VDMCommConfig,
    lp_halo_codec_step_collectives,
    lp_halo_sharded_step_collectives,
)
from repro_torch.core.schedule import rotation_dim, usable_dims

HALO_IMPLS = ("halo", "halo_hybrid")


def step_wire_attribution(
    cfg: VDMCommConfig,
    K: int,
    r: float,
    dim: int,
    codec: str,
    tp: int = 1,
    wire_shard: bool = False,
    lp_impl: str = "halo",
) -> Dict[str, Dict[str, float]]:
    """Per-device payload bytes of ONE step, split by link tier.

    Halo family: the unsharded wire puts every LP collective on the
    inter-group (lp-axis) tier — per-device payloads are T-independent
    (``lp_halo_hybrid_step_collectives``) — while ``wire_shard`` splits
    them per :func:`lp_halo_sharded_step_collectives`.  The psum-family
    engines (``shard_map`` at K=2, and ``uniform``/``gspmd``, whose
    partitioned reduce ships the full latent) are one all-reduce of the
    S_z buffer per step, output-shape accounted like the HLO analyzer
    reports it.
    """
    if lp_impl in HALO_IMPLS:
        if wire_shard and tp >= 2:
            return lp_halo_sharded_step_collectives(
                cfg, K, tp, r, dim, codec=codec)
        d = lp_halo_codec_step_collectives(cfg, K, r, dim, codec=codec)
        return {"inter": dict(d), "intra": {}}
    # psum family: one latent-sized all-reduce per step, codec-blind
    # (comm_lp_spmd / comm_lp_gspmd_codec: GSPMD has no
    # reduce-then-decode hook, so codecs never shrink these bytes).
    return {"inter": {"all-reduce": float(cfg.latent_bytes)}, "intra": {}}


def attribute_denoise_steps(
    cfg: VDMCommConfig,
    r: float,
    step_codecs: Sequence[str],
    geometry: Sequence[Tuple[int, int]],
    tp: int = 1,
    wire_shard: bool = False,
    lp_impl: str = "halo",
    links=None,
    batch_size: int = 1,
) -> List[dict]:
    """Replay the byte model over a whole denoise -> per-step records.

    ``geometry`` is the engine's timeline ``[(from_step, K), ...]``
    (ascending ``from_step``; first entry must cover step 1).  Each
    K-epoch re-derives ``usable_dims`` and restarts nothing else — the
    rotation index is the global step ``i``, exactly as ``lp_denoise``
    computes it after a replan.  ``links`` (a ``policy.autotune
    .LinkModel``) prices each step's predicted wire time.

    Displaced codecs (``displaced:*``): ``inter_bytes`` stays the TOTAL
    inter payload (HLO-matching — the collectives are identical), and
    ``hidden_bytes`` records the slab-ppermute portion that overlaps
    compute on every step that is not the first of its (dim x codec x
    K) run — the same run-boundary rule ``lp_denoise`` uses to flush
    the stale carry.  ``pred_wire_time_ms`` prices only the EXPOSED
    bytes (``inter - hidden``).  Non-displaced codecs get
    ``hidden_bytes = 0`` and identical records to before.
    """
    if not geometry or geometry[0][0] > 1:
        raise ValueError(f"geometry timeline must start at step 1: "
                         f"{geometry!r}")
    epochs = sorted(geometry, key=lambda g: g[0])
    records: List[dict] = []
    cache: Dict[tuple, dict] = {}
    prev_run = None
    for i, codec in enumerate(step_codecs, start=1):
        epoch_idx, K = 0, epochs[0][1]
        for j, (start, k) in enumerate(epochs):
            if start <= i:
                epoch_idx, K = j, k
        dims = usable_dims(cfg.latent_dims, cfg.patch_sizes, K)
        dim = rotation_dim(i, dims)
        key = (K, dim, codec)
        if key not in cache:
            cache[key] = step_wire_attribution(
                cfg, K, r, dim, codec, tp=tp, wire_shard=wire_shard,
                lp_impl=lp_impl)
        tiers = cache[key]
        inter_b = float(sum(tiers.get("inter", {}).values()))
        intra_b = float(sum(tiers.get("intra", {}).values()))
        hidden_b = 0.0
        if (str(codec).startswith("displaced") and prev_run == key
                and lp_impl in HALO_IMPLS):
            hidden_b = float(tiers.get("inter", {})
                             .get("collective-permute", 0.0))
        prev_run = key
        rec = {
            "step": i,
            "dim": dim,
            "codec": codec,
            "K": K,
            "tp": tp,
            "wire_shard": bool(wire_shard and tp >= 2
                               and lp_impl in HALO_IMPLS),
            "lp_impl": lp_impl,
            "plan_epoch": epoch_idx,
            "batch_size": batch_size,
            "inter": {k: float(v) for k, v in
                      tiers.get("inter", {}).items()},
            "intra": {k: float(v) for k, v in
                      tiers.get("intra", {}).items()},
            "inter_bytes": inter_b,
            "intra_bytes": intra_b,
            "hidden_bytes": hidden_b,
        }
        if links is not None:
            rec["pred_wire_time_ms"] = links.wire_time_ms(
                inter_b - hidden_b, intra_b)
        records.append(rec)
    return records


def tier_for_group_size(group_size: int, M: int, T: int) -> str:
    """Map an HLO replica-group size to a link tier.

    ``hlo_analyzer.collective_group_bytes`` keys payloads as
    ``"all-gather[g]"`` where ``g`` is the replica-group size: on an
    ``(lp=M, tp=T)`` mesh, lp-axis collectives have groups of size M
    (inter tier) and tp-axis collectives groups of size T (intra).
    When M == T the group size alone cannot disambiguate — callers get
    ``"ambiguous"`` and should pick M != T meshes for exact-diff tests.
    """
    if M != T:
        if group_size == M:
            return "inter"
        if group_size == T:
            return "intra"
    elif group_size == M:
        return "ambiguous"
    return "unknown"


def tiered_collectives(
    collective_group_bytes: Dict[str, float], M: int, T: int
) -> List[dict]:
    """Unify dryrun's ``collectives_by_group`` into the wire schema.

    ``{"all-gather[3]": bytes, ...}`` -> sorted records of
    ``{"collective", "group_size", "tier", "bytes"}`` — the same
    vocabulary :func:`step_wire_attribution` emits, so a dry-run HLO
    measurement is machine-diffable against the ``comm_model`` replay.
    """
    out: List[dict] = []
    for key, nbytes in collective_group_bytes.items():
        if "[" in key and key.endswith("]"):
            kind, g = key[:-1].split("[", 1)
            group_size = int(g)
        else:  # ungrouped (single-mesh-axis) collective
            kind, group_size = key, M
        out.append({
            "collective": kind,
            "group_size": group_size,
            "tier": tier_for_group_size(group_size, M, T),
            "bytes": float(nbytes),
        })
    out.sort(key=lambda r: (r["tier"], r["collective"], r["group_size"]))
    return out


def reconcile_segments(
    records: Sequence[dict],
    measured: Sequence[dict],
) -> List[dict]:
    """Predicted vs measured wall time per codec segment.

    ``records`` are per-step attribution rows (with
    ``pred_wire_time_ms``); ``measured`` are run-span rows ``{"start",
    "stop", "wall_s"}`` from the trace.  Returns one row per measured
    run with the summed prediction over its step range — the
    calibration feedback that tells the autotuner whether its
    ``LinkModel`` gbps defaults match the deployed links.

    A measured step with no attribution record (or a record without a
    ``pred_wire_time_ms``) is NOT silently reconciled as zero-cost
    wire: it is counted in the row's ``unattributed_steps``, and
    ``validate_trace`` fails a trace whose reconciliation carries a
    nonzero count — a hole in the attribution is a bug in the feeder,
    not free bytes.
    """
    by_step = {r["step"]: r for r in records}
    out = []
    for m in measured:
        steps = range(int(m["start"]), int(m["stop"]) + 1)
        pred = 0.0
        unattributed = 0
        for s in steps:
            rec = by_step.get(s)
            if rec is None or "pred_wire_time_ms" not in rec:
                unattributed += 1
            else:
                pred += rec["pred_wire_time_ms"]
        row = {
            "start": int(m["start"]),
            "stop": int(m["stop"]),
            "codec": m.get("codec"),
            "dim": m.get("dim"),
            "measured_wall_ms": float(m["wall_s"]) * 1e3,
            "pred_wire_time_ms": pred,
            "unattributed_steps": unattributed,
        }
        if pred > 0 and not unattributed:
            row["measured_over_pred"] = row["measured_wall_ms"] / pred
        out.append(row)
    return out
