"""LP video-generation serving engine: request queue -> geometry-batched
LP denoising -> latents out, on one GPU or on each rank of a group.

The subset of ``repro/serving/engine.py`` that the port serves:

  * bounded admission: ``submit`` raises :class:`QueueFull` beyond
    ``max_queue`` queued requests;
  * batching by ``(latent shape, guidance)``: a batch shares one guidance
    scale, and a launch happens when a bucket is full or the oldest
    request has waited ``max_wait_requests`` polls (``run`` drains);
  * one guided denoiser and one ``LPStepCompiler`` per engine, so the
    second batch of a geometry reuses every cached step entry;
  * recovery: a batch that raises a recoverable fault (``DeviceFailure``,
    ``runtime/faults.ServingFault``) retries from its last boundary
    snapshot, at most ``max_restarts_per_batch`` times;
  * group health and elastic re-planning: ``inject_fault`` scripts group
    deaths, stragglers and one-step wire corruption
    (``runtime/faults.ServingFaultPlan``); heartbeats feed a
    ``runtime/health.GroupHealthMonitor`` and, with ``elastic=True``, a
    proposed eviction re-plans the live compiler mid-request
    (``runtime/elastic.replan_lp_compiler``).

``lp_impl`` resolves to the name the reference reports
(``select_lp_impl``; a wire codec implies the halo family, the hybrid
one on a group with a tp axis).

``mesh`` binds the LP step to a group, as the reference's
``_build_forward`` does (``engine.py:491``); every rank builds the same
engine and submits the same requests.  An ``LPGroup``
(``launch/mesh.make_lp_group``) runs the halo engine
(``core/spmd.lp_forward_halo``, through the wire codec) or the psum engine
(``lp_forward_shard_map``).  A ``HybridGroup`` of ``(M, T)`` ranks
(``make_hybrid_group``) runs ``lp_impl="halo_hybrid"``, the body of
``core/hybrid.lp_forward_halo_hybrid`` (the halo engine, the name
reported): every rank runs the whole guided DiT on its LP group's window,
as the reference does, and the halo wire crosses the lp group, sharded
over the tp group with ``wire_shard``.
``wire_shard`` and ``eager_sends`` are tri-states resolved once the
engine family is final: on (None) on a tp mesh running the halo family,
off elsewhere; a pin that cannot be honoured raises.

Off a mesh the reference runs the halo wire mirror
(``comm/wire.simulate_halo_forward``) when ``lp_impl`` is a halo-family
engine and either a codec is active or halo was asked for by name
(``engine.py:426-437``), and the uniform vmapped engine otherwise; so
does this one.  ``wire_codec`` takes any name of
``comm.codecs.CODEC_NAMES``; ``wire_nan_guard`` (default on) arms the
per-message NaN/Inf decode guard.

Eviction across ranks: every rank holds the same fault plan and the same
heartbeats, so every rank reaches the same proposal in the same step
hook, which runs before any collective of its step.  The survivors make
a new lp group (``launch/mesh.shrink_hybrid_group``) and re-bind the
step; on the ranks of the evicted group ``run`` raises
``runtime/faults.GroupEvicted`` and they leave.  Times fed through
:meth:`LPServingEngine.observe_group_times` are agreed before the
monitor sees them (the reference's one controller reaches one verdict,
``engine.py:687-695``): each group's time is the MAX over the ranks (a
group is as slow as the slowest rank that saw it; a rank that saw no
report wins), by one all-reduce over the lp group and one over the tp
group, outside the byte counter.

Step policy (``engine.py:313-367``): ``codec_schedule`` takes an explicit
spec (``"int8-residual@0.85,int8@0.6,bf16"``) or ``"auto"``, resolved by
``policy.resolve_cli_schedule`` against the byte model of
``plan_geometry`` under ``psnr_floor``; ``lp_impl="auto"`` follows the
plan's engine, and a schedule implies the halo family, whose mirror (off a
mesh) or group-bound hooks (``forward_factory``, one per segment codec)
encode each step with its segment's codec.  ``wire_codec`` and
``codec_schedule`` together raise, as does ``psnr_floor`` without a
schedule.  On a mesh every rank resolves the plan and the ranks compare
its digest once; after an eviction each rank re-resolves it at the new K
in the step hook that evicts (the next batch runs it), and
:meth:`LPServingEngine.set_psnr_floor` re-resolves it at a new floor.

``recorder`` (``obs.FlightRecorder``): the ``request.enqueue`` /
``batch.admit`` / ``batch.denoise`` / ``request.lifecycle`` spans, the
``serve.*`` counters and histograms (``priority`` labels), the denoise
runs of ``lp_denoise``, the health monitor's metrics, and after each
batch the exact per-step wire attribution (``obs.account``) over the
batch's geometry and codec timelines, reconciled against the measured
runs.  On a mesh each rank records its own; its ``wire_steps`` are that
rank's payloads.  ``slo`` (``obs.slo.SLOSpec`` or its grammar) sets each
priority's deadline and counts ``serve.slo_violations`` live.

Fleet layer (``engine.py:189-245``): ``clock`` (default ``obs.clock.perf_s``)
stamps every lifecycle row (submit, admit, denoise start, done, failed);
``submit(req, submit_s=)`` lets an open-loop replay stamp the arrival
(``serving/loadgen.run_workload``).  A clock with ``advance`` (the
``loadgen.VirtualClock``) advances by each batch's synchronised wall.  On a
mesh that wall (also the one the batch reports) is the slowest rank's: the
ranks agree on it with a MAX all-reduce over the lp group (and one over the
tp group), through no byte counter, so every rank's virtual timeline, and
with it every admission and batching decision, stays the same; the default
clock adds no collective.  ``replica_id`` (set by
``serving/router.ReplicaRouter``) labels every ``serve.*`` metric, the
``request.enqueue`` / ``request.rejected`` / ``batch.restart`` instants and
the lifecycle rows with ``replica``; ``_inflight`` holds the batch in
flight, for the router to requeue when its replica dies.  The reference's ``lp_axis`` /
``tp_axis`` are not taken: a group has no axis names.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import defaultdict
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.codecs import get_codec
from repro_torch.configs.base import ArchConfig
from repro_torch.core import DenoiseSnapshot, LPStepCompiler, lp_denoise
from repro_torch.core.spmd import select_lp_impl
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.diffusion.pipeline import make_guided_step_denoiser
from repro_torch.diffusion.sampler import FlowMatchEuler
from repro_torch.distributed.collectives import HybridGroup, LPGroup, lp_axis, tp_size
from repro_torch.obs import metrics as obsm
from repro_torch.obs.clock import perf_s
from repro_torch.runtime.faults import (CorruptingCodec, GroupEvicted, ReplicaDeath,
                                        ServingFault, parse_fault_plan)
from repro_torch.runtime.ft import DeviceFailure
from repro_torch.runtime.health import GroupHealthMonitor


class QueueFull(RuntimeError):
    """``submit`` rejected a request: the queue is at ``max_queue``.  The
    request was not enqueued."""

    def __init__(self, msg: str, request_id: Optional[int] = None,
                 depth: Optional[int] = None):
        super().__init__(msg)
        self.request_id = request_id
        self.depth = depth


@dataclasses.dataclass
class VideoRequest:
    request_id: int
    context: torch.Tensor                # (1, L_ctx, ctx_dim) encoded prompt
    latent_shape: Tuple[int, int, int]   # (T_lat, H_lat, W_lat)
    seed: int = 0
    guidance: float = 5.0
    # the SLO class (its deadline through ``slo=``; labels its metrics) and
    # the quality floor it maps to, carried into the lifecycle rows; neither
    # enters the batching key
    priority: str = "standard"
    psnr_floor: Optional[float] = None


@dataclasses.dataclass
class VideoResult:
    request_id: int
    latent: torch.Tensor
    num_steps: int
    batch_wall_s: float     # the batch's wall: a request's denoise is batched
    batch_size: int
    restarts: int = 0
    resumed_from_step: int = 0
    queue_wait_s: float = 0.0
    e2e_s: float = 0.0


def initial_noise(shape: Tuple[int, ...], seed: int,
                  device: torch.device) -> torch.Tensor:
    """A request's z_T: standard normal f32 from a generator seeded with
    the request's seed, on ``device``."""
    return torch.randn(shape, generator=generator(seed, device), device=device,
                       dtype=torch.float32)


def plan_digest(plan) -> str:
    """sha256 of what a resolved step-policy plan decides: the engine, the
    spec, each step's codec and the wire-shard choice."""
    key = repr((plan.lp_impl, plan.schedule.spec, tuple(plan.step_codecs),
                bool(plan.wire_shard)))
    return hashlib.sha256(key.encode()).hexdigest()


def _agree(mesh, digest: str) -> None:
    """Every rank of ``mesh`` must hold the same plan: its digest gathered
    over the lp group and the tp group (not through the byte counter)."""
    groups = [lp_axis(mesh)] + ([mesh.tp] if isinstance(mesh, HybridGroup) else [])
    for g in groups:
        seen = [None] * g.size
        dist.all_gather_object(seen, digest, group=g.group)
        if len(set(seen)) != 1:
            raise RuntimeError(f"the ranks resolved different step-policy plans: digests "
                               f"{seen}; a plan must be a function of its inputs alone")


def _max_over_mesh(mesh, values: List[float]) -> List[float]:
    """Elementwise MAX of ``values`` over the ranks of ``mesh``: one f64
    all-reduce over the lp group, then one over the tp group of a 2-D mesh
    (not through the byte counter).  Every rank gets the same list."""
    lp = lp_axis(mesh)
    t = torch.tensor(values, dtype=torch.float64,
                     device=mesh.device if lp.backend == "nccl" else "cpu")
    for g in [lp] + ([mesh.tp] if isinstance(mesh, HybridGroup) else []):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g.group)
    return t.tolist()


def _slowest_wall(mesh, wall: float) -> float:
    """The batch's wall as its slowest rank measured it."""
    return _max_over_mesh(mesh, [wall])[0]


def _slowest_times(mesh, step_times) -> List[Optional[float]]:
    """Each LP group's step time as its slowest observer saw it: a missing
    time (``None``, NaN, +inf) goes in as +inf, so it wins the MAX, and
    comes back as ``None``, which the health monitor counts as a miss."""
    t = [math.inf if x is None or math.isnan(float(x)) else float(x) for x in step_times]
    return [None if x == math.inf else x for x in _max_over_mesh(mesh, t)]


class LPServingEngine:
    def __init__(
        self,
        dit: Callable,
        cfg: ArchConfig,
        num_partitions: int,
        overlap_ratio: float = 0.5,
        num_steps: int = 20,
        max_batch: int = 4,
        max_wait_requests: int = 8,
        max_queue: Optional[int] = None,
        uniform: bool = True,
        lp_impl: str = "auto",
        device: DeviceLike = None,
        mesh=None,
        wire_codec: Optional[str] = None,
        codec_schedule: Optional[str] = None,
        psnr_floor: Optional[float] = None,
        plan_geometry: Tuple[int, int, int] = (13, 60, 104),
        elastic: bool = False,
        inject_fault=None,
        recorder=None,
        slo=None,
        wire_nan_guard: bool = True,
        eager_sends: Optional[bool] = None,
        wire_shard: Optional[bool] = None,
        replica_id: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        if mesh is not None and not isinstance(mesh, (LPGroup, HybridGroup)):
            raise ValueError(f"mesh= takes an LPGroup or a HybridGroup "
                             f"(launch/mesh.make_lp_group), got {type(mesh).__name__}")
        if mesh is not None and lp_axis(mesh).size != num_partitions:
            raise ValueError(f"the lp group has {lp_axis(mesh).size} ranks, num_partitions="
                             f"{num_partitions}")
        if max_queue is not None and max_queue < max_batch:
            raise ValueError(f"max_queue={max_queue} < max_batch={max_batch}: "
                             "the queue could never fill a batch")
        self._fault_plan = parse_fault_plan(inject_fault)
        if self._fault_plan is not None and self._fault_plan.has_replica_targets:
            raise ValueError(
                f"fault plan {self._fault_plan.describe()!r} carries replica:-scoped targets, "
                "which a bare engine cannot interpret (it does not know which replica it "
                "is); serving/router.ReplicaRouter splits per-replica sub-plans")
        tp = tp_size(mesh)
        if wire_shard and tp <= 1:
            raise ValueError("wire_shard shards the halo wire over the tp axis; the mesh has "
                             "no tp axis (need --mesh MxT with T >= 2)")
        wire_shard_pinned = wire_shard is True
        self.recorder = recorder
        # fleet identity (the replica router sets it) and the lifecycle clock
        self.replica_id = replica_id
        self.clock: Callable[[], float] = clock if clock is not None else perf_s
        self.slo = None
        if slo is not None:
            from repro_torch.obs.slo import SLOSpec

            self.slo = SLOSpec.parse(slo)
        self.r = overlap_ratio
        self._sampler = FlowMatchEuler(num_steps)
        self.codec = get_codec(wire_codec)
        codec_active = self.codec.name not in ("fp32", "identity")
        # step policy: a schedule (explicit or "auto") replaces the fixed codec
        self.plan = None
        self.psnr_floor = psnr_floor
        self._plan_resolver: Optional[Callable] = None
        schedule = None
        if codec_schedule is not None:
            from repro_torch.core.comm_model import VDMCommConfig
            from repro_torch.policy import resolve_cli_schedule

            if codec_active:
                raise ValueError("pass wire_codec= (fixed) or codec_schedule= "
                                 "(sigma-scheduled), not both")
            ccfg = VDMCommConfig(latent_dims=tuple(plan_geometry),
                                 latent_channels=cfg.latent_channels,
                                 patch_sizes=cfg.patch_sizes, d_model=cfg.d_model,
                                 num_blocks=cfg.num_layers, num_steps=num_steps)
            wire_shard_cli = wire_shard

            def resolve(k):
                # re-invoked after an eviction (a new K) and by set_psnr_floor
                return resolve_cli_schedule(codec_schedule, ccfg, k, self.r, self._sampler,
                                            num_steps, psnr_floor_db=self.psnr_floor, tp=tp,
                                            wire_shard=wire_shard_cli, recorder=self.recorder)

            self._plan_resolver = resolve
            self.plan = resolve(num_partitions)
            if mesh is not None:
                _agree(mesh, plan_digest(self.plan))
            if lp_impl == "auto":
                lp_impl = self.plan.lp_impl
            if set(self.plan.step_codecs) != {"fp32"}:
                schedule = self.plan.schedule
            wire_shard = self.plan.wire_shard
        elif psnr_floor is not None:
            raise ValueError("psnr_floor needs codec_schedule")
        explicit_halo = lp_impl in ("halo", "halo_hybrid")
        if lp_impl == "auto":
            if codec_active:
                lp_impl = "halo_hybrid" if tp > 1 else "halo"
            else:
                lp_impl = select_lp_impl(num_partitions, tp)
        if (codec_active or schedule is not None) and lp_impl not in ("halo", "halo_hybrid"):
            what = (f"wire_codec={self.codec.name!r}" if codec_active
                    else f"codec_schedule={schedule.spec!r}")
            names = (list(self.plan.step_codecs) if self.plan is not None
                     else [self.codec.name])
            if any(str(n).startswith("displaced") for n in names):
                raise ValueError(
                    f"{what} uses a displaced halo codec, which needs carry-resident "
                    "slab state — only the halo family keeps one (the psum/gspmd "
                    f"engines have no per-direction slab carry); got lp_impl={lp_impl!r}")
            raise ValueError(f"{what} needs the halo family (the codec layer lives "
                             f"there), got lp_impl={lp_impl!r}")
        halo_family = lp_impl in ("halo", "halo_hybrid")
        # the tri-states resolve now that the engine family is final
        self.eager_sends = bool(eager_sends) if eager_sends is not None else \
            (tp > 1 and halo_family)
        self.wire_shard = (tp > 1 and halo_family) if wire_shard is None else bool(wire_shard)
        if not halo_family or tp <= 1 or mesh is None:
            # sharding belongs to the mesh-bound halo wire; an explicit pin
            # that cannot be honoured is a config error, not a downgrade
            if wire_shard_pinned:
                raise ValueError(
                    f"wire_shard=True needs the mesh-bound halo family, got lp_impl="
                    f"{lp_impl!r} (mesh={'yes' if mesh is not None else 'no'}, tp={tp})")
            self.wire_shard = False
        # off a mesh the halo family runs the single-process wire mirror, when
        # a codec is active or halo was asked for by name; a schedule needs no
        # compiler codec (its segment codecs take every step through the mirror)
        self._schedule = schedule
        self._simulate_codec = halo_family and (codec_active or explicit_halo) \
            and schedule is None
        self.wire_nan_guard = bool(wire_nan_guard)
        self.device = resolve_device(device) if mesh is None else mesh.device
        if mesh is not None and device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device={device} but the group computes on {mesh.device}")
        self.cfg = cfg
        self.K = num_partitions
        self.num_steps = num_steps
        self.max_batch = max_batch
        self.max_wait = max_wait_requests
        self.max_queue = max_queue
        self.uniform = uniform
        self.lp_impl = lp_impl
        self.mesh = mesh
        self.tp = tp
        self.health = GroupHealthMonitor(
            num_partitions, metrics=None if recorder is None else recorder.metrics)
        self.elastic = bool(elastic)
        self.evictions = 0
        self.last_steps_lost: Optional[int] = None
        self._corrupt_active = False
        self._saved_codec = None
        self._cur_step = 1
        self._queue: List[VideoRequest] = []
        self._polls = 0
        self._batch_seq = 0
        self._enqueued_at: Dict[int, int] = {}
        self._lifecycle: Dict[int, dict] = {}
        # the batch in flight, cleared on success: the router requeues it
        # when the replica dies with it
        self._inflight: List[VideoRequest] = []
        self._step_fault: Optional[Callable[[int], None]] = None   # test hook
        forward, forward_factory, compiler_codec = self._build_forward(mesh)
        if self._fault_plan is not None and self._fault_plan.corrupt:
            # the corrupt fault swaps the live wire codec for one step
            if schedule is not None:
                raise ValueError("corrupt@S faults need a fixed wire codec — "
                                 "sigma-scheduled segments own their codecs")
            if compiler_codec is None:
                raise ValueError("corrupt@S faults poison the halo wire, but this engine "
                                 f"has none (lp_impl={self.lp_impl!r}); use the halo family "
                                 "with a wire codec")
            if compiler_codec.stateful:
                raise ValueError(
                    "corrupt@S faults need a stateless wire codec: the residual EF protocol "
                    "is symmetric (sender and receiver decode the same base payload), so a "
                    "poisoned decode would desync the sender's own EF state, not just the "
                    "wire")
        self._guided = make_guided_step_denoiser(dit)
        self._compiler = LPStepCompiler(
            denoise_fn=self._guided,
            update_fn=self._sampler.update,
            num_partitions=self.K,
            overlap_ratio=self.r,
            patch_sizes=cfg.patch_sizes,
            spatial_axes=(1, 2, 3),
            uniform=uniform,
            codec=compiler_codec,
            schedule=schedule,
            nan_guard=self.wire_nan_guard,
            forward=forward,
            forward_factory=forward_factory,
            mesh_shape=None if mesh is None else (self.K, tp),
            wire_shard=self.wire_shard,
            lp_rank=None if mesh is None else lp_axis(mesh).rank,
        )
        # wire-attribution timelines (obs.account), reset per batch: one
        # geometry entry per (from_step, K) and one codec entry per
        # (from_step, step codec names), appended by evictions and re-plans
        self._geom_events: List[Tuple[int, int]] = [(1, self.K)]
        self._codec_events: List[Tuple[int, List[str]]] = []
        self._batch_codecs: List[str] = []
        self._runs_mark = 0

    def _build_forward(self, mesh):
        """``(forward, forward_factory, compiler_codec)`` of the step on
        ``mesh`` (``engine.py:491-569``): the hybrid or plain halo engine
        (its wire sharded over the tp group with ``wire_shard``) through
        the compiler's codec, read when the step runs so the corrupt
        drill's one-step swap reaches the wire, or, under a schedule, a
        factory of the same hook for each segment's codec; the psum engine
        otherwise.  Off a mesh, the wire mirror's codec or none.
        Re-invoked on the survivors' group after an eviction."""
        from repro_torch.core.spmd import lp_forward_halo, lp_forward_shard_map

        if mesh is None:
            return None, None, (self.codec if self._simulate_codec else None)
        if self.lp_impl not in ("halo", "halo_hybrid"):
            return (lambda fn, z, plan, axis:
                    lp_forward_shard_map(fn, z, plan, axis, lp_axis(mesh))), None, None
        # "halo" and "halo_hybrid" differ in name only: both are the halo
        # engine over the lp group (core/hybrid.lp_forward_halo_hybrid's
        # body), the wire sharded over the tp group with wire_shard (which
        # resolved on only where the mesh has a tp axis)
        shard = mesh.tp if self.wire_shard else None

        def halo_fwd(fn, z, plan, axis, **kw):
            return lp_forward_halo(fn, z, plan, axis, lp_axis(mesh),
                                   eager_sends=self.eager_sends, shard_axis=shard,
                                   nan_guard=self.wire_nan_guard, **kw)

        if self._schedule is not None:
            def forward_factory(seg_codec):
                if seg_codec.stateful:
                    return (lambda fn, z, plan, axis, st: halo_fwd(
                        fn, z, plan, axis, codec=seg_codec, codec_state=st))
                return lambda fn, z, plan, axis: halo_fwd(fn, z, plan, axis, codec=seg_codec)

            return None, forward_factory, None
        if self.codec.stateful:
            return (lambda fn, z, plan, axis, st: halo_fwd(
                fn, z, plan, axis, codec=self._compiler.codec, codec_state=st)), None, self.codec
        return (lambda fn, z, plan, axis: halo_fwd(
            fn, z, plan, axis, codec=self._compiler.codec)), None, self.codec

    # ------------------------------------------------------------- queue
    def _rlabels(self) -> Dict[str, str]:
        """``{}`` for a bare engine (today's metric schema), ``{"replica":
        "<id>"}`` once a router gave it a fleet identity; read live, since
        the router sets ``replica_id`` after construction."""
        return {} if self.replica_id is None else {"replica": str(self.replica_id)}

    def submit(self, req: VideoRequest, submit_s: Optional[float] = None) -> None:
        """Enqueue ``req``, its lifecycle stamped ``submit_s`` (an open-loop
        replay passes the arrival time) or the clock's now."""
        rec = self.recorder
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            if rec is not None:
                rec.instant("request.rejected", cat="serve", request_id=req.request_id,
                            priority=req.priority, depth=len(self._queue), **self._rlabels())
                rec.inc(obsm.REQUESTS_REJECTED, **self._rlabels())
            raise QueueFull(
                f"engine queue full ({len(self._queue)} >= max_queue="
                f"{self.max_queue}); request {req.request_id} not enqueued",
                request_id=req.request_id, depth=len(self._queue))
        self._queue.append(req)
        self._enqueued_at[req.request_id] = self._polls
        self._lifecycle[req.request_id] = {
            "request_id": req.request_id, "priority": str(req.priority),
            "latent_shape": list(req.latent_shape), "guidance": float(req.guidance),
            "psnr_floor": req.psnr_floor,
            "submit_s": float(self.clock()) if submit_s is None else float(submit_s)}
        if self.replica_id is not None:
            self._lifecycle[req.request_id]["replica"] = self.replica_id
        if rec is not None:
            rec.instant("request.enqueue", cat="serve", request_id=req.request_id,
                        latent_shape=req.latent_shape, guidance=req.guidance,
                        priority=req.priority, **self._rlabels())
            rec.inc(obsm.REQUESTS, **self._rlabels())
            rec.gauge(obsm.QUEUE_DEPTH, len(self._queue), **self._rlabels())

    @staticmethod
    def _bucket_key(req: VideoRequest) -> Tuple:
        """Geometry AND guidance: a batch runs with one guidance scale."""
        return (tuple(req.latent_shape), float(req.guidance))

    def _next_batch(self, force: bool = False) -> List[VideoRequest]:
        """Admission: a full bucket, an aged-out oldest bucket, or (``force``,
        when draining) the oldest bucket regardless."""
        if not self._queue:
            return []
        self._polls += 1
        by_key: Dict[Tuple, List[VideoRequest]] = defaultdict(list)
        for r in self._queue:
            by_key[self._bucket_key(r)].append(r)
        batch: List[VideoRequest] = []
        for bucket in by_key.values():
            if len(bucket) >= self.max_batch:
                batch = bucket[: self.max_batch]
                break
        if not batch:
            oldest = self._queue[0]
            age = self._polls - self._enqueued_at.get(oldest.request_id, self._polls)
            if force or age >= self.max_wait:
                batch = by_key[self._bucket_key(oldest)][: self.max_batch]
            else:
                return []
        chosen = {id(r) for r in batch}
        self._queue = [r for r in self._queue if id(r) not in chosen]
        self._batch_seq += 1
        admit_s = float(self.clock())
        for r in batch:
            self._enqueued_at.pop(r.request_id, None)
            life = self._lifecycle.get(r.request_id)
            if life is not None:
                life.update(admit_s=admit_s, batch_seq=self._batch_seq, batch_size=len(batch))
        rec = self.recorder
        if rec is not None:
            rec.instant("batch.admit", cat="serve", size=len(batch),
                        latent_shape=batch[0].latent_shape, guidance=batch[0].guidance,
                        request_ids=[r.request_id for r in batch], batch_seq=self._batch_seq)
            rec.observe(obsm.BATCH_SIZE, len(batch), **self._rlabels())
            rec.observe(obsm.BATCH_OCCUPANCY, len(batch) / max(1, self.max_batch),
                        **self._rlabels())
            rec.gauge(obsm.QUEUE_DEPTH, len(self._queue), **self._rlabels())
        return batch

    # ------------------------------------------------------------ serving
    def observe_group_times(self, step_times) -> None:
        """Feed per-LP-group step times (seconds; None or inf for a group
        that did not report) into the health monitor, the ``elastic=True``
        data source; the step hook reads its verdict at the next step.  On
        a mesh the ranks first agree the times (:func:`_slowest_times`: an
        elementwise MAX over every rank, a miss wins), so ranks fed
        different times still reach one verdict; the call is a collective,
        so every rank makes it as often."""
        if self.mesh is not None:
            step_times = _slowest_times(self.mesh, step_times)
        self.health.observe(step_times)

    def set_psnr_floor(self, floor: Optional[float]) -> bool:
        """Move the quality floor (dB) and re-resolve the codec schedule
        against it (``engine.py:697``): a lower floor admits cheaper
        schedules.  False (nothing done) without a resolved schedule or
        at the same floor.  The next batch runs the new plan."""
        if self._plan_resolver is None or floor == self.psnr_floor:
            return False
        self.psnr_floor = floor
        self._replan_schedule()
        return True

    def _step_codec_names(self) -> List[str]:
        """Each step's codec name, resolved as ``lp_denoise`` resolves it."""
        if self._schedule is not None:
            from repro_torch.policy.schedule import trajectory_sigmas

            return list(self._schedule.step_codecs(
                trajectory_sigmas(self._sampler, self.num_steps)))
        return [self.codec.name] * self.num_steps

    def _replan_schedule(self) -> None:
        """Re-resolve the codec schedule at the current K and floor and
        install it on the compiler (``engine.py:718``).  The in-flight
        denoise keeps its resolved segments (its hooks bind per segment
        codec); a retry resumed after this, and the next batch, run the
        new one, and the codec timeline says so from the current step."""
        if self._plan_resolver is None:
            return
        self.plan = self._plan_resolver(self.K)
        if set(self.plan.step_codecs) != {"fp32"}:
            self._schedule = self.plan.schedule
            self._compiler.schedule = self._schedule
            if self.recorder is not None:
                self._codec_events.append((self._cur_step, self._step_codec_names()))

    def _maybe_evict_straggler(self) -> None:
        """Per-step elastic hook (``engine.py:739``): apply the health
        monitor's eviction proposal (a dead group first, a slow one second)
        while the batch is denoising.  On a mesh the survivors make their
        new lp group (``shrink_hybrid_group``) and the compiler gets a
        forward hook (or factory) bound to it and this rank's new lp
        index; on the evicted group's ranks this raises ``GroupEvicted``.
        A resolved schedule is re-resolved at the new K."""
        from repro_torch.launch.mesh import shrink_hybrid_group
        from repro_torch.runtime.elastic import replan_lp_compiler

        proposal = self.health.propose((self.K, self.tp))
        if proposal is None:
            return
        evicted, new_shape = proposal.group, proposal.new_mesh_shape
        forward = forward_factory = lp_rank = None
        new_mesh = self.mesh
        if self.mesh is not None:
            new_mesh = shrink_hybrid_group(self.mesh, evicted, self.tp)
            if new_mesh is None:
                raise GroupEvicted(f"LP group {evicted} was evicted ({proposal.reason}) "
                                   f"before denoise step {self._cur_step}: its ranks leave",
                                   group=evicted, step=self._cur_step)
            forward, forward_factory, _ = self._build_forward(new_mesh)
            lp_rank = lp_axis(new_mesh).rank
        if replan_lp_compiler(self._compiler, new_shape, forward=forward,
                              forward_factory=forward_factory, recorder=self.recorder,
                              lp_rank=lp_rank):
            self.health.evict(evicted)
            self.K = new_shape[0]
            self.mesh = new_mesh
            self.evictions += 1
            if self._fault_plan is not None:
                # the dead hardware left the ring: its faults stop firing
                self._fault_plan.mark_recovered(evicted)
            rec = self.recorder
            if rec is not None:
                # the step about to run (and every later one) runs at the new K
                self._geom_events.append((self._cur_step, self.K))
                rec.instant("elastic.evict", cat="elastic", group=evicted,
                            reason=proposal.reason, step=self._cur_step,
                            new_mesh_shape=list(new_shape))
                rec.inc(obsm.EVICTIONS, reason=proposal.reason, **self._rlabels())
            self._replan_schedule()

    # ------------------------------------------------------ fault drills
    def _activate_corrupt(self) -> None:
        """Swap the live wire codec for its NaN-decoding twin for one step
        (``engine.py:795``); the codec name keys its own step-cache entry."""
        comp = self._compiler
        self._saved_codec = comp.codec
        comp.codec = CorruptingCodec.wrap(comp.codec)
        self._corrupt_active = True

    def _restore_codec(self) -> None:
        if self._corrupt_active:
            self._compiler.codec = self._saved_codec
            self._corrupt_active = False

    def _fault_events(self, plan) -> None:
        rec = self.recorder
        if rec is not None:
            for ev in plan.drain_events():
                rec.instant("fault." + ev["kind"], cat="fault", **ev)
                rec.inc(obsm.FAULTS_INJECTED, kind=ev["kind"], **self._rlabels())

    def _step_hook(self) -> Optional[Callable[[int], None]]:
        """The per-step hook, in the reference's order (``engine.py:810``):
        scripted heartbeats feed the health monitor first, the eviction
        runs second and the dead-group raise comes last, so the step on
        which the monitor declares a group dead evicts it instead of
        burning another restart.  None without a fault plan, a test hook
        or ``elastic``."""
        if self._step_fault is None and not self.elastic and self._fault_plan is None:
            return None

        def hook(i: int) -> None:
            self._cur_step = i
            plan = self._fault_plan
            if plan is not None and plan.die_fires(i):
                self._fault_events(plan)
                raise ReplicaDeath(f"replica {plan.die_replica} died (denoise step {i})",
                                   replica=plan.die_replica, step=i)
            if plan is not None:
                if self._corrupt_active:
                    self._restore_codec()          # the corrupt step is behind us
                if plan.touches_health:
                    self.health.observe(plan.heartbeats(i, self.K))
                if plan.corrupt_fires(i):
                    self._activate_corrupt()
            if self._step_fault is not None:
                self._step_fault(i)
            if self.elastic:
                self._maybe_evict_straggler()
            if plan is not None:
                dead = plan.active_dead(i)
                self._fault_events(plan)
                if dead is not None:
                    # the group is gone and not (yet) evicted: its collectives
                    # would hang, so the batch retries from its last boundary
                    raise ServingFault(f"LP group {dead} stopped heartbeating (denoise "
                                       f"step {i})", step=i)

        return hook

    def _denoise_batch(self, reqs: List[VideoRequest],
                       snapshot: Optional[DenoiseSnapshot] = None) -> List[VideoResult]:
        t0 = perf_s()
        rec = self.recorder
        shape = tuple(reqs[0].latent_shape)
        start_s = float(self.clock())
        for r in reqs:
            # a resumed retry keeps the first dispatch's stamp
            self._lifecycle.get(r.request_id, {}).setdefault("denoise_start_s", start_s)
        ctx = torch.cat([r.context.to(self.device) for r in reqs], dim=0)
        null_ctx = torch.zeros_like(ctx)
        guidance = float(reqs[0].guidance)
        z_T = torch.cat([
            initial_noise((1, *shape, self.cfg.latent_channels), r.seed, self.device)
            for r in reqs
        ], dim=0)
        compiles0 = self._compiler.compiles
        span = nullcontext() if rec is None else rec.span(
            "batch.denoise", cat="serve", size=len(reqs), latent_shape=shape,
            steps=self.num_steps, K=self.K, lp_impl=self.lp_impl)
        try:
            with span:
                z0 = lp_denoise(
                    None, z_T, self._sampler, self.num_steps, self.K, self.r,
                    self.cfg.patch_sizes, (1, 2, 3), uniform=self.uniform,
                    extras=(ctx, null_ctx, guidance), compiler=self._compiler,
                    step_hook=self._step_hook(), snapshot=snapshot, recorder=rec,
                )
                if z0.is_cuda:
                    torch.cuda.synchronize(z0.device)
        finally:
            self._restore_codec()      # a corrupt drill never outlives its batch
        wall = perf_s() - t0
        # a virtual lifecycle clock (the load harness) advances by the batch's
        # measured wall: on a mesh the slowest rank's, so every rank's clock
        # reads the same; the default clock has advanced on its own
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            if self.mesh is not None:
                wall = _slowest_wall(self.mesh, wall)
            advance(wall)
        if rec is not None:
            rec.observe(obsm.BATCH_WALL_S, wall, **self._rlabels())
            rec.inc(obsm.COMPILES, self._compiler.compiles - compiles0,
                    epoch=self._compiler.plan_epoch, **self._rlabels())
        return [VideoResult(r.request_id, z0[i:i + 1], self.num_steps,
                            batch_wall_s=wall, batch_size=len(reqs))
                for i, r in enumerate(reqs)]

    def _record_batch_wire(self, shape: Tuple[int, int, int], batch_size: int) -> None:
        """The batch's per-step wire bytes, replayed from ``comm_model``
        over the geometry and codec timelines (``engine.py:956``): exact
        per collective and tier; then each measured run reconciled against
        its predicted wire time.  Steps repeated by a resumed retry are
        billed once, under the geometry their surviving run used."""
        rec = self.recorder
        if rec is None:
            return
        from repro_torch.core.comm_model import VDMCommConfig
        from repro_torch.obs.account import attribute_denoise_steps, reconcile_segments

        ccfg = VDMCommConfig(latent_dims=tuple(shape), latent_channels=self.cfg.latent_channels,
                             patch_sizes=self.cfg.patch_sizes, d_model=self.cfg.d_model,
                             num_blocks=self.cfg.num_layers, num_steps=self.num_steps)
        codecs = list(self._batch_codecs)
        for from_step, names in self._codec_events:   # the latest event at or before a step
            for i in range(from_step, self.num_steps + 1):
                codecs[i - 1] = names[i - 1]
        records = attribute_denoise_steps(
            ccfg, self.r, codecs, self._geom_events, tp=self.tp, wire_shard=self.wire_shard,
            lp_impl=self.lp_impl, links=rec.links, batch_size=batch_size)
        rec.record_wire_steps(records)
        runs = rec.measured_runs[self._runs_mark:]
        if runs:
            rec.record_reconciliations(reconcile_segments(records, runs))

    def _finalize_requests(self, results: List[VideoResult]) -> None:
        """Close each request's lifecycle row (``engine.py:997``): its done
        stamp, queue wait and end-to-end time (also on the result), the
        SLO verdict of its priority, and the row to the recorder."""
        done_s = float(self.clock())
        for res in results:
            life = self._lifecycle.pop(res.request_id, None)
            if life is None:
                continue
            life["done_s"] = done_s
            life["queue_wait_s"] = life["admit_s"] - life["submit_s"]
            life["e2e_s"] = done_s - life["submit_s"]
            life["restarts"] = res.restarts
            res.queue_wait_s, res.e2e_s = life["queue_wait_s"], life["e2e_s"]
            if self.slo is not None:
                deadline = self.slo.deadline_for(life["priority"])
                life["deadline_s"] = deadline if deadline != float("inf") else None
                life["violated"] = bool(life["e2e_s"] > deadline)
            if self.recorder is not None:
                self.recorder.record_request(life)

    def run(self, max_batches: Optional[int] = None,
            max_restarts_per_batch: int = 2) -> List[VideoResult]:
        """Drain the queue.  A batch failing with a recoverable fault
        (``DeviceFailure``, ``ServingFault``) retries from its last boundary
        snapshot, at most ``max_restarts_per_batch`` times; any other
        exception surfaces (``GroupEvicted`` on the ranks of an evicted
        group: they leave)."""
        out: List[VideoResult] = []
        batches = 0
        rec = self.recorder
        while self._queue and (max_batches is None or batches < max_batches):
            reqs = self._next_batch(force=True)
            if not reqs:
                break
            # the router requeues these if the batch dies with its replica
            # (ReplicaDeath is no ServingFault: it leaves run); cleared only
            # on success, so a terminal fault leaves them readable too
            self._inflight = list(reqs)
            restarts = 0
            resumed_from = 0
            snapshot = DenoiseSnapshot()
            # fresh attribution timelines; a retry appends to them
            self._geom_events = [(1, self.K)]
            self._codec_events = []
            self._batch_codecs = self._step_codec_names()
            self._runs_mark = 0 if rec is None else len(rec.measured_runs)
            while True:
                try:
                    results = self._denoise_batch(reqs, snapshot)
                    for res in results:
                        res.restarts = restarts
                        res.resumed_from_step = resumed_from
                    self._finalize_requests(results)
                    self._inflight = []
                    out.extend(results)
                    self._record_batch_wire(tuple(reqs[0].latent_shape), len(reqs))
                    if rec is not None:
                        rec.inc(obsm.BATCHES, **self._rlabels())
                    break
                except (DeviceFailure, ServingFault) as e:
                    restarts += 1
                    step = getattr(e, "step", None)
                    if step is not None:
                        self.last_steps_lost = max(0, int(step) - 1 - snapshot.step)
                    resumed_from = snapshot.step
                    if rec is not None:
                        rec.instant("batch.restart", cat="serve", restarts=restarts,
                                    fault=str(e), resume_from=resumed_from, **self._rlabels())
                        rec.inc(obsm.RESTARTS, **self._rlabels())
                    if restarts > max_restarts_per_batch:
                        failed_s = float(self.clock())
                        for r in reqs:
                            life = self._lifecycle.pop(r.request_id, None)
                            if rec is not None and life is not None:
                                rec.instant("request.failed", cat="serve",
                                            request_id=r.request_id, priority=life["priority"],
                                            submit_s=life["submit_s"], failed_s=failed_s,
                                            restarts=restarts, fault=str(e))
                        raise
            batches += 1
        return out
