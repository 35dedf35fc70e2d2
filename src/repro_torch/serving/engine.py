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
:meth:`LPServingEngine.observe_group_times` must therefore be the same
on every rank.

Arguments of other paths raise ``NotImplementedError`` naming their
ROADMAP item: ``codec_schedule`` and ``psnr_floor`` (9), ``recorder`` (7),
``slo`` (10).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.comm.codecs import get_codec
from repro_torch.configs.base import ArchConfig
from repro_torch.core import DenoiseSnapshot, LPStepCompiler, lp_denoise
from repro_torch.core.lp_step import not_served
from repro_torch.core.spmd import select_lp_impl
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.diffusion.pipeline import make_guided_step_denoiser
from repro_torch.diffusion.sampler import FlowMatchEuler
from repro_torch.distributed.collectives import HybridGroup, LPGroup, lp_axis, tp_size
from repro_torch.obs.clock import perf_s
from repro_torch.runtime.faults import (CorruptingCodec, GroupEvicted, ReplicaDeath,
                                        ServingFault, parse_fault_plan)
from repro_torch.runtime.ft import DeviceFailure
from repro_torch.runtime.health import GroupHealthMonitor

_NOT_SERVED = {
    "codec_schedule": "ROADMAP Queue 1 item 9 (step policy)",
    "psnr_floor": "ROADMAP Queue 1 item 9 (step policy)",
    "recorder": "ROADMAP Queue 1 item 7 (observability)",
    "slo": "ROADMAP Queue 1 item 10 (fleet and SLO layer)",
}


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
        elastic: bool = False,
        inject_fault=None,
        recorder=None,
        slo=None,
        wire_nan_guard: bool = True,
        eager_sends: Optional[bool] = None,
        wire_shard: Optional[bool] = None,
    ):
        not_served(_NOT_SERVED, codec_schedule=codec_schedule, psnr_floor=psnr_floor,
                   recorder=recorder, slo=slo)
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
                "is); the replica router (ROADMAP Queue 1 item 10) splits per-replica "
                "sub-plans")
        tp = tp_size(mesh)
        if wire_shard and tp <= 1:
            raise ValueError("wire_shard shards the halo wire over the tp axis; the mesh has "
                             "no tp axis (need --mesh MxT with T >= 2)")
        self.codec = get_codec(wire_codec)
        codec_active = self.codec.name not in ("fp32", "identity")
        explicit_halo = lp_impl in ("halo", "halo_hybrid")
        if lp_impl == "auto":
            if codec_active:
                lp_impl = "halo_hybrid" if tp > 1 else "halo"
            else:
                lp_impl = select_lp_impl(num_partitions, tp)
        if codec_active and lp_impl not in ("halo", "halo_hybrid"):
            what = f"wire_codec={self.codec.name!r}"
            if self.codec.name.startswith("displaced"):
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
            if wire_shard is True:
                raise ValueError(
                    f"wire_shard=True needs the mesh-bound halo family, got lp_impl="
                    f"{lp_impl!r} (mesh={'yes' if mesh is not None else 'no'}, tp={tp})")
            self.wire_shard = False
        # off a mesh the halo family runs the single-process wire mirror, when
        # a codec is active or halo was asked for by name
        self._simulate_codec = halo_family and (codec_active or explicit_halo)
        self.wire_nan_guard = bool(wire_nan_guard)
        self.device = resolve_device(device) if mesh is None else mesh.device
        if mesh is not None and device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device={device} but the group computes on {mesh.device}")
        self.cfg = cfg
        self.K = num_partitions
        self.r = overlap_ratio
        self.num_steps = num_steps
        self.max_batch = max_batch
        self.max_wait = max_wait_requests
        self.max_queue = max_queue
        self.uniform = uniform
        self.lp_impl = lp_impl
        self.mesh = mesh
        self.tp = tp
        self.health = GroupHealthMonitor(num_partitions)
        self.elastic = bool(elastic)
        self.evictions = 0
        self.last_steps_lost: Optional[int] = None
        self._corrupt_active = False
        self._saved_codec = None
        self._cur_step = 1
        self._sampler = FlowMatchEuler(num_steps)
        self._queue: List[VideoRequest] = []
        self._polls = 0
        self._enqueued_at: Dict[int, int] = {}
        self._lifecycle: Dict[int, dict] = {}
        self._step_fault: Optional[Callable[[int], None]] = None   # test hook
        forward, compiler_codec = self._build_forward(mesh)
        if self._fault_plan is not None and self._fault_plan.corrupt:
            # the corrupt fault swaps the live wire codec for one step
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
            nan_guard=self.wire_nan_guard,
            forward=forward,
            mesh_shape=None if mesh is None else (self.K, tp),
            wire_shard=self.wire_shard,
            lp_rank=None if mesh is None else lp_axis(mesh).rank,
        )

    def _build_forward(self, mesh):
        """``(forward, compiler_codec)`` of the step on ``mesh``
        (``engine.py:491-569``): the hybrid or plain halo engine (its wire
        sharded over the tp group with ``wire_shard``) through the
        compiler's codec, read when the step runs so the corrupt drill's
        one-step swap reaches the wire; the psum engine otherwise.  Off a
        mesh, the wire mirror's codec or none.  Re-invoked on the
        survivors' group after an eviction."""
        from repro_torch.core.spmd import lp_forward_halo, lp_forward_shard_map

        if mesh is None:
            return None, (self.codec if self._simulate_codec else None)
        if self.lp_impl not in ("halo", "halo_hybrid"):
            return (lambda fn, z, plan, axis:
                    lp_forward_shard_map(fn, z, plan, axis, lp_axis(mesh))), None
        # "halo" and "halo_hybrid" differ in name only: both are the halo
        # engine over the lp group (core/hybrid.lp_forward_halo_hybrid's
        # body), the wire sharded over the tp group with wire_shard (which
        # resolved on only where the mesh has a tp axis)
        shard = mesh.tp if self.wire_shard else None

        def halo_fwd(fn, z, plan, axis, **kw):
            return lp_forward_halo(fn, z, plan, axis, lp_axis(mesh),
                                   eager_sends=self.eager_sends, shard_axis=shard,
                                   nan_guard=self.wire_nan_guard, **kw)

        if self.codec.stateful:
            return (lambda fn, z, plan, axis, st: halo_fwd(
                fn, z, plan, axis, codec=self._compiler.codec, codec_state=st)), self.codec
        return (lambda fn, z, plan, axis: halo_fwd(
            fn, z, plan, axis, codec=self._compiler.codec)), self.codec

    # ------------------------------------------------------------- queue
    def submit(self, req: VideoRequest) -> None:
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"engine queue full ({len(self._queue)} >= max_queue="
                f"{self.max_queue}); request {req.request_id} not enqueued",
                request_id=req.request_id, depth=len(self._queue))
        self._queue.append(req)
        self._enqueued_at[req.request_id] = self._polls
        self._lifecycle[req.request_id] = {"submit_s": perf_s()}

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
        admit_s = perf_s()
        for r in batch:
            self._enqueued_at.pop(r.request_id, None)
            self._lifecycle[r.request_id]["admit_s"] = admit_s
        return batch

    # ------------------------------------------------------------ serving
    def observe_group_times(self, step_times) -> None:
        """Feed per-LP-group step times (seconds; None or inf for a group
        that did not report) into the health monitor, the ``elastic=True``
        data source; the step hook reads its verdict at the next step.  On
        a mesh, every rank must be fed the same times before the same step:
        ranks that disagree reach different proposals, some leave the ring
        and the others' next collective fails at the group timeout."""
        self.health.observe(step_times)

    def _maybe_evict_straggler(self) -> None:
        """Per-step elastic hook (``engine.py:739``): apply the health
        monitor's eviction proposal (a dead group first, a slow one second)
        while the batch is denoising.  On a mesh the survivors make their
        new lp group (``shrink_hybrid_group``) and the compiler gets a
        forward hook bound to it and this rank's new lp index; on the
        evicted group's ranks this raises ``GroupEvicted``."""
        from repro_torch.launch.mesh import shrink_hybrid_group
        from repro_torch.runtime.elastic import replan_lp_compiler

        proposal = self.health.propose((self.K, self.tp))
        if proposal is None:
            return
        evicted, new_shape = proposal.group, proposal.new_mesh_shape
        forward, lp_rank, new_mesh = None, None, self.mesh
        if self.mesh is not None:
            new_mesh = shrink_hybrid_group(self.mesh, evicted, self.tp)
            if new_mesh is None:
                raise GroupEvicted(f"LP group {evicted} was evicted ({proposal.reason}) "
                                   f"before denoise step {self._cur_step}: its ranks leave",
                                   group=evicted, step=self._cur_step)
            forward, _ = self._build_forward(new_mesh)
            lp_rank = lp_axis(new_mesh).rank
        if replan_lp_compiler(self._compiler, new_shape, forward=forward, lp_rank=lp_rank):
            self.health.evict(evicted)
            self.K = new_shape[0]
            self.mesh = new_mesh
            self.evictions += 1
            if self._fault_plan is not None:
                # the dead hardware left the ring: its faults stop firing
                self._fault_plan.mark_recovered(evicted)

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
                if dead is not None:
                    # the group is gone and not (yet) evicted: its collectives
                    # would hang, so the batch retries from its last boundary
                    raise ServingFault(f"LP group {dead} stopped heartbeating (denoise "
                                       f"step {i})", step=i)

        return hook

    def _denoise_batch(self, reqs: List[VideoRequest],
                       snapshot: Optional[DenoiseSnapshot] = None) -> List[VideoResult]:
        t0 = perf_s()
        shape = tuple(reqs[0].latent_shape)
        ctx = torch.cat([r.context.to(self.device) for r in reqs], dim=0)
        null_ctx = torch.zeros_like(ctx)
        guidance = float(reqs[0].guidance)
        z_T = torch.cat([
            initial_noise((1, *shape, self.cfg.latent_channels), r.seed, self.device)
            for r in reqs
        ], dim=0)
        try:
            z0 = lp_denoise(
                None, z_T, self._sampler, self.num_steps, self.K, self.r,
                self.cfg.patch_sizes, (1, 2, 3), uniform=self.uniform,
                extras=(ctx, null_ctx, guidance), compiler=self._compiler,
                step_hook=self._step_hook(), snapshot=snapshot,
            )
        finally:
            self._restore_codec()      # a corrupt drill never outlives its batch
        if z0.is_cuda:
            torch.cuda.synchronize(z0.device)
        wall = perf_s() - t0
        return [VideoResult(r.request_id, z0[i:i + 1], self.num_steps,
                            batch_wall_s=wall, batch_size=len(reqs))
                for i, r in enumerate(reqs)]

    def _finalize_requests(self, results: List[VideoResult]) -> None:
        done_s = perf_s()
        for res in results:
            life = self._lifecycle.pop(res.request_id, None)
            if life is None:
                continue
            res.queue_wait_s = life["admit_s"] - life["submit_s"]
            res.e2e_s = done_s - life["submit_s"]

    def run(self, max_batches: Optional[int] = None,
            max_restarts_per_batch: int = 2) -> List[VideoResult]:
        """Drain the queue.  A batch failing with a recoverable fault
        (``DeviceFailure``, ``ServingFault``) retries from its last boundary
        snapshot, at most ``max_restarts_per_batch`` times; any other
        exception surfaces (``GroupEvicted`` on the ranks of an evicted
        group: they leave)."""
        out: List[VideoResult] = []
        batches = 0
        while self._queue and (max_batches is None or batches < max_batches):
            reqs = self._next_batch(force=True)
            if not reqs:
                break
            restarts = 0
            resumed_from = 0
            snapshot = DenoiseSnapshot()
            while True:
                try:
                    results = self._denoise_batch(reqs, snapshot)
                    for res in results:
                        res.restarts = restarts
                        res.resumed_from_step = resumed_from
                    self._finalize_requests(results)
                    out.extend(results)
                    break
                except (DeviceFailure, ServingFault) as e:
                    restarts += 1
                    step = getattr(e, "step", None)
                    if step is not None:
                        self.last_steps_lost = max(0, int(step) - 1 - snapshot.step)
                    resumed_from = snapshot.step
                    if restarts > max_restarts_per_batch:
                        for r in reqs:
                            self._lifecycle.pop(r.request_id, None)
                        raise
            batches += 1
        return out
