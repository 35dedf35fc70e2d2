"""LP video-generation serving engine: request queue -> geometry-batched
LP denoising -> latents out, on one GPU or on each rank of an lp group.

The subset of ``repro/serving/engine.py`` that the port serves:

  * bounded admission: ``submit`` raises :class:`QueueFull` beyond
    ``max_queue`` queued requests;
  * batching by ``(latent shape, guidance)``: a batch shares one guidance
    scale, and a launch happens when a bucket is full or the oldest
    request has waited ``max_wait_requests`` polls (``run`` drains);
  * one guided denoiser and one ``LPStepCompiler`` per engine, so the
    second batch of a geometry reuses every cached step entry;
  * recovery: a batch that raises ``DeviceFailure`` retries from its last
    boundary snapshot, at most ``max_restarts_per_batch`` times.

``lp_impl`` resolves to the name the reference reports
(``select_lp_impl``; a wire codec implies the halo family).

``mesh`` (an lp group from ``launch/mesh.make_lp_group``: every rank
builds the same engine and submits the same requests) binds the LP step
to the group, as the reference's ``_build_forward`` does
(``engine.py:491``): the halo engine (``core/spmd.lp_forward_halo``,
through the wire codec; ``eager_sends`` issues every round before the
first deposit) or the psum engine (``lp_forward_shard_map``) for the
rest.  Each rank denoises its own window and ends every step with the
replicated latent.  Any other mesh (a tp axis) is ROADMAP Queue 1 item 8.
Off a mesh the reference runs the halo wire mirror
(``comm/wire.simulate_halo_forward``) when ``lp_impl`` is a halo-family
engine and either a codec is active or halo was asked for by name
(``engine.py:426-437``), and the uniform vmapped engine otherwise
(``engine.py:565-567``); so does this one.
``wire_codec`` takes any name of ``comm.codecs.CODEC_NAMES``;
``wire_nan_guard`` (default on) arms the mirror's per-message NaN/Inf
decode guard.  Arguments of other paths raise ``NotImplementedError``
naming their ROADMAP item.
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
from repro_torch.distributed.collectives import LPGroup
from repro_torch.obs.clock import perf_s
from repro_torch.runtime.ft import DeviceFailure

_NOT_SERVED = {
    "mesh": "ROADMAP Queue 1 item 8 (hybrid LP x TP: a mesh other than a 1-D lp group)",
    "codec_schedule": "ROADMAP Queue 1 item 9 (step policy)",
    "psnr_floor": "ROADMAP Queue 1 item 9 (step policy)",
    "elastic": "ROADMAP Queue 1 item 8 (runtime/elastic re-planning)",
    "inject_fault": "ROADMAP Queue 1 item 7 (runtime/faults)",
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
    ):
        one_d = mesh is None or isinstance(mesh, LPGroup)
        not_served(_NOT_SERVED, mesh=None if one_d else mesh, codec_schedule=codec_schedule,
                   psnr_floor=psnr_floor, elastic=elastic, inject_fault=inject_fault,
                   recorder=recorder, slo=slo)
        if mesh is not None and mesh.size != num_partitions:
            raise ValueError(f"the lp group has {mesh.size} ranks, num_partitions="
                             f"{num_partitions}")
        if max_queue is not None and max_queue < max_batch:
            raise ValueError(f"max_queue={max_queue} < max_batch={max_batch}: "
                             "the queue could never fill a batch")
        self.codec = get_codec(wire_codec)
        codec_active = self.codec.name not in ("fp32", "identity")
        explicit_halo = lp_impl in ("halo", "halo_hybrid")
        if lp_impl == "auto":
            lp_impl = "halo" if codec_active else select_lp_impl(num_partitions)
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
        if mesh is not None and lp_impl == "halo_hybrid":
            raise NotImplementedError(f"lp_impl='halo_hybrid' on a mesh is not ported yet: "
                                      f"{_NOT_SERVED['mesh']}")
        # off a mesh the halo family runs the single-process wire mirror, when
        # a codec is active or halo was asked for by name
        simulate = mesh is None and halo_family and (codec_active or explicit_halo)
        self.wire_nan_guard = bool(wire_nan_guard)
        # None is off: the reference turns it on only on a tp mesh (item 8)
        self.eager_sends = bool(eager_sends)
        self.device = resolve_device(device) if mesh is None else mesh.device
        if mesh is not None and device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device={device} but the lp group computes on {mesh.device}")
        self.cfg = cfg
        self.K = num_partitions
        self.r = overlap_ratio
        self.num_steps = num_steps
        self.max_batch = max_batch
        self.max_wait = max_wait_requests
        self.max_queue = max_queue
        self.uniform = uniform
        self.lp_impl = lp_impl
        self._sampler = FlowMatchEuler(num_steps)
        self._queue: List[VideoRequest] = []
        self._polls = 0
        self._enqueued_at: Dict[int, int] = {}
        self._lifecycle: Dict[int, dict] = {}
        self._step_fault: Optional[Callable[[int], None]] = None   # test hook
        self._guided = make_guided_step_denoiser(dit)
        forward = None if mesh is None else self._build_forward(mesh)
        self._compiler = LPStepCompiler(
            denoise_fn=self._guided,
            update_fn=self._sampler.update,
            num_partitions=self.K,
            overlap_ratio=self.r,
            patch_sizes=cfg.patch_sizes,
            spatial_axes=(1, 2, 3),
            uniform=uniform,
            codec=self.codec if simulate or (mesh is not None and halo_family) else None,
            nan_guard=self.wire_nan_guard,
            forward=forward,
            mesh_shape=None if mesh is None else (self.K, 1),
            lp_rank=None if mesh is None else mesh.rank,
        )

    def _build_forward(self, mesh):
        """The step's forward hook on ``mesh``: the halo engine through the
        compiler's wire codec (read when the step runs) for the halo
        family, the psum engine otherwise (``engine.py:491-567``)."""
        from repro_torch.core.spmd import lp_forward_halo, lp_forward_shard_map

        if self.lp_impl != "halo":
            return lambda fn, z, plan, axis: lp_forward_shard_map(fn, z, plan, axis, mesh)

        def halo_fwd(fn, z, plan, axis, **kw):
            return lp_forward_halo(fn, z, plan, axis, mesh, codec=self._compiler.codec,
                                   eager_sends=self.eager_sends,
                                   nan_guard=self.wire_nan_guard, **kw)

        if self.codec.stateful:
            return lambda fn, z, plan, axis, st: halo_fwd(fn, z, plan, axis, codec_state=st)
        return halo_fwd

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
        z0 = lp_denoise(
            None, z_T, self._sampler, self.num_steps, self.K, self.r,
            self.cfg.patch_sizes, (1, 2, 3), uniform=self.uniform,
            extras=(ctx, null_ctx, guidance), compiler=self._compiler,
            step_hook=self._step_fault, snapshot=snapshot,
        )
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
        """Drain the queue.  A batch failing with ``DeviceFailure`` retries
        from its last boundary snapshot; any other exception surfaces."""
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
                except DeviceFailure:
                    restarts += 1
                    resumed_from = snapshot.step
                    if restarts > max_restarts_per_batch:
                        for r in reqs:
                            self._lifecycle.pop(r.request_id, None)
                        raise
            batches += 1
        return out
