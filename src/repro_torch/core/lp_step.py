"""LP denoising engines: the reference loop and the step-cached fast path.

One LP forward pass = dynamic rotating partition -> parallel denoising ->
position-aware latent reconstruction (paper §3.2 workflow, Fig. 3).  A
port of ``repro/core/lp_step.py``:

* :func:`lp_denoise_reference` — the eager loop, a fresh closure per step.
* :func:`lp_denoise` + :class:`LPStepCompiler` — the serving path.  PyTorch
  has nothing to trace, so the compiler is a cache keyed like the
  reference's (``lp_step.py:406-415``, without the trace signatures).  An
  entry holds the partition plan and, for uniform windows, its blend
  weights and normalizer already on the device; ``compiles`` counts
  misses, at most one per rotation dim (<= 3) per denoise.

The K windows of a step are denoised in ONE call, stacked on the batch
axis (the reference vmaps over them): ``denoise_fn`` sees ``(K*B, ...)``
and must treat samples independently, as the DiT does; the guided
denoisers of ``diffusion/pipeline.py`` tile their conditioning to match.

``codec=`` (a ``comm.codecs`` name or instance) runs every step through
``comm/wire.simulate_halo_forward``, the single-process mirror of the
halo engine.  Residual codecs thread explicit state: ``lp_denoise``
creates it fresh at the start of every run of same-dim, same-codec steps
(where boundary snapshots are recorded, so a resume stays bit-exact) and
carries it across the run; ``state_inits`` counts the inits.

``forward=`` binds the step to a group: each rank calls
``forward(fn, z, plan, axis)`` (``(..., state)`` -> ``(pred, state)`` with a
residual codec) in place of the one-process engines, e.g. the psum, halo
or hybrid engine of ``core/spmd.py`` / ``core/hybrid.py``
(``serving/engine.py`` builds it); the mesh shape ``(K, T)`` and
``wire_shard`` are part of the cache key, and ``lp_rank`` names the rank
whose slice of the residual state this process threads.

``LPStepCompiler.replan`` swaps the geometry mid-request (an elastic
eviction, ``runtime/elastic.replan_lp_compiler``): it bumps
``plan_epoch``, and the in-flight ``lp_denoise`` re-derives its rotation
dims, re-zeroes the codec state once and records a snapshot at the
re-plan boundary.

``schedule=`` (a ``policy.CodecSchedule`` or spec) varies the wire codec
over the denoise, as the reference does (``lp_step.py:168-246``):
``lp_denoise`` resolves the sigma thresholds against the sampler's
trajectory and hands each step its segment's codec, which keys the step
cache, picks the residual state's layout and encodes the wire.  Residual
state is zeroed at every rotation-dim switch, every codec-segment
boundary and every re-plan, where boundary snapshots are recorded, so a
resume stays bit-exact; misses stay <= 3 x the number of segments.
``forward_factory`` is the scheduled twin of ``forward``: called with a
segment's codec, it returns the group-bound hook for that codec.

``recorder=`` (``obs.FlightRecorder``, duck-typed) wraps each run of
same-dim, same-codec steps (each step, when a ``step_hook`` is given) in
a ``device_span`` (``torch.profiler.record_function`` on the device
timeline) and records its wall, its snapshots, resumes and re-plans.
Only then does a run end in a synchronisation of the current stream of
``z``'s device, so the wall is the run's; without a recorder the loop
adds none.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from .partition import PartitionPlan, extract, plan_partition
from .reconstruct import reconstruct
from .schedule import rotation_dim, usable_dims
from .spmd import BlendTables, blend_windows, stack_windows
from .uniform import UniformPlan, plan_uniform

DenoiseFn = Callable[[torch.Tensor], torch.Tensor]
DenoiseStepFn = Callable[..., torch.Tensor]


@dataclasses.dataclass
class DenoiseSnapshot:
    """Mid-denoise recovery point, recorded at dim-rotation boundaries.

    After each completed run of same-dim steps, and at a re-plan, the
    latent and the step index are recorded here (a CPU copy, so it
    survives the loss of the device that failed) with the compiler's
    ``plan_epoch``; a later :func:`lp_denoise` call with the same snapshot
    resumes from that boundary instead of ``z_T``.
    """

    step: int = 0                          # last completed denoise step
    z: Optional[torch.Tensor] = None       # CPU copy of the latent at ``step``
    plan_epoch: int = 0                    # compiler epoch when recorded
    boundaries: int = 0                    # records taken
    resumes: int = 0                       # times a denoise resumed from here

    def record(self, step: int, z: torch.Tensor, plan_epoch: int = 0) -> None:
        self.step = int(step)
        self.z = z.detach().to("cpu", copy=True)
        self.plan_epoch = int(plan_epoch)
        self.boundaries += 1


def lp_forward(denoise_fn: DenoiseFn, z: torch.Tensor, plan: PartitionPlan,
               axis: int) -> torch.Tensor:
    """One LP forward pass with a prebuilt (paper-exact) partition plan."""
    preds = []
    for k in range(plan.num_partitions):
        sub = extract(z, plan, k, axis)
        pred = denoise_fn(sub)
        if pred.shape != sub.shape:
            raise ValueError(
                f"denoise_fn changed the sub-latent shape: {tuple(sub.shape)} -> "
                f"{tuple(pred.shape)}"
            )
        preds.append(pred)
    return reconstruct(preds, plan, axis)


def lp_forward_uniform(denoise_fn: DenoiseFn, z: torch.Tensor, plan: UniformPlan,
                       axis: int, tables: Optional[BlendTables] = None) -> torch.Tensor:
    """One LP forward pass on uniform windows: the K windows go through
    ``denoise_fn`` as one batch, then ``blend_windows`` stitches them."""
    windows = stack_windows(z, plan, axis)               # (K, B, ...)
    K, B = windows.shape[:2]
    preds = denoise_fn(windows.reshape((K * B,) + windows.shape[2:]))
    preds = preds.reshape(windows.shape)
    return blend_windows(preds, plan, axis, tables).to(z.dtype)


@dataclasses.dataclass(frozen=True)
class _StepEntry:
    plan: Any                       # UniformPlan or PartitionPlan
    axis: int
    tables: Optional[BlendTables]   # uniform plans: blend tables on the device
    halo: Any = None                # mirrored codec steps: comm.wire.HaloTables


class LPStepCompiler:
    """LRU cache of LP step geometry, keyed like the reference's step cache.

    Key: ``(dim, z shape, z dtype, device, K, r, uniform, codec name,
    mesh shape, wire_shard)``, the codec being the step's: the compiler's
    own, or the schedule segment's that ``lp_denoise`` passes per call
    (the reference keys ``codec.name`` per call, ``lp_step.py:406-415``).
    ``step(dim, z, t, scalars, extras, state=None, codec=None)`` runs one
    LP forward with ``denoise_fn(window, t, *extras)`` and applies
    ``update_fn(z, pred, scalars)``; with a residual codec it takes and
    returns the wire state, ``(z, state)``.  ``nan_guard`` arms the
    mirror's per-message NaN/Inf decode guard (a group-bound hook carries
    its own).  ``forward``, ``forward_factory``, ``schedule``,
    ``mesh_shape`` and ``lp_rank``: see the module docstring.
    """

    def __init__(
        self,
        denoise_fn: DenoiseStepFn,
        update_fn: Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor],
        num_partitions: int,
        overlap_ratio: float,
        patch_sizes: Sequence[int],
        spatial_axes: Sequence[int] = (1, 2, 3),
        uniform: bool = False,
        maxsize: int = 32,
        codec=None,
        schedule=None,
        forward: Optional[Callable] = None,
        forward_factory: Optional[Callable] = None,
        mesh_shape: Optional[Tuple[int, ...]] = None,
        wire_shard: bool = False,
        nan_guard: bool = False,
        lp_rank: Optional[int] = None,
    ):
        if schedule is not None:
            from repro_torch.policy.schedule import parse_schedule

            schedule = parse_schedule(schedule)
            if codec is not None:
                raise ValueError("pass codec= (fixed) or schedule= (sigma-varying), not both")
            if forward is not None and forward_factory is None:
                raise ValueError(
                    "a codec schedule cannot run through a fixed forward= hook (it is bound "
                    "to one codec and would silently ignore the segments) — pass a "
                    "forward_factory that binds the hook per segment codec")
            if not uniform and forward_factory is None:
                raise ValueError("codec schedules need the uniform-window halo geometry "
                                 "(uniform=True) or a forward_factory hook")
        if codec is not None:
            from repro_torch.comm.codecs import get_codec

            codec = get_codec(codec)
            if not uniform and forward is None:
                raise ValueError("wire codecs need the uniform-window halo geometry "
                                 "(uniform=True) or a custom forward hook")
        self.codec = codec
        self.schedule = schedule
        self.forward = forward
        self.forward_factory = forward_factory
        self.mesh_shape = None if mesh_shape is None else tuple(mesh_shape)
        self.wire_shard = bool(wire_shard)
        self.lp_rank = lp_rank
        self.nan_guard = bool(nan_guard)
        self.denoise_fn = denoise_fn
        self.update_fn = update_fn
        self.num_partitions = num_partitions
        self.overlap_ratio = overlap_ratio
        self.patch_sizes = tuple(patch_sizes)
        self.spatial_axes = tuple(spatial_axes)
        self.uniform = uniform
        self.maxsize = maxsize
        self._cache: "OrderedDict[Tuple, _StepEntry]" = OrderedDict()
        self.compiles = 0
        self.hits = 0
        self.state_inits = 0
        self.plan_epoch = 0                # bumped by every re-plan that changes anything

    def replan(self, num_partitions: Optional[int] = None,
               overlap_ratio: Optional[float] = None,
               mesh_shape: Optional[Tuple[int, ...]] = None,
               forward: Optional[Callable] = None,
               forward_factory: Optional[Callable] = None,
               wire_shard: Optional[bool] = None,
               lp_rank: Optional[int] = None) -> bool:
        """Mid-request re-plan (``lp_step.py:267``): swap K, r, the mesh
        shape, the forward hook or factory, ``wire_shard`` or this
        process's ``lp_rank``.  Safe from an ``lp_denoise`` step hook: the
        geometry is in the cache key, so old entries are never served
        again, and the ``plan_epoch`` bump makes the in-flight loop
        re-derive its dims and re-zero the codec state once.  Changing
        ``wire_shard`` on a compiler with a bound hook or factory needs a
        re-bound one in the same call (checked before anything changes).
        Returns True when anything changed.

        The engine re-plans through ``runtime/elastic.replan_lp_compiler``,
        which passes K, the mesh shape, the hook or factory and
        ``lp_rank``; ``overlap_ratio`` and ``wire_shard`` are the
        reference's contract, held to it by a test, and reached from no
        path of the port."""
        if wire_shard is not None and bool(wire_shard) != self.wire_shard and (
                (self.forward is not None and forward is None)
                or (self.forward_factory is not None and forward_factory is None)):
            raise ValueError("changing wire_shard on a compiler with a bound forward hook "
                             "needs a re-bound forward= / forward_factory= in the same replan "
                             "call")
        new = {"num_partitions": num_partitions, "overlap_ratio": overlap_ratio,
               "mesh_shape": None if mesh_shape is None else tuple(mesh_shape),
               "wire_shard": None if wire_shard is None else bool(wire_shard),
               "lp_rank": lp_rank}
        changed = False
        for name, value in new.items():
            if value is not None and value != getattr(self, name):
                setattr(self, name, value)
                changed = True
        for name, hook in (("forward", forward), ("forward_factory", forward_factory)):
            if hook is not None and hook is not getattr(self, name):
                setattr(self, name, hook)          # a new group needs a re-bound hook
                changed = True
        if changed:
            self.plan_epoch += 1
        return changed

    @property
    def stateful(self) -> bool:
        return self.codec is not None and self.codec.stateful

    def _codec_for(self, codec):
        """The step's codec: the compiler's own for None, else a schedule
        segment's (a name or an instance)."""
        if codec is None:
            return self.codec
        from repro_torch.comm.codecs import get_codec

        return get_codec(codec)

    def _plan(self, dim: int, extent: int):
        planner = plan_uniform if self.uniform else plan_partition
        return planner(extent, self.patch_sizes[dim], self.num_partitions,
                       self.overlap_ratio, dim)

    def _hook(self, codec):
        """The group-bound hook of a step on ``codec``, or None off a group."""
        if self.forward_factory is not None and codec is not None:
            return self.forward_factory(codec)
        return self.forward

    def entry(self, dim: int, z: torch.Tensor, codec=None) -> _StepEntry:
        codec = self._codec_for(codec)
        key = (dim, tuple(z.shape), z.dtype, z.device, self.num_partitions,
               self.overlap_ratio, self.uniform, None if codec is None else codec.name,
               self.mesh_shape, self.wire_shard)
        cached = self._cache.get(key)
        if cached is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return cached
        axis = self.spatial_axes[dim]
        plan = self._plan(dim, z.shape[axis])
        if self.forward is not None or (self.forward_factory is not None
                                        and codec is not None):
            entry = _StepEntry(plan, axis, None)
        elif codec is not None:
            from repro_torch.comm.wire import HaloTables

            entry = _StepEntry(plan, axis, None, HaloTables.build(plan, z.device))
        else:
            tables = BlendTables.build(plan, z.device) if self.uniform else None
            entry = _StepEntry(plan, axis, tables)
        self._cache[key] = entry
        if len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
        self.compiles += 1
        return entry

    def init_codec_state(self, dim: int, z: torch.Tensor, codec=None):
        """Zeroed residual-codec state for (rotation dim, latent geometry,
        the step's codec), on z's device; None for stateless codecs.
        Counted in ``state_inits``.  With ``lp_rank`` set, that rank's
        slice."""
        codec = self._codec_for(codec)
        if codec is None or not codec.stateful:
            return None
        from repro_torch.comm.wire import init_halo_wire_state
        from repro_torch.distributed.collectives import halo_spec

        self.state_inits += 1
        axis = self.spatial_axes[dim]
        plan = self._plan(dim, z.shape[axis])
        rest = tuple(s for i, s in enumerate(z.shape) if i != axis)
        state = init_halo_wire_state(codec, halo_spec(plan), rest, z.device)
        if self.lp_rank is None:
            return state
        from repro_torch.comm.wire import rank_wire_state

        return rank_wire_state(state, self.lp_rank)

    def step(self, dim: int, z: torch.Tensor, t, scalars, extras: Tuple, state=None,
             codec=None):
        codec = self._codec_for(codec)
        e = self.entry(dim, z, codec)
        stateful = codec is not None and codec.stateful

        def fn(w):
            return self.denoise_fn(w, t, *extras)

        hook = self._hook(codec)
        if hook is not None:
            if stateful:
                pred, state = hook(fn, z, e.plan, e.axis, state)
                return self.update_fn(z, pred, scalars), state
            return self.update_fn(z, hook(fn, z, e.plan, e.axis), scalars)
        if codec is not None:
            from repro_torch.comm.wire import simulate_halo_forward

            out = simulate_halo_forward(fn, z, e.plan, e.axis, codec, state,
                                        nan_guard=self.nan_guard, tables=e.halo)
            if stateful:
                pred, state = out
                return self.update_fn(z, pred, scalars), state
            return self.update_fn(z, out, scalars)
        if self.uniform:
            pred = lp_forward_uniform(fn, z, e.plan, e.axis, e.tables)
        else:
            pred = lp_forward(fn, z, e.plan, e.axis)
        return self.update_fn(z, pred, scalars)


def lp_denoise(
    denoise_fn: Optional[DenoiseStepFn],
    z_T: torch.Tensor,
    sampler,
    num_steps: int,
    num_partitions: int,
    overlap_ratio: float,
    patch_sizes: Sequence[int],
    spatial_axes: Sequence[int],
    uniform: bool = False,
    extras: Tuple = (),
    compiler: Optional[LPStepCompiler] = None,
    step_hook: Optional[Callable[[int], None]] = None,
    codec=None,
    schedule=None,
    snapshot: Optional[DenoiseSnapshot] = None,
    recorder=None,
    nan_guard: bool = False,
) -> torch.Tensor:
    """Full T-step LP denoising through the step cache.

    ``denoise_fn(window, t, *extras)`` takes the timestep as a float;
    ``sampler`` gives ``timestep(i)``, ``step_scalars(i)`` and ``update``.
    ``step_hook(i)`` fires before step ``i``.  ``codec``, ``schedule`` and
    ``nan_guard`` build the compiler when none is given (a given compiler
    owns its codec and schedule).  A schedule is resolved against the
    sampler's sigma trajectory: each step runs on its segment's codec.

    A run is a stretch of same-dim, same-codec steps, as the reference's
    scans are (``lp_step.py:635-688``).  Residual-codec state is created
    fresh at the start of every run and threaded through it.  ``snapshot`` arms
    boundary checkpointing where the reference records: after every run
    but the final one, which is where the state is re-zeroed; a snapshot
    that already holds a step resumes from it, bit-exact.  A
    ``step_hook`` may re-plan the compiler (``LPStepCompiler.replan``): at
    the next step the loop re-derives the rotation dims from the new K,
    re-zeroes the codec state and records the pre-replan latent stamped
    with the new epoch (``lp_step.py:686``).

    ``recorder`` (duck-typed ``obs.FlightRecorder``): a ``device_span``
    ``denoise.run`` opened at a run's first step and closed at its last
    (``denoise.step`` around each step with a hook, which may re-plan),
    ended by a synchronisation of ``z``'s current stream so ``record_run``
    gets the run's wall; ``record_snapshot``,
    ``record_resume`` and ``record_replan`` where those happen.  It never
    enters the step cache, so it adds no miss.
    """
    comp = compiler
    if comp is None:
        if denoise_fn is None:
            raise ValueError("need denoise_fn when no compiler is given")
        comp = LPStepCompiler(denoise_fn, sampler.update, num_partitions,
                              overlap_ratio, patch_sizes, spatial_axes,
                              uniform=uniform, codec=codec, schedule=schedule,
                              nan_guard=nan_guard)
    # one codec per step: a schedule's segment codec, or None for the
    # compiler's own (read at each step, so the corrupt drill's swap counts)
    if comp.schedule is not None:
        from repro_torch.comm.codecs import get_codec
        from repro_torch.policy.schedule import trajectory_sigmas

        step_codecs = [get_codec(n) for n in
                       comp.schedule.step_codecs(trajectory_sigmas(sampler, num_steps))]
    else:
        step_codecs = [None] * num_steps

    def codec_key(c):
        return None if c is None else c.name

    def stateful(c):
        return comp.stateful if c is None else c.stateful

    def usable():
        # from the compiler's current K: a step hook may re-plan mid-request
        dims = usable_dims([z_T.shape[comp.spatial_axes[d]] for d in range(3)],
                           comp.patch_sizes, comp.num_partitions)
        if not dims:
            raise ValueError(f"no latent dim has >= {comp.num_partitions} patches; reduce K")
        return dims

    def run_key(i, dims):
        return rotation_dim(i, dims), codec_key(step_codecs[i - 1])

    def boundary(i, z, epoch):
        snapshot.record(i, z, epoch)
        if recorder is not None:
            recorder.record_snapshot(i)

    dims = usable()
    start = 0
    z = z_T
    if snapshot is not None and snapshot.z is not None and snapshot.step > 0:
        start = min(int(snapshot.step), num_steps)
        snapshot.resumes += 1
        if recorder is not None:
            recorder.record_resume(start)
        z = snapshot.z.to(device=z_T.device, dtype=z_T.dtype)

    state, cur_key = None, None
    epoch = comp.plan_epoch
    span = None          # the recorder's open span: (exit stack, first step, t0, codec)
    try:
        for i in range(start + 1, num_steps + 1):
            if step_hook is not None:
                step_hook(i)
            if comp.plan_epoch != epoch:                   # re-planned mid-request
                epoch = comp.plan_epoch
                dims = usable()
                state, cur_key = None, None
                if recorder is not None:
                    recorder.record_replan(i, comp.num_partitions, epoch)
                if snapshot is not None and i - 1 >= max(start, 1):
                    # a re-plan is a boundary too: re-stamped with the new
                    # epoch even on the first resumed step
                    boundary(i - 1, z, epoch)
            key = run_key(i, dims)
            dim, seg = key[0], step_codecs[i - 1]
            if stateful(seg) and (state is None or key != cur_key):
                state = comp.init_codec_state(dim, z, seg)      # a new run
            run_ends = i == num_steps or run_key(i + 1, dims) != key
            if recorder is not None and span is None:
                if step_hook is not None:
                    name, args = "denoise.step", {"step": i}
                else:                          # no hook, no re-plan: the run is known
                    stop = next(j for j in range(i, num_steps + 1)
                                if j == num_steps or run_key(j + 1, dims) != key)
                    name, args = "denoise.run", {"start": i, "stop": stop,
                                                 "n": stop - i + 1}
                ck_name = codec_key(seg) or getattr(comp.codec, "name", "none")
                span = (contextlib.ExitStack(), i, time.perf_counter(), ck_name)
                span[0].enter_context(recorder.device_span(
                    name, dim=dim, codec=ck_name, epoch=comp.plan_epoch, **args))
            cur_key = key
            t, scalars = sampler.timestep(i), sampler.step_scalars(i)
            if stateful(seg):
                z, state = comp.step(dim, z, t, scalars, extras, state, codec=seg)
            else:
                z = comp.step(dim, z, t, scalars, extras, codec=seg)
            if span is not None and (run_ends or step_hook is not None):
                if z.is_cuda:                   # the run's wall, not its launch
                    torch.cuda.current_stream(z.device).synchronize()
                stack, first, t0, ck_name = span
                span = None
                stack.close()
                recorder.record_run(first, i, time.perf_counter() - t0, dim=dim,
                                    codec=ck_name, epoch=comp.plan_epoch)
            if snapshot is not None and run_ends and i < num_steps:
                boundary(i, z, comp.plan_epoch)            # step i ends a run
    finally:
        if span is not None:
            span[0].close()
    return z


def lp_denoise_reference(
    denoise_fn_for_step: Callable[[int, int], DenoiseFn],
    z_T: torch.Tensor,
    scheduler_update: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
    num_steps: int,
    num_partitions: int,
    overlap_ratio: float,
    patch_sizes: Sequence[int],
    spatial_axes: Sequence[int],
    uniform: bool = False,
) -> torch.Tensor:
    """The eager T-step loop (paper Fig. 3, Eqs. 3-6): a fresh denoiser
    closure and a fresh plan every step; the semantics oracle."""
    dims = usable_dims([z_T.shape[spatial_axes[d]] for d in range(3)],
                       patch_sizes, num_partitions)
    if not dims:
        raise ValueError(f"no latent dim has >= {num_partitions} patches; reduce K")
    z = z_T
    for i in range(1, num_steps + 1):
        dim = rotation_dim(i, dims)
        axis = spatial_axes[dim]
        fn = denoise_fn_for_step(i, dim)
        if uniform:
            plan = plan_uniform(z.shape[axis], patch_sizes[dim], num_partitions,
                                overlap_ratio, dim)
            pred = lp_forward_uniform(fn, z, plan, axis)
        else:
            plan = plan_partition(z.shape[axis], patch_sizes[dim], num_partitions,
                                  overlap_ratio, dim)
            pred = lp_forward(fn, z, plan, axis)
        z = scheduler_update(z, pred, i)
    return z
