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
creates it fresh at the start of every run of same-dim steps (where
boundary snapshots are recorded, so a resume stays bit-exact) and
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

Not served yet, and raising ``NotImplementedError``: codec schedules and
per-segment forward hooks (ROADMAP Queue 1 item 9), the flight recorder
(item 7).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .partition import PartitionPlan, extract, plan_partition
from .reconstruct import reconstruct
from .schedule import rotation_dim, usable_dims
from .spmd import BlendTables, blend_windows, stack_windows
from .uniform import UniformPlan, plan_uniform

DenoiseFn = Callable[[torch.Tensor], torch.Tensor]
DenoiseStepFn = Callable[..., torch.Tensor]

_NOT_SERVED = {
    "schedule": "ROADMAP Queue 1 item 9 (step policy)",
    "forward_factory": "ROADMAP Queue 1 item 9 (scheduled mesh-bound wires)",
    "recorder": "ROADMAP Queue 1 item 7 (observability)",
}


def not_served(items: Dict[str, str], **given: Any) -> None:
    """Raise for the first argument given that this slice does not serve;
    ``items`` names each argument's ROADMAP item."""
    for name, value in given.items():
        if value is not None and value is not False:
            raise NotImplementedError(f"{name}= is not ported yet: {items[name]}")


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
    mesh shape, wire_shard)``.  ``step(dim, z, t, scalars, extras, state=None)`` runs
    one LP forward with ``denoise_fn(window, t, *extras)`` and applies
    ``update_fn(z, pred, scalars)``; with a residual codec it takes and
    returns the wire state, ``(z, state)``.  ``nan_guard`` arms the
    mirror's per-message NaN/Inf decode guard (a ``forward`` hook carries
    its own).  ``forward``, ``mesh_shape`` and ``lp_rank``: see the
    module docstring.
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
        not_served(_NOT_SERVED, schedule=schedule, forward_factory=forward_factory)
        if codec is not None:
            from repro_torch.comm.codecs import get_codec

            codec = get_codec(codec)
            if not uniform and forward is None:
                raise ValueError("wire codecs need the uniform-window halo geometry "
                                 "(uniform=True) or a custom forward hook")
        self.codec = codec
        self.forward = forward
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
               wire_shard: Optional[bool] = None,
               lp_rank: Optional[int] = None) -> bool:
        """Mid-request re-plan (``lp_step.py:267``): swap K, r, the mesh
        shape, the forward hook, ``wire_shard`` or this process's
        ``lp_rank``.  Safe from an ``lp_denoise`` step hook: the geometry is
        in the cache key, so old entries are never served again, and the
        ``plan_epoch`` bump makes the in-flight loop re-derive its dims and
        re-zero the codec state once.  Changing ``wire_shard`` on a compiler
        with a bound hook needs a re-bound ``forward`` in the same call
        (checked before anything changes).  Returns True when anything
        changed.

        The engine re-plans through ``runtime/elastic.replan_lp_compiler``,
        which passes K, the mesh shape, ``forward`` and ``lp_rank``;
        ``overlap_ratio`` and ``wire_shard`` are the reference's contract,
        held to it by a test, and reached from no path of the port."""
        if wire_shard is not None and bool(wire_shard) != self.wire_shard \
                and self.forward is not None and forward is None:
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
        if forward is not None and forward is not self.forward:
            self.forward = forward                 # a new group needs a re-bound hook
            changed = True
        if changed:
            self.plan_epoch += 1
        return changed

    @property
    def stateful(self) -> bool:
        return self.codec is not None and self.codec.stateful

    def _plan(self, dim: int, extent: int):
        planner = plan_uniform if self.uniform else plan_partition
        return planner(extent, self.patch_sizes[dim], self.num_partitions,
                       self.overlap_ratio, dim)

    def entry(self, dim: int, z: torch.Tensor) -> _StepEntry:
        key = (dim, tuple(z.shape), z.dtype, z.device, self.num_partitions,
               self.overlap_ratio, self.uniform,
               None if self.codec is None else self.codec.name, self.mesh_shape,
               self.wire_shard)
        cached = self._cache.get(key)
        if cached is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return cached
        axis = self.spatial_axes[dim]
        plan = self._plan(dim, z.shape[axis])
        if self.forward is not None:
            entry = _StepEntry(plan, axis, None)
        elif self.codec is not None:
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

    def init_codec_state(self, dim: int, z: torch.Tensor):
        """Zeroed residual-codec state for (rotation dim, latent geometry),
        on z's device; None for stateless codecs.  Counted in
        ``state_inits``.  With ``lp_rank`` set, that rank's slice."""
        if not self.stateful:
            return None
        from repro_torch.comm.wire import init_halo_wire_state
        from repro_torch.distributed.collectives import halo_spec

        self.state_inits += 1
        axis = self.spatial_axes[dim]
        plan = self._plan(dim, z.shape[axis])
        rest = tuple(s for i, s in enumerate(z.shape) if i != axis)
        state = init_halo_wire_state(self.codec, halo_spec(plan), rest, z.device)
        if self.lp_rank is None:
            return state
        from repro_torch.comm.wire import rank_wire_state

        return rank_wire_state(state, self.lp_rank)

    def step(self, dim: int, z: torch.Tensor, t, scalars, extras: Tuple, state=None):
        e = self.entry(dim, z)

        def fn(w):
            return self.denoise_fn(w, t, *extras)

        if self.forward is not None:
            if self.stateful:
                pred, state = self.forward(fn, z, e.plan, e.axis, state)
                return self.update_fn(z, pred, scalars), state
            return self.update_fn(z, self.forward(fn, z, e.plan, e.axis), scalars)
        if self.codec is not None:
            from repro_torch.comm.wire import simulate_halo_forward

            out = simulate_halo_forward(fn, z, e.plan, e.axis, self.codec, state,
                                        nan_guard=self.nan_guard, tables=e.halo)
            if self.stateful:
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
    ``step_hook(i)`` fires before step ``i``.  ``codec`` and
    ``nan_guard`` build the compiler when none is given (a given
    compiler owns its codec).  Residual-codec state is created fresh at
    the start of every run of same-dim steps and threaded through the
    run.  ``snapshot`` arms boundary checkpointing exactly where the
    reference records (``lp_step.py:670``): after the last step of every
    run of same-dim steps but the final one, which is where the state is
    re-zeroed; a snapshot that already holds a step resumes from it,
    bit-exact.  A ``step_hook`` may re-plan the compiler
    (``LPStepCompiler.replan``): at the next step the loop re-derives the
    rotation dims from the new K, re-zeroes the codec state and records
    the pre-replan latent stamped with the new epoch (``lp_step.py:686``).
    """
    not_served(_NOT_SERVED, schedule=schedule, recorder=recorder)
    comp = compiler
    if comp is None:
        if denoise_fn is None:
            raise ValueError("need denoise_fn when no compiler is given")
        comp = LPStepCompiler(denoise_fn, sampler.update, num_partitions,
                              overlap_ratio, patch_sizes, spatial_axes,
                              uniform=uniform, codec=codec, nan_guard=nan_guard)
    def usable():
        # from the compiler's current K: a step hook may re-plan mid-request
        dims = usable_dims([z_T.shape[comp.spatial_axes[d]] for d in range(3)],
                           comp.patch_sizes, comp.num_partitions)
        if not dims:
            raise ValueError(f"no latent dim has >= {comp.num_partitions} patches; reduce K")
        return dims

    dims = usable()
    start = 0
    z = z_T
    if snapshot is not None and snapshot.z is not None and snapshot.step > 0:
        start = min(int(snapshot.step), num_steps)
        snapshot.resumes += 1
        z = snapshot.z.to(device=z_T.device, dtype=z_T.dtype)

    state, state_dim = None, None
    epoch = comp.plan_epoch
    for i in range(start + 1, num_steps + 1):
        if step_hook is not None:
            step_hook(i)
        if comp.plan_epoch != epoch:                   # re-planned mid-request
            epoch = comp.plan_epoch
            dims = usable()
            state, state_dim = None, None
            if snapshot is not None and i - 1 >= max(start, 1):
                # a re-plan is a boundary too: re-stamped with the new epoch
                # even on the first resumed step
                snapshot.record(i - 1, z, epoch)
        dim = rotation_dim(i, dims)
        t, scalars = sampler.timestep(i), sampler.step_scalars(i)
        if comp.stateful:
            if state is None or dim != state_dim:      # a new run of same-dim steps
                state, state_dim = comp.init_codec_state(dim, z), dim
            z, state = comp.step(dim, z, t, scalars, extras, state)
        else:
            z = comp.step(dim, z, t, scalars, extras)
        if snapshot is not None and i < num_steps and rotation_dim(i + 1, dims) != dim:
            snapshot.record(i, z, comp.plan_epoch)
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
