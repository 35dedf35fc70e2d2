"""Seeded, replayable open-loop traffic generator for the LP serving
engine (the load half of the load-and-SLO harness; evaluation lives in
``repro_torch/obs/slo.py``).  A port of ``repro/serving/loadgen.py``: the
workload generator, its digest, the mix grammar and the virtual clock are
copies (``tests/test_torch_loadgen.py`` holds each equal to the original);
the replay serves the port's engine, and its default prompts come
from ``models.frontends.text_context`` on the engine's device.

Three pieces:

* a **request-mix spec** — :class:`RequestClass` buckets over
  ``(latent_shape, guidance, psnr_floor, priority)`` with sampling
  weights, parseable from a CLI string (:func:`parse_mix`);
* a **workload generator** — :func:`build_workload` draws arrival times
  (Poisson or deterministic at a fixed offered rate) and per-request
  class/seed assignments from ONE ``numpy`` PRNG, so a fixed
  ``WorkloadSpec.seed`` always yields the byte-identical workload
  (:func:`workload_digest` pins that);
* a **replay loop** — :func:`run_workload` drives
  ``LPServingEngine.submit`` open-loop on a :class:`VirtualClock`:
  requests arrive at their generated offsets regardless of service
  progress (arrivals never wait on completions — the property that
  makes offered-load latency sweeps meaningful), while the clock
  advances by each batch's *measured* wall.  Queue waits and e2e
  latencies therefore live on one consistent virtual timeline: real
  compute, synthetic arrivals.

The engine under replay must be constructed with the same
``VirtualClock`` (``LPServingEngine(clock=...)``); ``run_workload`` refuses
to replay against a wall clock, where arrival offsets would be
meaningless.  On a group every rank replays the same workload; the
engine's ranks agree on each batch's wall (the slowest rank's), so their
clocks, and with them their admissions and batches, stay the same.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .engine import LPServingEngine, QueueFull, VideoRequest, VideoResult

ARRIVAL_PROCESSES = ("poisson", "deterministic")


class VirtualClock:
    """Monotonic virtual time the replay loop and engine co-advance.

    Callable (returns ``now`` in seconds) so it drops into
    ``LPServingEngine(clock=...)``; the engine calls :meth:`advance`
    with each batch's measured wall, the replay fast-forwards to the
    next arrival when the queue idles.
    """

    def __init__(self, start_s: float = 0.0) -> None:
        self.now = float(start_s)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt_s: float) -> None:
        if dt_s < 0:
            raise ValueError(f"cannot advance time by {dt_s}")
        self.now += float(dt_s)

    def advance_to(self, t_s: float) -> None:
        self.now = max(self.now, float(t_s))


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One bucket of the request mix."""

    name: str
    latent_shape: Tuple[int, int, int]
    guidance: float = 5.0
    psnr_floor: Optional[float] = None
    priority: str = "standard"
    weight: float = 1.0

    def __post_init__(self):
        if len(self.latent_shape) != 3 or \
                any(int(d) <= 0 for d in self.latent_shape):
            raise ValueError(
                f"class {self.name!r}: latent_shape must be 3 positive "
                f"dims, got {self.latent_shape}")
        if self.weight <= 0:
            raise ValueError(
                f"class {self.name!r}: weight must be > 0, "
                f"got {self.weight}")


DEFAULT_MIX = (
    RequestClass("clip", (6, 8, 12), priority="interactive", weight=1.0),
    RequestClass("std", (6, 8, 12), priority="standard", weight=2.0),
    RequestClass("bulk", (4, 8, 12), priority="batch", weight=1.0,
                 guidance=3.0),
)


def parse_mix(spec: Optional[str]) -> Tuple[RequestClass, ...]:
    """CLI request-mix grammar -> class tuple.

    Classes are ``;``-separated; each is a name followed by ``,``-
    separated ``key=value`` fields::

        "clip,shape=6x8x12,priority=interactive,weight=1,guidance=5;
         bulk,shape=4x8x12,priority=batch,weight=2,psnr=40"

    Keys: ``shape`` (``TxHxW``, required), ``guidance``, ``priority``,
    ``weight``, ``psnr`` (the per-request quality floor the priority
    class maps to).  ``None``/empty returns :data:`DEFAULT_MIX`.
    """
    if spec is None or not spec.strip():
        return DEFAULT_MIX
    classes: List[RequestClass] = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = [p.strip() for p in chunk.split(",")]
        name = parts[0]
        if not name or "=" in name:
            raise ValueError(
                f"bad mix class {chunk!r}: first field is the name")
        fields = {}
        for kv in parts[1:]:
            k, eq, v = kv.partition("=")
            if not eq:
                raise ValueError(f"bad mix field {kv!r} in {name!r}")
            fields[k.strip()] = v.strip()
        if "shape" not in fields:
            raise ValueError(f"mix class {name!r} needs shape=TxHxW")
        try:
            shape = tuple(int(d) for d in fields.pop("shape").split("x"))
            kwargs = {}
            if "guidance" in fields:
                kwargs["guidance"] = float(fields.pop("guidance"))
            if "priority" in fields:
                kwargs["priority"] = fields.pop("priority")
            if "weight" in fields:
                kwargs["weight"] = float(fields.pop("weight"))
            if "psnr" in fields:
                kwargs["psnr_floor"] = float(fields.pop("psnr"))
        except ValueError as e:
            raise ValueError(f"mix class {name!r}: {e}") from None
        if fields:
            raise ValueError(
                f"mix class {name!r}: unknown fields {sorted(fields)}")
        classes.append(RequestClass(name, shape, **kwargs))
    if not classes:
        raise ValueError(f"mix spec {spec!r} has no classes")
    return tuple(classes)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything that determines a workload, seed included."""

    rate_rps: float                      # offered load, requests/second
    num_requests: int
    arrivals: str = "poisson"            # or "deterministic"
    seed: int = 0
    mix: Tuple[RequestClass, ...] = DEFAULT_MIX

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.num_requests <= 0:
            raise ValueError(
                f"num_requests must be > 0, got {self.num_requests}")
        if self.arrivals not in ARRIVAL_PROCESSES:
            raise ValueError(
                f"arrivals must be one of {ARRIVAL_PROCESSES}, "
                f"got {self.arrivals!r}")
        if not self.mix:
            raise ValueError("mix must not be empty")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One generated request: when it arrives and what it asks for."""

    request_id: int
    arrival_s: float
    cls: RequestClass
    seed: int                            # the request's latent PRNG seed


def build_workload(spec: WorkloadSpec) -> List[Arrival]:
    """Draw the whole workload from one seeded PRNG — replayable.

    Poisson arrivals are exponential inter-arrival gaps at
    ``rate_rps``; deterministic arrivals are the fixed ``1/rate`` grid
    (same mean offered load, zero burstiness — the A/B pair for
    isolating queueing noise from service noise).  Class choice is
    weight-proportional; per-request seeds come from the same stream.
    """
    rng = np.random.default_rng(spec.seed)
    n = spec.num_requests
    if spec.arrivals == "poisson":
        gaps = rng.exponential(1.0 / spec.rate_rps, size=n)
    else:
        gaps = np.full(n, 1.0 / spec.rate_rps)
    times = np.cumsum(gaps)
    weights = np.asarray([c.weight for c in spec.mix], dtype=np.float64)
    choices = rng.choice(len(spec.mix), size=n, p=weights / weights.sum())
    seeds = rng.integers(0, 2 ** 31 - 1, size=n)
    return [
        Arrival(request_id=i, arrival_s=float(times[i]),
                cls=spec.mix[int(choices[i])], seed=int(seeds[i]))
        for i in range(n)
    ]


def workload_digest(workload: Sequence[Arrival]) -> str:
    """Stable content hash of a generated workload.

    Byte-determinism gate: the same :class:`WorkloadSpec` must always
    digest identically (floats via ``repr`` — exact round-trip), and
    any change to arrivals, mix assignment, or seeds must show."""
    h = hashlib.sha256()
    for a in workload:
        h.update(json.dumps([
            a.request_id, repr(a.arrival_s), a.seed, a.cls.name,
            list(a.cls.latent_shape), repr(a.cls.guidance),
            None if a.cls.psnr_floor is None else repr(a.cls.psnr_floor),
            a.cls.priority,
        ]).encode())
    return h.hexdigest()


def _default_make_context(engine: LPServingEngine):
    """Each arrival's prompt: ``text_context`` seeded with its seed, on the
    engine's device."""
    from repro_torch.device import generator
    from repro_torch.models import frontends

    def make_context(arrival: Arrival):
        return frontends.text_context(generator(arrival.seed, engine.device), 1,
                                      engine.cfg, engine.device)

    return make_context


def run_workload(
    engine: LPServingEngine,
    workload: Sequence[Arrival],
    make_context: Optional[Callable[[Arrival], object]] = None,
    max_restarts_per_batch: int = 2,
) -> List[VideoResult]:
    """Open-loop replay: submit at arrival offsets, serve greedily.

    The loop alternates "submit everything that has arrived by now"
    with "serve one batch" (work-conserving: a partially filled bucket
    launches rather than idling — under offered load the admission
    aging knob never binds).  When the queue drains with arrivals
    still pending, the clock fast-forwards to the next arrival — an
    idle server, not time travel.  Arrivals never wait on completions,
    so queue waits are a true function of offered load vs. capacity.

    Each submit is stamped with the request's ``arrival_s`` (the
    engine's ``submit_s`` override), not the submission call time: a
    request that arrived while a batch was in flight can only be
    handed to the synchronous engine after that batch returns, and
    stamping the call would under-report its queue wait and e2e by up
    to a full batch wall.

    On an engine with a bounded queue (``max_queue``), an arrival that
    lands on a full queue is dropped here exactly as a real front door
    would drop it: the engine's ``QueueFull`` is absorbed (it already
    emitted the ``request.rejected`` trace instant and counter), the
    replay continues, and the rejected request simply has no result.
    """
    clock = engine.clock
    if not isinstance(clock, VirtualClock):
        raise ValueError(
            "run_workload needs the engine constructed with a "
            "VirtualClock (LPServingEngine(clock=VirtualClock())); "
            "on a wall clock the workload's arrival offsets would be "
            "meaningless")
    if make_context is None:
        make_context = _default_make_context(engine)
    pending = sorted(workload, key=lambda a: (a.arrival_s, a.request_id))
    results: List[VideoResult] = []
    i = 0
    while i < len(pending) or engine._queue:
        if not engine._queue and i < len(pending):
            clock.advance_to(pending[i].arrival_s)
        while i < len(pending) and pending[i].arrival_s <= clock.now:
            a = pending[i]
            try:
                engine.submit(VideoRequest(
                    request_id=a.request_id,
                    context=make_context(a),
                    latent_shape=tuple(a.cls.latent_shape),
                    seed=a.seed,
                    guidance=a.cls.guidance,
                    priority=a.cls.priority,
                    psnr_floor=a.cls.psnr_floor,
                ), submit_s=a.arrival_s)
            except QueueFull:
                pass
            i += 1
        results.extend(engine.run(
            max_batches=1,
            max_restarts_per_batch=max_restarts_per_batch))
    return results
