"""Rank-side cases of ``test_torch_dist.py``.

``repro_torch.launch.mesh.run_lp_world`` runs these in spawned
processes, one per rank of a gloo group on the CPU.  This module imports
no JAX (a child imports only the module its function lives in), and
each function runs many cases in one world.  Inputs come from numpy
seeds; outputs go back to the test, which holds them to the port's
single-process mirror and to ``core/comm_model``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io

import numpy as np
import torch

from repro_torch.comm.codecs import get_codec
from repro_torch.comm.wire import init_halo_wire_state, rank_wire_state, simulate_halo_forward
from repro_torch.core.schedule import rotation_dim, usable_dims
from repro_torch.core.hybrid import lp_forward_halo_hybrid, tp_cfg_branch, tp_cfg_combine
from repro_torch.core.spmd import lp_forward_halo, lp_forward_shard_map
from repro_torch.core.uniform import plan_uniform
from repro_torch.distributed.collectives import HybridGroup, halo_spec, sharded_ppermute
from repro_torch.obs import FlightRecorder

PATCH = (1, 2, 2)


def exact_denoiser(x: torch.Tensor) -> torch.Tensor:
    """Elementwise, so a window gives the same values alone or stacked."""
    return 0.5 * x + 0.25


def case_latent(shape, seed: int, nan_at=None) -> torch.Tensor:
    z = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if nan_at is not None:
        z[nan_at] = np.nan
    return torch.from_numpy(z)


def step_plans(z: torch.Tensor, K: int, r: float, steps: int):
    """(step, dim, plan) of each step, the rotation ``lp_denoise`` runs."""
    dims = usable_dims([z.shape[1 + d] for d in range(3)], PATCH, K)
    for i in range(1, steps + 1):
        d = rotation_dim(i, dims)
        yield i, d, plan_uniform(z.shape[1 + d], PATCH[d], K, r, d)


def halo_run(group, case: dict) -> dict:
    """One case on this rank: ``case["steps"]`` halo forwards, the output
    fed back as the next input, residual state made fresh on every new
    rotation dim (as ``lp_denoise`` does) and threaded within a run.
    On a ``HybridGroup`` the hybrid engine runs, its wire sharded over the
    tp group when ``case["shard"]``.  Returns the outputs, this rank's
    states and the byte counter read after each step."""
    z = case_latent(case["shape"], case["seed"], case.get("nan_at"))
    codec = case["codec"]
    outs, states, counts = [], [], []
    state, state_dim = None, None
    group.counter.reset()
    forward = lp_forward_halo
    if isinstance(group, HybridGroup):
        def forward(fn, z, plan, axis, mesh, **kw):
            return lp_forward_halo_hybrid(fn, z, plan, axis, mesh,
                                          wire_shard=case["shard"], **kw)
    for _, d, plan in step_plans(z, group.size, case["r"], case["steps"]):
        kw = dict(codec=codec, eager_sends=case["eager"], nan_guard=case["guard"])
        if codec is not None and get_codec(codec).stateful:
            if state is None or d != state_dim:
                rest = tuple(s for i, s in enumerate(z.shape) if i != 1 + d)
                state = rank_wire_state(init_halo_wire_state(codec, halo_spec(plan), rest),
                                        group.rank)
                state_dim = d
            z, state = forward(exact_denoiser, z, plan, 1 + d, group, codec_state=state, **kw)
            states.append(state)
        else:
            z = forward(exact_denoiser, z, plan, 1 + d, group, **kw)
        outs.append(z)
        counts.append(group.counter.snapshot())
    return {"outs": outs, "states": states, "counts": counts}


def halo_cases(group, cases) -> list:
    return [halo_run(group, c) for c in cases]


def psum_cases(group, cases) -> list:
    """The psum engine over each case's steps (output fed back)."""
    results = []
    for case in cases:
        z = case_latent(case["shape"], case["seed"])
        outs, counts = [], []
        group.counter.reset()
        for _, d, plan in step_plans(z, group.size, case["r"], case["steps"]):
            z = lp_forward_shard_map(exact_denoiser, z, plan, 1 + d, group)
            outs.append(z)
            counts.append(group.counter.snapshot())
        results.append({"outs": outs, "counts": counts})
    return results


def engine_run(group, requests, num_steps: int, wire_codec=None, eager_sends=None) -> dict:
    """The reduced WAN DiT (f32, weights from seed 0) served through
    ``LPServingEngine(mesh=group)`` on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit
    from repro_torch.serving.engine import LPServingEngine, VideoRequest

    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    eng = LPServingEngine(model, cfg, num_partitions=group.size, num_steps=num_steps,
                          max_batch=len(requests), device="cpu", mesh=group,
                          wire_codec=wire_codec, eager_sends=eager_sends)
    group.counter.reset()
    for rid, ctx, shape, seed in requests:
        eng.submit(VideoRequest(rid, torch.from_numpy(ctx), shape, seed=seed))
    res = eng.run()
    return {"latents": {r.request_id: r.latent for r in res}, "lp_impl": eng.lp_impl,
            "compiles": eng._compiler.compiles, "counts": group.counter.snapshot(),
            "eager_sends": eng.eager_sends}


def engine_runs(group, codecs, requests, num_steps: int) -> list:
    return [engine_run(group, requests, num_steps, wire_codec=c) for c in codecs]


def engine_world(group, codecs, requests, num_steps: int, schedule=None,
                 scheduled_steps: int = 4) -> dict:
    """:func:`engine_runs`, then (``schedule``: a codec-schedule spec) one
    request of the exact stand-in DiT through a scheduled, recorded engine
    of ``scheduled_steps`` steps (:func:`recorded_run`)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import VideoRequest

    out = {"runs": engine_runs(group, codecs, requests, num_steps)}
    if schedule is not None:
        cfg = get_config("wan21-dit-1.3b").reduced()
        rid, ctx, shape, seed = requests[0]
        eng = _engine(group, exact_dit, cfg, scheduled_steps, codec_schedule=schedule,
                      recorder=FlightRecorder())
        out["scheduled"] = recorded_run(eng, group, VideoRequest(rid, torch.from_numpy(ctx),
                                                                 shape, seed=seed))
    return out


def recorded_run(eng, group, request) -> dict:
    """One request through ``eng``, built with a flight recorder:
    :func:`_record` and this rank's byte counter before each step and at
    the end, the recorder's ``wire_steps``, whether its trace validates,
    the plan (as a dict) and the state inits."""
    from repro_torch.obs import validate_trace

    rec = eng.recorder
    snaps = []
    eng._step_fault = lambda i: snaps.append(group.counter.snapshot())
    group.counter.reset()
    eng.submit(request)
    res = eng.run()[0]
    eng._step_fault = None
    return {**_record(eng, group, res), "snaps": snaps + [group.counter.snapshot()],
            "wire_steps": rec.wire_steps, "trace_ok": validate_trace(rec.trace.to_json()) == [],
            "plan": None if eng.plan is None else dataclasses.asdict(eng.plan),
            "state_inits": eng._compiler.state_inits}


def kernel_shapes_of_a_rank(group, latent, num_steps: int, r: float, codec: str) -> dict:
    """The shapes this rank hands ``ops.int8_quantize`` (N, rows, F) and
    the DiT's attention (B, Sq, Skv) while the reduced DiT serves one
    request through ``LPServingEngine(mesh=group)`` on the ``codec`` wire."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.kernels import ops
    from repro_torch.models import dit, frontends
    from repro_torch.serving.engine import LPServingEngine, VideoRequest

    quant, attn = set(), set()
    quantize, attention = ops.int8_quantize, dit.attention

    def quantize_seen(x, qmax=127):
        quant.add(tuple(x.shape))
        return quantize(x, qmax)

    def attention_seen(q, k, *args, **kw):
        attn.add((q.shape[0], q.shape[1], k.shape[1]))
        return attention(q, k, *args, **kw)

    ops.int8_quantize, dit.attention = quantize_seen, attention_seen
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    eng = LPServingEngine(model, cfg, num_partitions=group.size, overlap_ratio=r,
                          num_steps=num_steps, max_batch=1, device="cpu", mesh=group,
                          wire_codec=codec)
    eng.submit(VideoRequest(0, frontends.text_context(generator(0, "cpu"), 1, cfg, "cpu"),
                            tuple(latent), seed=0))
    eng.run()
    return {"quant": sorted(quant), "attn": sorted(attn)}


def serve_cli(group, argv) -> str:
    """``repro_torch.launch.serve`` on this rank, the reduced config
    patched in; returns what the rank printed."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    serve.get_config = lambda name: get_config(name).reduced()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


def fail_on_rank(group, bad: int) -> int:
    """Rank ``bad`` raises; the others wait on it in a collective."""
    if group.rank == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    group.all_gather(torch.zeros(3))
    return group.rank


def exact_dit(z: torch.Tensor, t, context) -> torch.Tensor:
    """A stand-in DiT, elementwise and exact: a window's output is the same
    alone or stacked, on any batch."""
    return 0.5 * z + 0.25


def _engine(group, dit_fn, cfg, num_steps: int, **kw):
    from repro_torch.serving.engine import LPServingEngine

    return LPServingEngine(dit_fn, cfg, num_partitions=group.size, num_steps=num_steps,
                           max_batch=1, device="cpu", mesh=group, **kw)


def _record(eng, group, res) -> dict:
    lp = eng.mesh.lp if isinstance(eng.mesh, HybridGroup) else eng.mesh
    return {"latent": res.latent, "restarts": res.restarts,
            "resumed_from_step": res.resumed_from_step, "lp_impl": eng.lp_impl,
            "wire_shard": eng.wire_shard, "eager_sends": eng.eager_sends,
            "compiles": eng._compiler.compiles, "counts": group.counter.snapshot(),
            "evictions": eng.evictions, "K": eng.K, "mesh_shape": eng._compiler.mesh_shape,
            "last_steps_lost": eng.last_steps_lost, "lp_rank": lp.rank,
            "lp_size": lp.size, "lp_ranks": lp.ranks}


def hybrid_engine_runs(group, runs, drill, requests, num_steps: int,
                          exact: bool = False, leave: bool = False) -> dict:
    """One world's engine work on a ``HybridGroup``: ``runs`` (name,
    wire_codec, wire_shard[, more engine arguments: a recorded run,
    :func:`recorded_run`]) through ``LPServingEngine(mesh=group)``, one
    request each; then the eviction drill (``drill``: the engine's
    keyword arguments), one request and a second one on the shrunken
    group.  The reduced WAN DiT in f32 (weights from seed 0), or the exact
    elementwise stand-in.  On the ranks of the evicted group the drill
    raises ``GroupEvicted``: with ``leave`` it ends the rank (the world
    returns ``Evicted`` for it), else it is recorded under ``evicted``
    beside the runs."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit
    from repro_torch.runtime.faults import GroupEvicted
    from repro_torch.serving.engine import VideoRequest

    cfg = get_config("wan21-dit-1.3b").reduced()
    dit_fn = exact_dit if exact else dit.init_params(cfg, generator(0, "cpu"), "cpu")
    out = {"runs": {}}
    reqs = [VideoRequest(rid, torch.from_numpy(ctx), shape, seed=seed)
            for rid, ctx, shape, seed in requests]
    for name, codec, shard, *extra in runs:
        if extra:                  # a scheduled run: recorded, its counter read every step
            eng = _engine(group, dit_fn, cfg, num_steps, wire_codec=codec, wire_shard=shard,
                          recorder=FlightRecorder(), **extra[0])
            out["runs"][name] = recorded_run(eng, group, reqs[0])
            continue
        eng = _engine(group, dit_fn, cfg, num_steps, wire_codec=codec, wire_shard=shard)
        group.counter.reset()
        eng.submit(reqs[0])
        out["runs"][name] = _record(eng, group, eng.run()[0])
    if drill is None:
        return out
    eng = _engine(group, dit_fn, cfg, num_steps, **drill)
    group.counter.reset()
    eng.submit(reqs[0])
    try:
        res = eng.run()[0]
    except GroupEvicted as e:
        if leave:
            raise
        out["evicted"] = (e.group, e.step)
        return out
    out["drill"] = _record(eng, group, res)
    out["drill"]["plan"] = None if eng.plan is None else dataclasses.asdict(eng.plan)
    eng.submit(reqs[1])
    out["after"] = _record(eng, group, eng.run()[0])
    return out


def hybrid_wire_world(group, wire_cases, engine_args=None) -> dict:
    """The wire cases (:func:`halo_run`) on this rank of a ``HybridGroup``,
    a ring shift through ``sharded_ppermute``, the CFG pair split over the
    tp group, then (``engine_args``: the arguments of
    :func:`hybrid_engine_runs` after ``group``) engine runs and an
    eviction drill."""
    out = {"wires": halo_cases(group, wire_cases)}
    M, m = group.size, group.rank
    mine = case_latent((3, 5, 2), 80 + m)
    out["ppermute"] = sharded_ppermute(mine, group.lp, (m + 1) % M, (m - 1) % M, group.tp)
    branch = tp_cfg_branch(group.tp)
    pred = case_latent((2, 3, 4), 90 + group.rank)[branch] + float(branch)
    out["cfg"] = (branch, pred, tp_cfg_combine(pred, group.tp, 4.0))
    if engine_args is not None:
        out["engine"] = hybrid_engine_runs(group, *engine_args)
    return out


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaNs in the same places."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0))


def flat_state(state, prefix=()):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from flat_state(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def mirror_run(case: dict, K: int):
    """The single-process mirror over the case's steps: outputs, states
    and each step's dim.  The engines' guard guards decodes: uncoded it is
    a no-op, while the mirror would run an fp32 codec with a guard."""
    z = case_latent(case["shape"], case["seed"], case.get("nan_at"))
    codec = get_codec(case["codec"])
    guard = case["guard"] and case["codec"] is not None
    outs, states, dims = [], [], []
    state, state_dim = None, None
    for _, d, plan in step_plans(z, K, case["r"], case["steps"]):
        if codec.stateful:
            if state is None or d != state_dim:
                rest = tuple(s for i, s in enumerate(z.shape) if i != 1 + d)
                state, state_dim = init_halo_wire_state(codec, halo_spec(plan), rest), d
            z, state = simulate_halo_forward(exact_denoiser, z, plan, 1 + d, codec, state,
                                             nan_guard=guard)
            states.append(state)
        else:
            z = simulate_halo_forward(exact_denoiser, z, plan, 1 + d, codec, nan_guard=guard)
        outs.append(z)
        dims.append(d)
    return outs, states, dims


def agreed_monitor(group, slow_group: int, num_steps: int, latent) -> dict:
    """An elastic engine whose health monitor is fed different step times
    on every rank: each rank's times carry its own jitter, and world rank
    0 alone sees ``slow_group`` far slower.  The engine agrees the times
    (the elementwise MAX over the ranks) before its monitor sees them, so
    every rank evicts ``slow_group`` in the same step hook; its ranks raise
    ``GroupEvicted``, the survivors finish the request.  Returns the
    survivor's record and the agreed times it was fed."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import VideoRequest, _slowest_times

    cfg = get_config("wan21-dit-1.3b").reduced()
    eng = _engine(group, exact_dit, cfg, num_steps, elastic=True)
    rank = torch.distributed.get_rank()
    times = [1.0 + 0.01 * rank] * group.size
    if rank == 0:
        times[slow_group] = 9.0
    agreed = _slowest_times(group, times)
    for _ in range(5):
        eng.observe_group_times(times)
    eng.submit(VideoRequest(0, torch.zeros((1, cfg.context_len, cfg.context_dim)),
                            latent, seed=0))
    res = eng.run()
    return {**_record(eng, group, res[0]), "agreed": agreed}


def fleet_replay(group, mix: str, rate: float, num_requests: int, num_steps: int,
                 skew_s: float, lp_impl: str = "auto", elastic: bool = False,
                 inject_fault=None) -> dict:
    """A seeded open-loop workload through ``loadgen.run_workload`` on this
    rank of ``group``: the exact stand-in DiT behind a sleep of ``skew_s``
    times (world rank + 1) a call, so each rank measures its own wall; the
    engine on a ``VirtualClock`` with a flight recorder, batches of up to
    2 (``elastic`` / ``inject_fault``: an eviction drill, on whose evicted
    ranks this raises ``GroupEvicted``).  Returns the lifecycle rows, the
    latents, the byte counter, the clock's reading, the batch walls, the
    seconds this rank slept and the evictions."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import LPServingEngine
    from repro_torch.serving.loadgen import (VirtualClock, WorkloadSpec, build_workload,
                                             parse_mix, run_workload)

    rank = torch.distributed.get_rank()
    slept = [0.0]

    def skewed_dit(z, t, context):
        time.sleep(skew_s * (rank + 1))
        slept[0] += skew_s * (rank + 1)
        return exact_dit(z, t, context)

    cfg = get_config("wan21-dit-1.3b").reduced()
    rec = FlightRecorder()
    eng = LPServingEngine(skewed_dit, cfg, num_partitions=group.size, num_steps=num_steps,
                          max_batch=2, device="cpu", mesh=group, recorder=rec,
                          clock=VirtualClock(), lp_impl=lp_impl, elastic=elastic,
                          inject_fault=inject_fault)
    wl = build_workload(WorkloadSpec(rate_rps=rate, num_requests=num_requests,
                                     arrivals="deterministic", mix=parse_mix(mix)))
    group.counter.reset()
    ctx = torch.zeros((1, cfg.context_len, cfg.context_dim))
    res = run_workload(eng, wl, make_context=lambda a: ctx)
    return {"rows": rec.request_rows, "latents": {r.request_id: r.latent for r in res},
            "counts": group.counter.snapshot(), "now": eng.clock.now,
            "walls": [r.batch_wall_s for r in res], "slept": slept[0],
            "lp_impl": eng.lp_impl, "wire_shard": eng.wire_shard, "evictions": eng.evictions,
            "mesh_shape": eng._compiler.mesh_shape}
