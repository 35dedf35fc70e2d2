"""Hybrid LP x TP on 2-D gloo groups, on the CPU.

Worlds of ``M x T`` spawned processes (``launch/mesh.run_lp_world(...,
tp=T)``; rank ``m*T + t`` is LP group ``m``, tp rank ``t``), running the
rank functions of ``torch_dist_cases.py`` (which imports no JAX).  Inputs
come from numpy seeds; the denoiser ``0.5 x + 0.25`` is elementwise, so
no DiT rounding enters.

* The hybrid engine (``core/hybrid.lp_forward_halo_hybrid``) at 2x2, 3x2
  and 4x2, uncoded and through every codec of ``CODEC_NAMES``, with the
  wire sharded over the tp group and not, over steps that rotate dims and
  steps that thread residual state: every rank's output is the same,
  bit-equal between the sharded and the unsharded wire and to the port's
  ``simulate_halo_forward`` at K = M; each rank's residual state is its LP
  group's row of the mirror's, bit for bit.
* Bytes by tier: unsharded, each rank's step payloads equal
  ``lp_halo_hybrid_step_collectives`` and the tp tier carries nothing; the
  world's sent bytes equal ``comm_lp_halo_hybrid`` (T x the 1-D model).
  Sharded, each rank's step payloads equal
  ``lp_halo_sharded_step_collectives`` per tier, and the world's sent
  bytes per tier equal ``comm_lp_halo_sharded``'s ``inter`` / ``intra``.
  Exactly.
* The first step against the JAX package's ``lp_forward_halo_hybrid(
  wire_shard=True)`` on ``make_hybrid_mesh(3, 2)`` (8 fake XLA devices in a
  subprocess), uncoded and ``int8``: bit-equal.
* ``LPServingEngine(mesh=<3x2 group>)``: with the exact denoiser, every
  run bit-equal to the one-process engine (the wire mirror at K 3); with
  the reduced WAN DiT in f32, sharded and unsharded bit-equal to each
  other and within ``test_torch_engine.py``'s tolerances of the
  one-process engine (the ranks call the DiT window by window), <= 3
  step-cache misses a denoise, the bytes of the model.
* Eviction mid-request: ``int8-residual``, ``elastic=True``,
  ``inject_fault="dead:1@3"``: the world shrinks 3x2 -> 2x2 (4x2 -> 3x2)
  in the step hook, the evicted group's ranks leave (``Evicted``), the
  survivors finish with the outcome of the one-process engine under the
  same drill (bit-equal with the exact denoiser, within tolerance with
  the DiT) and serve a second request without a new eviction.
  ``observe_group_times`` fed different times on each rank: the ranks
  agree them (MAX), evict the same group and finish the request.
* ``serve --mesh 3x2 --elastic --inject-fault dead:1@2 --device cpu``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro_torch.comm.codecs import CODEC_NAMES
from repro_torch.comm.wire import rank_wire_state
from repro_torch.configs import get_config
from repro_torch.core import comm_model as cm
from repro_torch.core import hybrid as thybrid
from repro_torch.core import plan_uniform
from repro_torch.device import generator
from repro_torch.diffusion.cfg import cfg_combine
from repro_torch.distributed import collectives as coll
from repro_torch.launch import mesh as tmesh
from repro_torch.models import dit
from repro_torch.serving import engine as teng

ROTATING = (1, 9, 6, 10, 4)         # T, H and W usable at M 2-4: the dims rotate
ONE_DIM = (1, 9, 2, 2, 4)           # only T usable: 3 steps thread the residual state
R = 0.5
WIRES = (None,) + CODEC_NAMES
WORLDS = ((3, 2), (2, 2), (4, 2))
DEADLINE_S = 300
STEPS = 4
LATENT = (8, 8, 12)
DRILL = dict(wire_codec="int8-residual", elastic=True, inject_fault="dead:1@3")
EXACT_RUNS = (("fp32", None, False), ("fp32-shard", None, True), ("int8-shard", "int8", True),
              ("residual", "int8-residual", False), ("residual-shard", "int8-residual", True))
DIT_RUNS = (("fp32", None, False), ("fp32-shard", None, True), ("int8-shard", "int8", True),
            ("displaced-shard", "displaced:int8-residual", True))


def _wire_cases():
    out = []
    for i, codec in enumerate(WIRES):
        for shard in (False, True):
            out.append(dict(codec=codec, shape=ROTATING, seed=i, steps=4, eager=False,
                            guard=False, shard=shard, r=R))
            out.append(dict(codec=codec, shape=ONE_DIM, seed=20 + i, steps=3, eager=True,
                            guard=True, shard=shard, r=R))
    return out


WIRE_CASES = _wire_cases()
# (unsharded, sharded) index pairs of the same inputs
PAIRS = [(a, b) for a, ca in enumerate(WIRE_CASES) for b, cb in enumerate(WIRE_CASES)
         if not ca["shard"] and cb["shard"] and ca["codec"] == cb["codec"]
         and ca["shape"] == cb["shape"]]


def _pair_id(p):
    c = WIRE_CASES[p[0]]
    return f"{c['codec']}-{'rot' if c['shape'] == ROTATING else 'onedim'}"


def _contexts(cfg, n=2):
    rng = np.random.default_rng(7)
    return [(0.02 * rng.normal(size=(1, cfg.context_len, cfg.context_dim))).astype(np.float32)
            for _ in range(n)]


def _requests(cfg):
    ctx = _contexts(cfg)
    return [(0, ctx[0], LATENT, 0), (1, ctx[1], LATENT, 1)]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("hybrid_worlds")


@pytest.fixture(scope="module")
def wire_worlds(workdir):
    """One world per (M, T), every wire case inside it; at M >= 3 the
    exact-denoiser engine runs and the eviction drill follow (the evicted
    ranks keep their earlier results)."""
    cfg = get_config("wan21-dit-1.3b").reduced()
    out = {}
    for M, T in WORLDS:
        engine_args = (EXACT_RUNS, DRILL, _requests(cfg), STEPS, True) if M >= 3 else None
        out[(M, T)] = tmesh.run_lp_world(cases.hybrid_wire_world, M, (WIRE_CASES, engine_args),
                                         tp=T, workdir=str(workdir), device="cpu",
                                         deadline_s=DEADLINE_S)
    return out


def _comm_cfg(shape, steps):
    return cm.VDMCommConfig(latent_dims=tuple(shape[1:4]), latent_channels=shape[4],
                            patch_sizes=cases.PATCH, d_model=1, num_blocks=1,
                            num_steps=steps, bytes_per_el=4)


@pytest.mark.parametrize("world", WORLDS, ids=[f"{m}x{t}" for m, t in WORLDS])
@pytest.mark.parametrize("pair", PAIRS, ids=[_pair_id(p) for p in PAIRS])
def test_sharded_wire_equals_unsharded_and_the_mirror(wire_worlds, world, pair):
    M, T = world
    ranks = wire_worlds[world]
    outs, states, _ = cases.mirror_run(WIRE_CASES[pair[0]], M)
    for ci in pair:
        for w, got in enumerate(ranks):
            m = w // T
            res = got["wires"][ci]
            for i, want in enumerate(outs):
                assert cases.same(res["outs"][i], want), (ci, w, i)
            for i, want in enumerate(states):         # rank (m, t) holds row m, tp-replicated
                mine = dict(cases.flat_state(res["states"][i]))
                for path, leaf in cases.flat_state(rank_wire_state(want, m)):
                    assert cases.same(mine[path], leaf), (ci, w, i, path)


def _step_payloads(counts, i, tier):
    a = counts[i - 1]["tiers"][tier]["payload"] if i else dict.fromkeys(coll.KINDS, 0)
    b = counts[i]["tiers"][tier]["payload"]
    return _nonzero({k: b[k] - a[k] for k in b})


def _nonzero(payloads):
    return {k: v for k, v in payloads.items() if v}


@pytest.mark.parametrize("world", WORLDS, ids=[f"{m}x{t}" for m, t in WORLDS])
@pytest.mark.parametrize("pair", PAIRS, ids=[_pair_id(p) for p in PAIRS])
def test_tier_bytes_equal_the_comm_model(wire_worlds, world, pair):
    M, T = world
    ranks = wire_worlds[world]
    case = WIRE_CASES[pair[0]]
    codec = case["codec"] or "fp32"
    cfg = _comm_cfg(case["shape"], case["steps"])
    _, _, dims = cases.mirror_run(case, M)
    unsharded, sharded = ([r["wires"][ci]["counts"] for r in ranks] for ci in pair)
    for i, d in enumerate(dims):
        flat = cm.lp_halo_hybrid_step_collectives(cfg, M, T, R, d, codec=codec)
        split = cm.lp_halo_sharded_step_collectives(cfg, M, T, R, d, codec=codec)
        for w in range(M * T):
            assert _step_payloads(unsharded[w], i, "inter") == _nonzero(flat), (w, i)
            assert _step_payloads(unsharded[w], i, "intra") == {}, (w, i)
            assert _step_payloads(sharded[w], i, "inter") == _nonzero(split["inter"]), (w, i)
            assert _step_payloads(sharded[w], i, "intra") == _nonzero(split["intra"]), (w, i)
    assert sum(c[-1]["sent"] for c in unsharded) == cm.comm_lp_halo_hybrid(cfg, M, T, R,
                                                                           codec=codec)
    model = cm.comm_lp_halo_sharded(cfg, M, T, R, codec=codec)
    for tier in ("inter", "intra"):
        assert sum(c[-1]["tiers"][tier]["sent"] for c in sharded) == model[tier], tier
    assert sum(c[-1]["sent"] for c in sharded) == model["total"]


@pytest.mark.parametrize("world", WORLDS, ids=[f"{m}x{t}" for m, t in WORLDS])
def test_sharded_ppermute_shifts_the_ring(wire_worlds, world):
    """``sharded_ppermute`` over the lp ring, sharded over the tp group:
    every rank gets its left neighbour's tensor whole."""
    M, T = world
    for w, r in enumerate(wire_worlds[world]):
        m = w // T
        assert torch.equal(r["ppermute"], cases.case_latent((3, 5, 2), 80 + (m - 1) % M))


@pytest.mark.parametrize("world", WORLDS, ids=[f"{m}x{t}" for m, t in WORLDS])
def test_cfg_pair_split_over_the_tp_group(wire_worlds, world):
    """``tp_cfg_branch`` alternates the branch over the tp ranks and
    ``tp_cfg_combine`` gives every rank of a group the guided pair."""
    M, T = world
    for m in range(M):
        group = [wire_worlds[world][m * T + t]["cfg"] for t in range(T)]
        assert [g[0] for g in group] == [t % 2 for t in range(T)]
        want = cfg_combine(group[0][1], group[1][1], 4.0)
        assert all(torch.equal(g[2], want) for g in group)


def _one_process(dit_fn, cfg, runs):
    """The one-process engine (the wire mirror at K 3) on each run, and the
    drill off a mesh: the engine, its first and its second result."""
    ctx = _contexts(cfg)
    out = {}

    def engine(**kw):
        return teng.LPServingEngine(dit_fn, cfg, num_partitions=3, num_steps=STEPS,
                                    max_batch=1, device="cpu", **kw)

    for name, codec, _ in runs:
        eng = engine(wire_codec=codec, lp_impl="halo")
        eng.submit(teng.VideoRequest(0, torch.from_numpy(ctx[0]), LATENT, seed=0))
        out[name] = eng.run()[0].latent
    eng = engine(**DRILL)
    eng.submit(teng.VideoRequest(0, torch.from_numpy(ctx[0]), LATENT, seed=0))
    first = eng.run()[0]
    eng.submit(teng.VideoRequest(1, torch.from_numpy(ctx[1]), LATENT, seed=1))
    out["drill"] = (eng, first, eng.run()[0])
    return out


def _left(r) -> bool:
    """Did this rank's LP group leave (``Evicted``, or recorded beside the
    rank's runs)?"""
    return isinstance(r, tmesh.Evicted) or "evicted" in r


def _check_drill(results, T, ref, exact):
    """Every rank's drill against the one-process drill ``ref``: group 1's
    ranks left before step 3, the survivors shrank to (M-1, T) and match."""
    eng, first, second = ref
    M = len(results) // T
    evicted = [w for w, r in enumerate(results) if _left(r)]
    assert evicted == [T + t for t in range(T)]
    for w in evicted:
        r = results[w]
        assert ((r.group, r.step) if isinstance(r, tmesh.Evicted) else r["evicted"]) == (1, 3)
    assert eng.evictions == 1 and eng.K == 2
    for w, r in enumerate(results):
        if w in evicted:
            continue
        d, a = r["drill"], r["after"]
        assert (d["evictions"], d["K"], d["mesh_shape"], d["last_steps_lost"]) == \
            (1, M - 1, (M - 1, T), 0)
        assert (d["restarts"], d["resumed_from_step"]) == (first.restarts,
                                                           first.resumed_from_step)
        assert d["restarts"] >= 1
        assert d["lp_size"] == M - 1 and d["lp_rank"] == (w // T) - (w // T > 1)
        assert (a["evictions"], a["restarts"]) == (1, 0)
        for got, want in ((d["latent"], first.latent), (a["latent"], second.latent)):
            if exact:
                assert torch.equal(got, want)
            else:
                _close(got, want, coded=True)


def _close(got, want, coded):
    """``test_torch_engine.py``'s tolerances: 1e-4 uncoded; within one
    code step on 99% of the values and everywhere within the largest."""
    got, want = got.numpy(), want.numpy()
    if not coded:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    d = np.abs(got - want)
    assert d.max() <= 1e-4 + np.abs(want).max() / 127, d.max()
    assert (d > 1e-4 + 1e-4 * np.abs(want)).mean() <= 0.01


def test_exact_engine_equals_one_process(wire_worlds):
    cfg = get_config("wan21-dit-1.3b").reduced()
    ref = _one_process(cases.exact_dit, cfg, EXACT_RUNS)
    for name, codec, shard in EXACT_RUNS:
        for r in wire_worlds[(3, 2)]:
            run = r["engine"]["runs"][name]
            assert torch.equal(run["latent"], ref[name]), (name,)
            assert run["lp_impl"] == "halo_hybrid" and run["eager_sends"] is True
            assert run["wire_shard"] is shard and run["compiles"] <= 3
    _check_drill([r["engine"] for r in wire_worlds[(3, 2)]], 2, ref["drill"], exact=True)
    # 4x2 -> 3x2: group 1's ranks leave, the six others finish alike
    results = [r["engine"] for r in wire_worlds[(4, 2)]]
    assert [w for w, r in enumerate(results) if _left(r)] == [2, 3]
    alive = [r["drill"] for r in results if not _left(r)]
    assert all(d["mesh_shape"] == (3, 2) and d["evictions"] == 1 for d in alive)
    assert all(torch.equal(d["latent"], alive[0]["latent"]) for d in alive)


def test_evicted_ranks_leave_their_world(workdir):
    """Uncaught, ``GroupEvicted`` ends the ranks of the evicted group and
    ``run_lp_world`` counts it as their success (``Evicted``); the
    survivors' drill equals the one-process drill bit for bit."""
    cfg = get_config("wan21-dit-1.3b").reduced()
    ranks = tmesh.run_lp_world(cases.hybrid_engine_runs, 3,
                               ((), DRILL, _requests(cfg), STEPS, True, True), tp=2,
                               workdir=str(workdir), device="cpu", deadline_s=DEADLINE_S)
    assert ranks[2:4] == [tmesh.Evicted(2, 1, 3), tmesh.Evicted(3, 1, 3)]
    _check_drill(ranks, 2, _one_process(cases.exact_dit, cfg, ())["drill"], exact=True)


@pytest.fixture(scope="module")
def dit_world(workdir):
    cfg = get_config("wan21-dit-1.3b").reduced()
    return tmesh.run_lp_world(cases.hybrid_engine_runs, 3,
                              (DIT_RUNS, DRILL, _requests(cfg), STEPS), tp=2,
                              workdir=str(workdir), device="cpu", deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def dit_one_process():
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    return cfg, _one_process(model, cfg, DIT_RUNS)


@pytest.mark.parametrize("ri", range(len(DIT_RUNS)), ids=[r[0] for r in DIT_RUNS])
def test_dit_engine_on_a_3x2_group(dit_world, dit_one_process, ri):
    cfg, ref = dit_one_process
    name, codec, shard = DIT_RUNS[ri]
    runs = [r["runs"][name] for r in dit_world]
    assert len(runs) == 6 and all(torch.equal(x["latent"], runs[0]["latent"]) for x in runs)
    if name == "fp32-shard":                          # the sharded wire moves bytes only
        assert torch.equal(runs[0]["latent"], dit_world[0]["runs"]["fp32"]["latent"])
    _close(runs[0]["latent"], ref[name], coded=codec is not None)
    ccfg = _comm_cfg((1, *LATENT, cfg.latent_channels), STEPS)
    sent = {t: sum(x["counts"]["tiers"][t]["sent"] for x in runs) for t in ("inter", "intra")}
    if shard:
        model = cm.comm_lp_halo_sharded(ccfg, 3, 2, R, codec=codec or "fp32")
        assert sent == {"inter": model["inter"], "intra": model["intra"]}
    else:
        assert sent == {"inter": cm.comm_lp_halo_hybrid(ccfg, 3, 2, R, codec=codec or "fp32"),
                        "intra": 0}
    assert all(x["compiles"] <= 3 and x["lp_impl"] == "halo_hybrid" for x in runs)


def test_dit_eviction_drill_shrinks_3x2_to_2x2(dit_world, dit_one_process):
    _check_drill(dit_world, 2, dit_one_process[1]["drill"], exact=False)


def test_serve_cli_with_a_2d_mesh_and_an_eviction(workdir):
    argv = ["--device", "cpu", "--mesh", "3x2", "--partitions", "3", "--requests", "1",
            "--steps", "3", "--frames-latent", "8", "--wire-codec", "int8", "--elastic",
            "--inject-fault", "dead:1@2"]
    outs = tmesh.run_lp_world(cases.serve_cli, 3, (argv,), tp=2, workdir=str(workdir),
                              device="cpu", deadline_s=DEADLINE_S)
    assert "engine: lp_impl=halo_hybrid codec=int8 tp=2 wire_shard=True" in outs[0]
    assert "eager_sends=True ranks=6 backend=gloo" in outs[0]
    assert "fault drill: dead:1@2 (elastic=True" in outs[0]
    assert "request 0: latent (1, 8, 8, 12, 4)" in outs[0] and "restarts=2" in outs[0]
    assert "elastic: evictions=1 K=2 steps_lost=0" in outs[0]
    assert outs[1:] == [""] * 5                    # only rank 0 prints


def test_diverging_health_inputs_fail_the_world(workdir):
    """Ranks fed different health times no longer fail their world: the
    engine agrees the times before its monitor sees them (an elementwise
    MAX over the lp and tp groups), so on a 3 x 2 world where world rank 0
    alone sees group 2 as a straggler, both of group 2's ranks leave in the
    same step hook and the four survivors shrink to 2 x 2 and finish the
    request bit-equal to the one-process engine fed the agreed times."""
    cfg = get_config("wan21-dit-1.3b").reduced()
    latent = (9, 8, 12)
    ranks = tmesh.run_lp_world(cases.agreed_monitor, 3, (2, STEPS, latent), tp=2,
                               workdir=str(workdir), device="cpu", deadline_s=DEADLINE_S)
    assert [w for w, r in enumerate(ranks) if _left(r)] == [4, 5]
    assert len({(r.group, r.step) for r in ranks[4:]}) == 1 and ranks[4].group == 2
    alive = ranks[:4]
    assert all(r["agreed"] == [1.05, 1.05, 9.0] for r in alive)
    assert all((r["evictions"], r["K"], r["mesh_shape"]) == (1, 2, (2, 2)) for r in alive)
    eng = teng.LPServingEngine(cases.exact_dit, cfg, num_partitions=3, num_steps=STEPS,
                               max_batch=1, device="cpu", elastic=True, lp_impl="halo")
    for _ in range(5):
        eng.observe_group_times(alive[0]["agreed"])
    eng.submit(teng.VideoRequest(0, torch.zeros((1, cfg.context_len, cfg.context_dim)),
                                 latent, seed=0))
    want = eng.run()[0]
    assert eng.evictions == 1 and eng.K == 2
    assert all(torch.equal(r["latent"], want.latent) for r in alive)
    assert all(r["restarts"] == want.restarts for r in alive)


# ------------------------------------------------------------ one process
def test_wire_shard_helpers_equal_the_reference():
    """``wire_shard_slice`` / ``wire_unshard`` / ``wire_unshard_rows`` on
    int8, int16 (the bf16 wire), packed int4 and f32 payloads: the chunks
    are the reference's, bit for bit, and unsharding inverts them."""
    import jax.numpy as jnp
    from repro.distributed import collectives as jcoll

    rng = np.random.default_rng(3)
    for dtype, shape in ((np.int8, (7, 5, 3)), (np.int16, (4, 9)), (np.int8, (3, 2, 2)),
                         (np.float32, (5, 3, 4))):
        x = rng.integers(-100, 100, size=shape).astype(dtype)
        for T in (2, 3, 4):
            chunks = [coll.wire_shard_slice(torch.from_numpy(x), t, T) for t in range(T)]
            for t, c in enumerate(chunks):
                assert np.array_equal(c.numpy(), np.asarray(jcoll.wire_shard_slice(
                    jnp.asarray(x), jnp.asarray(t), T)))
            stack = torch.stack(chunks)
            assert torch.equal(coll.wire_unshard(stack, shape), torch.from_numpy(x))
            rows = torch.stack([torch.stack([coll.wire_shard_slice(
                torch.from_numpy(x) + k, t, T) for k in range(3)]) for t in range(T)])
            want = np.asarray(jcoll.wire_unshard_rows(jnp.asarray(rows.numpy()), shape))
            assert np.array_equal(coll.wire_unshard_rows(rows, shape).numpy(), want)
            assert np.array_equal(want, np.stack([x + k for k in range(3)]))


def test_groups_and_the_one_process_composition_equal_the_reference():
    """``make_groups`` and ``hybrid_forward`` (Eq. 42-43, paper-exact
    partitions, one Phi_m a group) against the reference's."""
    import jax.numpy as jnp
    from repro.core import hybrid as jhybrid

    import dataclasses

    assert dataclasses.astuple(thybrid.make_groups(6, 3)) == \
        dataclasses.astuple(jhybrid.make_groups(6, 3))
    with pytest.raises(ValueError, match="must split"):
        thybrid.make_groups(5, 2)
    z = np.random.default_rng(4).normal(size=(2, 26, 3, 4)).astype(np.float32)
    scales = (0.5, 0.75, 1.25)
    got = thybrid.hybrid_forward([lambda s, a=a: a * s + 0.25 for a in scales],
                                 torch.from_numpy(z), 1, 2, 0.5)
    want = jhybrid.hybrid_forward([lambda s, a=a: a * s + 0.25 for a in scales],
                                  jnp.asarray(z), 1, 2, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_group_checks_and_refusals():
    """What the reference refuses (``shrink_hybrid_mesh``, the hybrid spec,
    the engine's wire-shard pins), refused here before any collective."""
    cpu = torch.device("cpu")
    lp = coll.LPGroup(rank=0, size=3, device=cpu, ranks=(0, 2, 4), tier="inter")
    tp = coll.LPGroup(rank=0, size=2, device=cpu, ranks=(0, 1), tier="intra")
    mesh = coll.HybridGroup(lp, tp)
    assert (mesh.rank, mesh.size, mesh.mesh_shape, mesh.tp_rank) == (0, 3, (3, 2), 0)
    assert lp.world_rank(2) == 4
    with pytest.raises(ValueError, match="expected 4"):
        tmesh.shrink_hybrid_group(mesh, 1, tp=4)
    with pytest.raises(ValueError, match="not in"):
        tmesh.shrink_hybrid_group(mesh, 3)
    small = coll.HybridGroup(coll.LPGroup(rank=0, size=2, device=cpu), tp)
    with pytest.raises(ValueError, match="below 2 groups"):
        tmesh.shrink_hybrid_group(small, 1)
    plan = plan_uniform(9, 1, 3, R, 0)
    spec = thybrid.hybrid_halo_spec(plan, mesh)
    assert spec.mesh_shape == (3, 2) and thybrid.hybrid_halo_spec(plan, lp).mesh_shape == (3, 1)
    with pytest.raises(ValueError, match="M=4"):
        thybrid.hybrid_halo_spec(plan_uniform(9, 1, 4, R, 0), mesh)
    with pytest.raises(ValueError, match="must differ"):
        coll.check_shard(lp, lp)
    cfg = get_config("wan21-dit-1.3b").reduced()
    eng = teng.LPServingEngine(cases.exact_dit, cfg, num_partitions=3, device="cpu",
                               mesh=mesh)
    assert (eng.lp_impl, eng.tp, eng.wire_shard, eng.eager_sends) == \
        ("halo_hybrid", 2, True, True)
    assert eng._compiler.mesh_shape == (3, 2) and eng._compiler.wire_shard
    psum = teng.LPServingEngine(cases.exact_dit, cfg, num_partitions=2, device="cpu",
                                mesh=small)
    assert (psum.lp_impl, psum.wire_shard, psum.eager_sends) == ("shard_map", False, False)
    with pytest.raises(ValueError, match="needs the mesh-bound halo family"):
        teng.LPServingEngine(cases.exact_dit, cfg, num_partitions=2, device="cpu",
                             mesh=small, wire_shard=True)
    with pytest.raises(ValueError, match="no tp axis"):
        teng.LPServingEngine(cases.exact_dit, cfg, num_partitions=3, device="cpu",
                             wire_shard=True)
    off = teng.LPServingEngine(cases.exact_dit, cfg, num_partitions=3, device="cpu",
                               wire_codec="int8")
    assert (off.lp_impl, off.wire_shard, off.eager_sends) == ("halo", False, False)


# ------------------------------------------------- against the JAX package
REFERENCE_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.core import plan_uniform
from repro.core.hybrid import lp_forward_halo_hybrid
from repro.launch.mesh import make_hybrid_mesh

out = {}
mesh = make_hybrid_mesh(3, 2)
for name, codec, shape, seed, r, dim, patch in json.loads(sys.argv[2]):
    z = jnp.asarray(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    plan = plan_uniform(shape[1 + dim], patch, 3, r, dim)
    fn = lambda x: 0.5 * x + 0.25
    with compat.set_mesh(mesh):
        step = jax.jit(lambda zz: lp_forward_halo_hybrid(fn, zz, plan, 1 + dim, mesh, "data",
                                                         "model", codec=codec,
                                                         wire_shard=True))
        out[name] = np.asarray(step(z))
np.savez(sys.argv[1], **out)
"""


def test_first_hybrid_step_equals_the_jax_package(wire_worlds, tmp_path):
    """The reference's ``lp_forward_halo_hybrid(wire_shard=True)`` on
    ``make_hybrid_mesh(3, 2)`` (8 fake XLA devices in a subprocess),
    uncoded and ``int8``, on the same numpy-seeded latents and denoiser:
    the first step of every rank of the 3x2 world is bit-equal to it."""
    root = Path(__file__).resolve().parents[1]
    runs, got = [], {}
    for ci, c in enumerate(WIRE_CASES):
        if c["shape"] == ROTATING and c["shard"] and c["codec"] in (None, "int8"):
            z = cases.case_latent(c["shape"], c["seed"])
            _, d, _ = next(cases.step_plans(z, 3, R, 1))
            name = f"hybrid_{c['codec']}"
            runs.append((name, c["codec"], list(c["shape"]), c["seed"], R, d, cases.PATCH[d]))
            got[name] = [w["wires"][ci]["outs"][0] for w in wire_worlds[(3, 2)]]
    out = tmp_path / "reference.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT, str(out), json.dumps(runs)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(out)
    assert sorted(want.files) == sorted(got) and len(got) == 2
    for name, outs in got.items():
        for w, o in enumerate(outs):
            assert np.array_equal(o.numpy(), want[name]), (name, w)
