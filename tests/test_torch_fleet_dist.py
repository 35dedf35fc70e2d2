"""Open-loop replay across ranks: the engine's ranks agree on each batch's
wall, on gloo worlds on the CPU.

Every rank of a world replays the same seeded workload through
``loadgen.run_workload`` on its own ``VirtualClock``, and the test's
stand-in DiT sleeps a rank-dependent time a call, so each rank measures a
different wall.  A world of 2 ranks (K 2, the psum engine) and one of 2 x 2
(a ``HybridGroup``, ``lp_impl="halo_hybrid"``, the wire sharded over tp):

* every rank's lifecycle rows are equal (admissions, batches and stamps),
  its clock reads the slowest rank's walls, and every batch wall is at
  least the slowest rank's sleep; the arrivals (every 0.05 s) come faster
  than a batch, so batches of 2 form, and which requests ride together
  depends on the wall the clocks advanced by;
* the latents are bit-equal to the one-process engine's (the stand-in DiT
  is elementwise, so windows and batches change no value);
* the byte counters still equal ``core/comm_model``: the agreement's MAX
  all-reduce goes through no counter (the psum world counts exactly one
  all-reduce a step and batch).

Then a 3 x 2 world replays with the eviction drill (``elastic``,
``dead:1@2``): group 1's ranks leave in the first batch, and the four
survivors, whose agreement now runs on their shrunken group, serve every
request with equal rows, clocks and latents.
"""
import pytest
import torch

import torch_dist_cases as cases
from repro_torch.configs import get_config
from repro_torch.core import comm_model as cm
from repro_torch.launch import mesh as tmesh
from repro_torch.serving import engine as teng
from repro_torch.serving.loadgen import WorkloadSpec, build_workload, parse_mix

MIX = "i,shape=4x8x12,priority=interactive;s,shape=4x8x12,priority=standard,weight=2"
RATE, REQUESTS, STEPS, SKEW_S, R = 20.0, 5, 2, 0.03, 0.5
WORLDS = {"psum_2": (2, 1, "auto"), "hybrid_2x2": (2, 2, "halo_hybrid")}
DEADLINE_S = 300


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for name, (M, T, lp_impl) in WORLDS.items():
        out[name] = tmesh.run_lp_world(cases.fleet_replay, M,
                                       (MIX, RATE, REQUESTS, STEPS, SKEW_S, lp_impl), tp=T,
                                       workdir=str(tmp_path_factory.mktemp(name)),
                                       device="cpu", deadline_s=DEADLINE_S)
    return out


@pytest.fixture(scope="module")
def one_process():
    """Each request of the workload alone through a one-process engine."""
    cfg = get_config("wan21-dit-1.3b").reduced()
    wl = build_workload(WorkloadSpec(rate_rps=RATE, num_requests=REQUESTS,
                                     arrivals="deterministic", mix=parse_mix(MIX)))
    out = {}
    for a in wl:
        eng = teng.LPServingEngine(cases.exact_dit, cfg, num_partitions=2, num_steps=STEPS,
                                   device="cpu")
        eng.submit(teng.VideoRequest(a.request_id,
                                     torch.zeros((1, cfg.context_len, cfg.context_dim)),
                                     a.cls.latent_shape, seed=a.seed))
        out[a.request_id] = eng.run()[0].latent
    return cfg, out


@pytest.mark.parametrize("name", list(WORLDS))
def test_ranks_agree_on_the_timeline(worlds, name):
    ranks = worlds[name]
    M, T, _ = WORLDS[name]
    assert len(ranks) == M * T
    rows = ranks[0]["rows"]
    assert len(rows) == REQUESTS and len({r["batch_seq"] for r in rows}) < REQUESTS
    slowest = SKEW_S * M * T * STEPS           # the last rank's sleep a batch
    for r in ranks:
        assert r["rows"] == rows and r["now"] == ranks[0]["now"]
        assert r["walls"] == ranks[0]["walls"] and min(r["walls"]) >= slowest
    assert len({round(r["slept"], 6) for r in ranks}) == M * T     # the walls differ


@pytest.mark.parametrize("name", list(WORLDS))
def test_latents_equal_one_process(worlds, one_process, name):
    _, want = one_process
    for r in worlds[name]:
        assert sorted(r["latents"]) == list(range(REQUESTS))
        for rid, lat in r["latents"].items():
            assert torch.equal(lat, want[rid]), rid


@pytest.mark.parametrize("name", list(WORLDS))
def test_bytes_still_equal_the_comm_model(worlds, one_process, name):
    cfg, _ = one_process
    ranks = worlds[name]
    M, T, _ = WORLDS[name]
    ccfg = cm.VDMCommConfig(latent_dims=(4, 8, 12), latent_channels=cfg.latent_channels,
                            patch_sizes=cases.PATCH, d_model=1, num_blocks=1, num_steps=STEPS,
                            bytes_per_el=4)
    batches = len({r["batch_seq"] for r in ranks[0]["rows"]})
    if name == "psum_2":
        assert ranks[0]["lp_impl"] == "shard_map"
        for r in ranks:              # one latent all-reduce a step and batch, nothing more
            assert r["counts"]["calls"]["all-reduce"] == STEPS * batches
        payload = sum(r["counts"]["payload"]["all-reduce"] for r in ranks)
        assert payload % REQUESTS == 0
        assert cm.collective_wire_bytes("all-reduce", payload // REQUESTS, M) == \
            cm.comm_lp_spmd(ccfg, M, R)
    else:
        assert ranks[0]["lp_impl"] == "halo_hybrid" and ranks[0]["wire_shard"] is True
        model = cm.comm_lp_halo_sharded(ccfg, M, T, R, codec="fp32")
        sent = {t: sum(r["counts"]["tiers"][t]["sent"] for r in ranks)
                for t in ("inter", "intra")}
        assert sent == {"inter": REQUESTS * model["inter"], "intra": REQUESTS * model["intra"]}
        assert all(r["counts"]["calls"]["all-reduce"] == 0 for r in ranks)


@pytest.fixture(scope="module")
def drill_world(tmp_path_factory):
    return tmesh.run_lp_world(cases.fleet_replay, 3,
                              (MIX, RATE, REQUESTS, 3, SKEW_S, "auto", True, "dead:1@2"), tp=2,
                              workdir=str(tmp_path_factory.mktemp("drill")), device="cpu",
                              deadline_s=DEADLINE_S)


def test_survivors_agree_after_an_eviction(drill_world):
    left = [r for r in drill_world if isinstance(r, tmesh.Evicted)]
    assert [(e.rank, e.group) for e in left] == [(2, 1), (3, 1)]
    alive = [r for r in drill_world if not isinstance(r, tmesh.Evicted)]
    assert len(alive) == 4
    rows = alive[0]["rows"]
    assert sorted(r["request_id"] for r in rows) == list(range(REQUESTS))
    for r in alive:
        assert r["evictions"] == 1 and r["mesh_shape"] == (2, 2)
        assert r["rows"] == rows and r["now"] == alive[0]["now"]
        assert r["walls"] == alive[0]["walls"]
        for rid, lat in r["latents"].items():
            assert torch.equal(lat, alive[0]["latents"][rid])
