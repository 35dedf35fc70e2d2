"""The chip smoke's own rules, on the CPU.

* ``chip_smoke.device_ms`` (the profiler faked) sums the kernel records
  of a profiled window of ``reps`` calls.  A window that holds other
  than ``reps`` times one call's records is taken again; one still
  short after 3 tries gives no number (None), and ``timed_case`` flags
  the case with ``profiler_short`` and writes its time as JSON null.
* Phases ``lp_ranks`` and ``hybrid_ranks`` (their scheduled requests
  included) at a reduced size on gloo worlds of CPU ranks, and phases
  ``serve_policy`` and ``serve_fleet`` in one process (the plain versions,
  the reduced DiT in f32; the fleet's arrival rates raised to the CPU's
  walls): their checks hold there too.
* ``same_report`` holds an offline SLO report to the live one byte for
  byte, apart from the load-test CLI's notes on the live serve.
"""
import importlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    # importable by name: phase lp_ranks sends its rank function to
    # spawned processes, which import chip_smoke (and no JAX)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke")


def _fake_profiler(monkeypatch, records_per_window):
    """``torch.profiler.profile`` replaced by a window whose kernel record
    count is ``records_per_window(calls)``, 2 us of device time each."""
    calls = []

    class Window:
        def __init__(self, activities):
            self.n = 0

        def __enter__(self):
            calls.append(self)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            count = records_per_window(self.n)
            return [SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, key="kernel",
                                    count=count, self_device_time_total=2.0 * count)]

    def fn():
        if calls:
            calls[-1].n += 1

    monkeypatch.setattr(torch.profiler, "profile", Window)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return fn, calls


def test_device_ms_full_window_gives_its_time(smoke, monkeypatch):
    fn, calls = _fake_profiler(monkeypatch, lambda n: 3 * n)      # 3 kernels a call
    assert smoke.device_ms(fn, reps=10) == pytest.approx(3 * 2.0 / 1e3)
    assert len(calls) == 2                                         # one call, then the window


def test_device_ms_short_window_gives_no_number(smoke, monkeypatch, capsys):
    # every window of 10 calls loses one record: the profiler's drop
    fn, calls = _fake_profiler(monkeypatch, lambda n: 3 * n - (n > 1))
    assert smoke.device_ms(fn, reps=10) is None
    assert len(calls) == 6                                          # 3 tries
    assert "no time is kept" in capsys.readouterr().out
    rec = smoke.timed_case({"case": "c", "ms": None, "plain_ms": 0.01})
    assert rec["profiler_short"] is True
    assert json.loads(json.dumps(rec))["ms"] is None
    assert smoke.num(None) == "null" and smoke.num(0.5, ".2f") == "0.50"
    assert smoke.timed_case({"ms": 0.2, "plain_ms": 0.01})["profiler_short"] is False


def test_device_ms_with_no_device_time_fails(smoke, monkeypatch):
    fn, _ = _fake_profiler(monkeypatch, lambda n: 0)
    with pytest.raises(smoke.SmokeFailure, match="no device time"):
        smoke.device_ms(fn, reps=4)


def test_kernel_union_counts_overlapping_spans_once(smoke):
    """Phase lp_ranks' busy share: ranks that share the card report
    kernel spans that overlap (a time-sliced kernel's span covers the
    other ranks' slices); their union counts each nanosecond once."""
    import numpy as np

    spans = [np.array([[0, 10], [20, 30]]), np.array([[5, 25], [40, 41]]),
             np.zeros((0, 2), np.int64)]
    union_s, sum_s = smoke.kernel_union_s(spans)
    assert union_s == pytest.approx(31e-9) and sum_s == pytest.approx(41e-9)
    assert smoke.kernel_union_s([]) == (0.0, 0.0)


def test_lp_ranks_phase_on_the_cpu(smoke, tmp_path, monkeypatch):
    """The phase's checks (each rank bit-equal to the one-process run, the
    bytes of the model, the launch counts: none on the CPU) on the
    reduced DiT, at a latent with all three dims usable at K 4."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit

    monkeypatch.setattr(smoke, "ROOT", tmp_path)          # the worlds' rendezvous files
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    rec, counts = smoke.lp_ranks(cfg, model, device="cpu", latent=(9, 8, 12))
    runs, scheduled = rec["runs"], rec["scheduled"]
    assert len(runs) == 2 * sum(len(r) for r in smoke.LP_WORLDS.values())
    assert all(r["bit_equal"] and r["bytes"] == r["model_bytes"] and r["bytes_ok"]
               and r["step_payloads_ok"] for r in runs)
    # the scheduled, recorded request of the K-4 world
    assert scheduled["run"] == "lp_ranks" and scheduled["spec"] == smoke.SCHEDULE
    assert scheduled["bit_equal"] and scheduled["bytes_ok"] and scheduled["same_plan"]
    assert scheduled["recorder_equals_counter"]
    assert sorted(counts) == sorted([f"lp_ranks:{n}" for w in smoke.LP_WORLDS.values()
                                     for n, _ in w] + ["lp_ranks:scheduled"])
    assert not any(v for c in counts.values() for v in c.values())


def test_hybrid_ranks_phase_on_the_cpu(smoke, tmp_path, monkeypatch):
    """The phase's checks (a 3 x 2 world bit-equal to the one-process run,
    the sharded wire to the unsharded one, the bytes of the model per tier,
    the eviction drill's outcome and latents, launches: none on the CPU)
    on the reduced DiT, at a latent with all three dims usable at K 3."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit

    monkeypatch.setattr(smoke, "ROOT", tmp_path)
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    rec, counts = smoke.hybrid_ranks(cfg, model, device="cpu", latent=(9, 8, 12))
    runs, scheduled = rec["runs"], rec["scheduled"]
    assert len(runs) == 2 * len(smoke.HYBRID_RUNS)
    assert all(r["bit_equal"] and r["bytes_ok"] and r["step_payloads_ok"] for r in runs)
    assert scheduled["bit_equal"] and scheduled["recorder_equals_counter"]
    assert scheduled["lp_impl"] == "halo_hybrid" and scheduled["wire_shard"] is True
    assert scheduled["sent"]["intra"] > 0
    assert [r["sharded_equals_unsharded"] for r in rec["runs"] if r["run"] == "fp32-shard"] \
        == [True, True]
    drill = rec["drill"]
    assert drill["left"] == [2, 3] and drill["bit_equal"] and drill["second_request_ok"]
    assert drill["outcome"][0][:3] == (1, 2, (2, 2)) and drill["ran_ok"]
    assert sorted(counts) == sorted([f"hybrid_ranks:{n}" for n, _, _ in smoke.HYBRID_RUNS]
                                    + ["hybrid_ranks:drill", "hybrid_ranks:scheduled"])
    assert not any(v for c in counts.values() for v in c.values())


def test_serve_policy_phase_on_the_cpu(smoke):
    """Phase serve_policy's checks (the explicit schedule's misses, trace,
    per-step wire bytes, serve counters and reconciliation; the
    single-segment schedule bit-equal to the fixed ``int8`` wire; ``auto``
    at 40 dB; launches: none on the CPU) on the reduced DiT, at a latent
    with all three dims usable at K 4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit, frontends
    from repro_torch.serving.engine import LPServingEngine, VideoRequest

    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    latent = (9, 8, 12)
    reqs = [VideoRequest(i, frontends.text_context(generator(100 + i, "cpu"), 1, cfg, "cpu"),
                         latent, seed=i) for i in range(2)]
    fixed = LPServingEngine(model, cfg, num_partitions=smoke.K, overlap_ratio=smoke.R,
                            num_steps=smoke.STEPS, max_batch=2, device="cpu", wire_codec="int8")
    for r in reqs:
        fixed.submit(dataclasses.replace(r))
    int8 = {r.request_id: r.latent for r in fixed.run()}
    rec, counts = smoke.serve_policy(cfg, model, reqs, int8, device="cpu", latent=latent)
    ex = rec["explicit"]
    assert ex["step_codecs"] == list(smoke.SCHEDULE_CODECS) and ex["step_cache_misses"] == 4
    assert ex["wire_steps_ok"] and ex["serve_counters_ok"] and ex["reconciliation_ok"]
    assert ex["trace_errors"] == [] and ex["wire_bytes"] < ex["fp32_halo_bytes"]
    assert rec["single_segment_bit_equal"] and rec["auto"]["spec"] != smoke.SCHEDULE
    assert rec["spans"]["flash_kernels"] == 0 and not any(counts.values())
    assert len(rec["recorder_cost_wall_s"]["bare"]) == 2


def test_rank_kernel_shapes_are_what_a_rank_passes(smoke, tmp_path):
    """The kernels phase holds int8_quantize and the wgmma kernel to their
    plain versions at ``rank_kernel_shapes``: the ranks of a halo world
    (the reduced DiT on the int8 wire, on the CPU) hand the wrappers
    exactly those shapes, one slab a quantize and one window's CFG pair an
    attention."""
    _check_rank_kernel_shapes(smoke, tmp_path, smoke.K, 1)


def test_hybrid_rank_kernel_shapes_are_what_a_rank_passes(smoke, tmp_path):
    """The same for the ranks of a 3 x 2 hybrid world (phase
    ``hybrid_ranks``): ``rank_kernel_shapes`` at K 3."""
    _check_rank_kernel_shapes(smoke, tmp_path, *smoke.HYBRID_MESH)


def _check_rank_kernel_shapes(smoke, tmp_path, M, T):
    import torch_dist_cases as cases
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_lp_world

    latent = (9, 8, 12)
    got = run_lp_world(cases.kernel_shapes_of_a_rank, M,
                       (latent, smoke.STEPS, smoke.R, "int8"), tp=T,
                       workdir=str(tmp_path), device="cpu", deadline_s=300)
    quant, attn = smoke.rank_kernel_shapes(get_config("wan21-dit-1.3b").reduced(), latent,
                                           size=M)
    assert len({F for _, F in quant}) == 3            # a round in each dim
    for rank in got:
        assert rank["quant"] == [(1,) + s for s in quant]
        assert rank["attn"] == [(2,) + s for s in attn]


def test_same_report_ignores_only_the_cli_notes(smoke):
    live = {"classes": {"standard": {"count": 2, "e2e_p50_s": 0.1}}, "makespan_s": 1.5,
            "source": "live", "warmed": True, "workload": {"seed": 0},
            "router": {"replicas": 2}}
    offline = {"classes": {"standard": {"count": 2, "e2e_p50_s": 0.1}}, "makespan_s": 1.5,
               "source": "trace"}
    assert smoke.same_report(live, offline)
    assert not smoke.same_report(live, {**offline, "makespan_s": 1.5000001})
    assert not smoke.same_report(live, {**offline, "replicas": {}})
    assert smoke.fleet_mix((9, 8, 12)) == \
        "i,shape=9x8x12,priority=interactive;s,shape=9x8x12,priority=standard,weight=2"


def test_serve_fleet_phase_on_the_cpu(smoke, tmp_path, monkeypatch):
    """Phase serve_fleet's checks (the replay's misses, launches per batch,
    clock advances and offline report; the fleet's kill, redispatch,
    stamps, replica rows, bit-equality to a bare engine and per-replica
    launches; the overload's sheds, degradation and restore; the CLI's
    reports) on the reduced DiT at a latent with all three dims usable at
    K 4, the arrival rates raised so that the CPU's short walls still
    queue, batch and shed."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.launch import loadtest
    from repro_torch.models import dit

    monkeypatch.setattr(smoke, "ROOT", tmp_path)          # the CLI's trace and reports
    monkeypatch.setattr(loadtest, "get_config", lambda name: get_config(name).reduced())
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    rec, counts = smoke.serve_fleet(cfg, model, device="cpu", latent=(9, 8, 12),
                                    rates={"a": 50.0, "b": 200.0, "c": 2000.0, "cli": 200.0})
    a, b, c = rec["a"], rec["b"], rec["c"]
    assert a["step_cache_misses"] == 0 and a["advances_s"] == a["batch_walls_s"]
    assert a["offline_equals_live"] and a["trace_errors"] == []
    assert b["states"] == ["healthy", "dead"] and b["stats"]["replica_deaths"] == 1
    assert b["first_batch_bit_equal"] and b["stamps_ok"] and b["rows_carry_replica"]
    assert b["report"]["disposition"]["accounted"] == smoke.FLEET_REQUESTS["b"]
    assert [x["killed"] for x in b["batches"]].count(True) == 1
    assert c["shed_ids"] and c["degrades"] and c["restored"]
    assert c["report"]["disposition"]["accounted"] == smoke.FLEET_REQUESTS["c"]
    assert rec["cli"]["offline_equals_live"] and rec["cli"]["router"]["states"][1] == "dead"
    assert (tmp_path / "chiprun_out" / "fleet_report_offline.json").exists()
    assert sorted(counts) == ["serve_fleet:a", "serve_fleet:b", "serve_fleet:c",
                              "serve_fleet:cli"]
    assert not any(v for n in counts.values() for v in n.values())
