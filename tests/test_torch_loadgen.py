"""The port's load harness (``repro_torch/serving/loadgen.py``), the engine's
clock and fleet surface, and the ``loadtest`` CLI, against the JAX
package, on the CPU.

* The copies: ``build_workload`` / ``workload_digest`` give the same
  arrivals and digest as the reference over Poisson and deterministic
  arrivals, 3 seeds and 3 mixes (exact); ``parse_mix`` the same classes
  and the same error messages; ``VirtualClock`` the same readings and the
  same refusals; ``run_workload`` refuses a wall clock with the
  reference's message.
* The engine's clock (``clock=``): every lifecycle stamp (submit, admit,
  denoise start, done, failed) reads it, a fake clock shows each one;
  ``submit(submit_s=)`` stamps a mid-batch arrival at its arrival
  (``tests/test_serving_load.py:228``); ``_inflight`` holds the batch that
  died; ``replica_id`` labels every ``serve.*`` series and the lifecycle
  rows, and a bare engine keeps its schema.
* A real-engine replay (reduced DiT, f32) on both packages, each on a
  ``VirtualClock`` subclass that advances a fixed 0.5 s whatever the wall:
  the lifecycle rows are equal exactly, so are the SLO reports and the
  label sets of the metrics; the latents are within
  ``test_torch_engine.py``'s tolerance; in each package the offline report
  equals the live one byte for byte.
* ``python -m repro_torch.launch.loadtest --device cpu`` with the reduced
  config patched in, at ``--replicas 1`` and at ``--replicas 2
  --inject-fault replica:1:dead@1``; ``--report-from`` the trace gives the
  live report.
"""
import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.models import dit as jdit
from repro.obs import FlightRecorder as JRecorder
from repro.obs import slo as jslo
from repro.serving import loadgen as jload
from repro.serving.engine import LPServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.launch import loadtest
from repro_torch.models import dit as tdit
from repro_torch.obs import FlightRecorder
from repro_torch.obs import metrics as obsm
from repro_torch.obs import slo as tslo
from repro_torch.obs.clock import perf_s
from repro_torch.runtime.faults import ReplicaDeath, parse_fault_plan
from repro_torch.runtime.ft import DeviceFailure
from repro_torch.serving import engine as teng
from repro_torch.serving import loadgen as tload

SHAPE = (4, 8, 12)
MIXES = {
    "default": None,
    "two": "i,shape=4x8x12,priority=interactive;s,shape=4x8x12,priority=standard,weight=2",
    "three": "clip,shape=6x8x12,priority=interactive,weight=1,guidance=7.5;"
             "std,shape=4x8x12,weight=3;bulk,shape=13x30x52,priority=batch,psnr=40,weight=0.5",
}


def _errors(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:              # the error type and its message count
        return ("raise", type(e).__name__, str(e))


def _arrival_fields(workload):
    return [(a.request_id, a.arrival_s, a.seed, dataclasses.asdict(a.cls)) for a in workload]


# ------------------------------------------------------------- the copies
@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("arrivals", ["poisson", "deterministic"])
def test_workload_and_digest_as_the_reference(arrivals, seed, mix):
    def build(m):
        spec = m.WorkloadSpec(rate_rps=3.0, num_requests=24, arrivals=arrivals, seed=seed,
                              mix=m.parse_mix(MIXES[mix]))
        wl = m.build_workload(spec)
        return _arrival_fields(wl), m.workload_digest(wl)

    port, ref = build(tload), build(jload)
    assert port == ref
    assert len(port[1]) == 64


MIX_SPECS = [
    None, "  ", MIXES["two"], MIXES["three"],
    "clip,shape=6x8x12,priority=interactive,weight=2,guidance=7.5;bulk,shape=4x8x12,psnr=40",
    "clip,priority=interactive", "clip,shape=6x8x12,frames=6", "shape=6x8x12",
    "clip,shape=6xWRONGx12", "clip,shape=6x8", "clip,shape=6x8x12,weight=0",
    "clip,shape=0x8x12", "clip,shape", ";;", "clip,shape=6x8x12,psnr=high",
]


@pytest.mark.parametrize("spec", MIX_SPECS)
def test_parse_mix_as_the_reference(spec):
    def parse(m):
        got = _errors(m.parse_mix, spec)
        if got[0] == "ok":
            return ("ok", [dataclasses.asdict(c) for c in got[1]])
        return got

    assert parse(tload) == parse(jload)


@pytest.mark.parametrize("kw", [dict(rate_rps=0.0, num_requests=1),
                                dict(rate_rps=1.0, num_requests=0),
                                dict(rate_rps=1.0, num_requests=1, arrivals="uniform"),
                                dict(rate_rps=1.0, num_requests=1, mix=())])
def test_workload_spec_refusals_as_the_reference(kw):
    assert _errors(tload.WorkloadSpec, **kw) == _errors(jload.WorkloadSpec, **kw)
    assert _errors(tload.WorkloadSpec, **kw)[0] == "raise"


def test_virtual_clock_as_the_reference():
    def drive(m):
        clk, seen = m.VirtualClock(0.25), []
        for op, v in (("advance", 1.5), ("advance_to", 1.0), ("advance_to", 2.0),
                      ("advance", 0.0), ("advance", -0.1), ("advance_to", -5.0)):
            seen.append(_errors(getattr(clk, op), v))
            seen.append(clk())
        return seen, clk.now

    port = drive(tload)
    assert port == drive(jload)
    assert port[1] == 2.0 and port[0][8][0] == "raise"      # never rewinds, refuses dt < 0


def test_run_workload_rejects_wall_clock_engine():
    wl = tload.build_workload(tload.WorkloadSpec(rate_rps=1.0, num_requests=1))
    msgs = []
    for m in (tload, jload):
        with pytest.raises(ValueError, match="VirtualClock") as e:
            m.run_workload(types.SimpleNamespace(clock=perf_s, _queue=[]), wl)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------- the engine's fleet surface
@pytest.fixture(scope="module")
def port_model():
    cfg = get_config("wan21-dit-1.3b").reduced()
    from repro_torch.device import generator

    return cfg, tdit.init_params(cfg, generator(0, "cpu"), "cpu")


def _ctx(cfg, seed):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.normal(size=(1, cfg.context_len, cfg.context_dim))).astype(np.float32)


class TickClock:
    """Reads 10, 20, 30, ... seconds, one tick a call."""

    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return 10.0 * self.calls


@pytest.mark.parametrize("stamp", ["submit_s", "admit_s", "denoise_start_s", "done_s",
                                   "failed_s"])
def test_every_lifecycle_stamp_reads_the_clock(port_model, stamp):
    """Each stamp is one tick of the engine's clock, in lifecycle order; a
    batch that exhausts its restarts stamps its failure with it too."""
    cfg, model = port_model
    rec, clock = FlightRecorder(), TickClock()
    eng = teng.LPServingEngine(model, cfg, num_partitions=2, num_steps=2, device="cpu",
                               recorder=rec, clock=clock)
    eng.submit(teng.VideoRequest(0, torch.from_numpy(_ctx(cfg, 0)), SHAPE, seed=0))
    if stamp == "failed_s":
        def fault(step):
            raise DeviceFailure("injected device loss")

        eng._step_fault = fault
        with pytest.raises(DeviceFailure):
            eng.run(max_restarts_per_batch=0)
        failed = [e["args"] for e in rec.trace.events if e["name"] == "request.failed"]
        # submit 10, admit 20, denoise start 30, failed 40
        assert [f["failed_s"] for f in failed] == [40.0] and failed[0]["submit_s"] == 10.0
        assert eng._inflight and eng._inflight[0].request_id == 0
        return
    res = eng.run()[0]
    row = rec.request_rows[0]
    want = {"submit_s": 10.0, "admit_s": 20.0, "denoise_start_s": 30.0, "done_s": 40.0}
    assert row[stamp] == want[stamp] and clock.calls == 4
    assert res.queue_wait_s == 10.0 and res.e2e_s == 30.0 and eng._inflight == []


def test_replica_death_leaves_the_batch_in_flight(port_model):
    cfg, model = port_model
    eng = teng.LPServingEngine(model, cfg, num_partitions=2, num_steps=2, device="cpu")
    eng._fault_plan = parse_fault_plan("replica:0:dead@2").for_replica(0)
    for i in (0, 1):
        eng.submit(teng.VideoRequest(i, torch.from_numpy(_ctx(cfg, i)), SHAPE, seed=i))
    with pytest.raises(ReplicaDeath):
        eng.run()
    assert [r.request_id for r in eng._inflight] == [0, 1]
    with pytest.raises(ValueError, match="serving/router.ReplicaRouter"):
        teng.LPServingEngine(model, cfg, num_partitions=2, device="cpu",
                             inject_fault="replica:0:dead@1")


def test_replica_labels_and_the_bare_schema(port_model):
    """A bare engine's series carry no ``replica`` label; with
    ``replica_id`` every ``serve.*`` series, the rejected instant and the
    lifecycle row carry it."""
    cfg, model = port_model
    labels = {}
    for rid in (None, 3):
        rec = FlightRecorder()
        eng = teng.LPServingEngine(model, cfg, num_partitions=2, num_steps=2, device="cpu",
                                   max_batch=2, max_queue=2, recorder=rec, replica_id=rid)
        for i in range(3):
            try:
                eng.submit(teng.VideoRequest(i, torch.from_numpy(_ctx(cfg, i)), SHAPE, seed=i))
            except teng.QueueFull:
                pass
        eng.run()
        serve = [r for r in rec.metrics.snapshot() if r["name"].startswith("serve.")]
        labels[rid] = {(r["name"], r["labels"].get("replica")) for r in serve}
        rejected = [e["args"] for e in rec.trace.events if e["name"] == "request.rejected"]
        assert len(rejected) == 1 and rejected[0].get("replica") == (None if rid is None
                                                                     else "3")
        assert all(row.get("replica") == rid for row in rec.request_rows)
    assert {r for _, r in labels[None]} == {None}
    assert {r for _, r in labels[3]} == {"3"}
    assert {n for n, _ in labels[None]} == {n for n, _ in labels[3]}
    assert (obsm.REQUESTS_REJECTED, "3") in labels[3]


def test_mid_batch_arrival_accrues_wait_from_arrival_offset(port_model):
    """A request arriving while a batch is in flight is handed to the
    engine after that batch returns, stamped at its arrival: the wall it
    sat out counts as queue wait."""
    cfg, model = port_model
    eng = teng.LPServingEngine(model, cfg, num_partitions=2, num_steps=2, max_batch=1,
                               device="cpu", clock=tload.VirtualClock())
    cls_ = tload.RequestClass("i", SHAPE, priority="interactive")
    eps = 1e-6
    wl = [tload.Arrival(0, 0.0, cls_, seed=1), tload.Arrival(1, eps, cls_, seed=2)]
    by_id = {r.request_id: r for r in tload.run_workload(eng, wl)}
    w0 = by_id[0].batch_wall_s
    assert by_id[0].queue_wait_s == pytest.approx(0.0, abs=1e-12)
    assert by_id[1].queue_wait_s == pytest.approx(w0 - eps)
    assert by_id[1].e2e_s == pytest.approx(w0 - eps + by_id[1].batch_wall_s)


# -------------------------------------------- the replay against the reference
def _fixed_step_clock(m):
    class FixedStep(m.VirtualClock):
        """Advances a fixed 0.5 s a batch, whatever the measured wall."""

        def advance(self, dt_s):
            super().advance(0.5)

    return FixedStep()


def _jax_noise(shape, seed, device):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), shape)))


def _label_sets(rec):
    return sorted((r["name"], r["type"], tuple(sorted(r["labels"].items())))
                  for r in rec.metrics.snapshot())


def _offline_equals_live(slo_mod, rec, spec):
    live = slo_mod.evaluate_slo(rec.request_rows, spec=spec, num_devices=1)
    doc = json.loads(json.dumps(rec.trace.to_json()))
    offline = slo_mod.evaluate_slo(slo_mod.rows_from_trace(doc), spec=spec, num_devices=1)
    return json.dumps(live, sort_keys=True) == json.dumps(offline, sort_keys=True), live


def test_replay_as_the_reference(monkeypatch):
    jcfg = jget_config("wan21-dit-1.3b").reduced()
    params = jmodels.build(jcfg).init(jax.random.PRNGKey(0))
    tcfg = get_config("wan21-dit-1.3b").reduced()
    model = tdit.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    slo = "interactive:0.6,standard:0.9"
    mix = "i,shape=4x8x12,priority=interactive;s,shape=4x8x12,priority=standard,weight=2;" \
          "g,shape=4x8x12,guidance=6.0"
    args = dict(num_partitions=2, overlap_ratio=0.5, num_steps=2, max_batch=2, slo=slo)

    def fwd(p, z, t, c, cfg_model):
        return jdit.forward(p, z, t, c, cfg_model)

    def replay(m, eng, to_context):
        eng.replica_id = 1                  # as a router would set it
        wl = m.build_workload(m.WorkloadSpec(rate_rps=4.0, num_requests=6, seed=3,
                                             mix=m.parse_mix(mix)))
        res = m.run_workload(eng, wl, make_context=lambda a: to_context(_ctx(tcfg, a.seed)))
        return {r.request_id: r for r in res}

    jrec = JRecorder()
    jeng = JEngine(fwd, params, jcfg, recorder=jrec, clock=_fixed_step_clock(jload), **args)
    jres = replay(jload, jeng, jax.numpy.asarray)
    monkeypatch.setattr(teng, "initial_noise", _jax_noise)
    trec = FlightRecorder()
    eng = teng.LPServingEngine(model, tcfg, device="cpu", recorder=trec,
                               clock=_fixed_step_clock(tload), **args)
    tres = replay(tload, eng, torch.from_numpy)

    assert sorted(tres) == sorted(jres) == list(range(6))
    assert trec.request_rows == jrec.request_rows
    assert len({r["batch_seq"] for r in trec.request_rows}) < 6      # some batches of 2
    assert {r["replica"] for r in trec.request_rows} == {1}
    assert eng.clock.now == jeng.clock.now
    t_ok, t_live = _offline_equals_live(tslo, trec, slo)
    j_ok, j_live = _offline_equals_live(jslo, jrec, slo)
    assert t_ok and j_ok
    assert json.dumps(t_live, sort_keys=True) == json.dumps(j_live, sort_keys=True)
    assert t_live["violations"] > 0 and "replicas" in t_live
    assert _label_sets(trec) == _label_sets(jrec)
    for i in tres:
        assert tres[i].queue_wait_s == jres[i].queue_wait_s and tres[i].e2e_s == jres[i].e2e_s
        np.testing.assert_allclose(tres[i].latent.numpy(), np.asarray(jres[i].latent),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ the CLI
MIX = "i,shape=4x8x12,priority=interactive;s,shape=4x8x12,priority=standard,weight=2"
CLI = ["--device", "cpu", "--rate", "50", "--steps", "2", "--max-batch", "2", "--mix", MIX,
       "--slo", "interactive:60,standard:120"]


@pytest.mark.parametrize("fleet", [[], ["--replicas", "2", "--inject-fault",
                                        "replica:1:dead@1"]], ids=["engine", "fleet"])
def test_loadtest_cli_on_cpu(tmp_path, capsys, monkeypatch, fleet):
    """The CLI serves the full width; the CPU test serves the reduced config."""
    monkeypatch.setattr(loadtest, "get_config", lambda name: get_config(name).reduced())
    trace, report = tmp_path / "t.json", tmp_path / "r.json"
    live = loadtest.main(CLI + ["--requests", "6", "--trace-out", str(trace),
                                "--report-out", str(report)] + fleet)
    out = capsys.readouterr().out
    assert "SLO report (6 requests" in out and f"trace: {trace}" in out
    assert live["source"] == "live" and live["warmed"] is True
    assert live["workload"]["digest"] == tload.workload_digest(tload.build_workload(
        tload.WorkloadSpec(rate_rps=50.0, num_requests=6, mix=tload.parse_mix(MIX))))
    if fleet:
        assert "router: 2 replicas" in out and "warm replica 1" in out
        assert live["router"]["states"] == ["healthy", "dead"]
        assert live["router"]["completed"] == 6 and live["disposition"]["accounted"] == 6
    else:
        assert "engine: lp_impl=shard_map K=2" in out and "disposition" not in live
    offline = loadtest.main(["--report-from", str(trace), "--slo",
                             "interactive:60,standard:120"])
    assert offline["source"] == "trace"
    for key in ("source", "warmed", "workload", "router"):
        live.pop(key, None)
    offline.pop("source")
    assert json.dumps(live, sort_keys=True) == json.dumps(offline, sort_keys=True)
