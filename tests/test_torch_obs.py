"""The port's flight recorder (``repro_torch/obs``) against the JAX package, on the CPU.

* The copies (``obs/metrics``, ``trace``, ``account``, ``slo``) and
  ``FlightRecorder`` read what the reference reads: the same operations on
  both packages give equal metric snapshots, byte-equal JSONL (its wall
  stamp pinned) and Prometheus text, equal reservoir samples for a seed,
  the same ``validate_trace`` verdicts on malformed documents, equal
  per-step wire attribution, tiering and reconciliation rows (and the same
  error for a gapped timeline), and equal SLO reports and their text.
  ``device_span`` enters ``torch.profiler.record_function``; trace args
  made of torch tensors come out as the numbers the reference writes for
  numpy ones.
* ``LPServingEngine(recorder=...)`` against the reference engine with a
  recorder, in the scenario of ``tests/test_obs.py:549`` (K 2, ``int8``
  wire, 3 steps, 2 requests in one batch): both traces validate, the
  multisets of event names are equal, the ``wire_steps`` records are equal
  field for field, and so are the metrics that do not measure time.
* Scheduled engines (an explicit spec and ``auto``) against the
  reference's: equal plans, latents within ``test_torch_engine.py``'s coded
  tolerance (one code step of the segment's codec), equal re-plans from
  ``set_psnr_floor``; the live ``serve.slo_violations`` equal the offline
  ``evaluate_slo`` of the trace's lifecycle rows.
* The serve CLI on the CPU with ``--codec-schedule auto --psnr-floor 40
  --trace-out --metrics-out`` writes a trace that validates and a metrics
  file the SLO report reads.
"""
import collections
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import policy as jpolicy
from repro.configs import get_config as jget_config
from repro.core import comm_model as jcm
from repro.models import dit as jdit
from repro.models import frontends as jfrontends
from repro.obs import account as jaccount
from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo
from repro.obs import trace as jtrace
from repro.diffusion.sampler import FlowMatchEuler as JFlow
from repro.policy import autotune as jautotune
from repro.serving.engine import LPServingEngine as JEngine
from repro.serving.engine import VideoRequest as JRequest
from repro_torch import obs as tobs
from repro_torch import policy as tpolicy
from repro_torch.configs import get_config
from repro_torch.core import comm_model as tcm
from repro_torch.diffusion.sampler import FlowMatchEuler
from repro_torch.launch import serve
from repro_torch.models import dit as tdit
from repro_torch.obs import account as taccount
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import slo as tslo
from repro_torch.obs import trace as ttrace
from repro_torch.policy import autotune as tautotune
from repro_torch.serving import engine as teng

REF = dict(obs=jobs, metrics=jmetrics, trace=jtrace, account=jaccount, slo=jslo, cm=jcm,
           autotune=jautotune, policy=jpolicy, flow=JFlow)
PORT = dict(obs=tobs, metrics=tmetrics, trace=ttrace, account=taccount, slo=tslo, cm=tcm,
            autotune=tautotune, policy=tpolicy, flow=FlowMatchEuler)
R = 0.5


def _both(build):
    return build(PORT), build(REF)


def _ccfg(m, dims=(8, 8, 12), steps=6):
    return m["cm"].VDMCommConfig(latent_dims=dims, latent_channels=16, patch_sizes=(1, 2, 2),
                                 d_model=96, num_blocks=2, num_steps=steps)


def _errors(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:              # the error type and its message count
        return ("raise", type(e).__name__, str(e))


# ------------------------------------------------------------- metrics
def _fill(m, registry):
    M = m["metrics"]
    registry.inc(M.REQUESTS)
    registry.inc(M.REQUESTS, 2)
    registry.inc(M.WIRE_BYTES, 1024.0, tier="inter", collective="all-gather")
    registry.inc(M.WIRE_BYTES, 10.0, tier="intra", collective="all-gather")
    registry.set(M.QUEUE_DEPTH, 7)
    registry.set(M.QUEUE_DEPTH, 3, source='we"ird\\lab\nel')
    registry.set(M.DEAD_GROUPS, 1)
    for i in range(300):
        registry.observe(M.E2E_LATENCY_S, 0.01 * ((i * 37) % 101), priority="interactive")
        registry.observe(M.STEP_LATENCY_S, float(i))
    registry.observe(M.QUEUE_WAIT_S, 0.5, priority="batch")
    return registry


def test_metrics_registry_as_the_reference(monkeypatch):
    monkeypatch.setattr(jmetrics, "wall_stamp_s", lambda: 1.7e9)
    monkeypatch.setattr(tmetrics, "wall_stamp_s", lambda: 1.7e9)

    def build(m):
        reg = _fill(m, m["metrics"].MetricsRegistry(hist_cap=64, seed=3))
        M = m["metrics"]
        names = sorted(v for k, v in vars(M).items() if k.isupper() and isinstance(v, str))
        return (reg.snapshot(), reg.to_jsonl(), reg.to_prometheus(),
                reg.hist_values(M.E2E_LATENCY_S, priority="interactive"),
                reg.hist_dropped(M.STEP_LATENCY_S), reg.counter_value(M.REQUESTS),
                reg.gauge_value(M.QUEUE_DEPTH), reg.gauge_value("nope"), names)

    port, ref = _both(build)
    assert port == ref
    assert port[4] == 300 - 64 and len(port[3]) == 64


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_reservoir_samples_as_the_reference(seed):
    def build(m):
        reg = m["metrics"].MetricsRegistry(hist_cap=16, seed=seed)
        for i in range(500):
            reg.observe("x", i * 0.01)
            reg.observe("y", -i, k="v")
        return reg.hist_values("x"), reg.hist_values("y", k="v"), reg.snapshot()

    port, ref = _both(build)
    assert port == ref


def test_metrics_write_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(jmetrics, "wall_stamp_s", lambda: 1.7e9)
    monkeypatch.setattr(tmetrics, "wall_stamp_s", lambda: 1.7e9)
    out = {}
    for tag, m in (("port", PORT), ("ref", REF)):
        reg = _fill(m, m["metrics"].MetricsRegistry())
        for ext in ("prom", "jsonl"):
            reg.write(str(tmp_path / f"{tag}.{ext}"))
            out[(tag, ext)] = (tmp_path / f"{tag}.{ext}").read_text()
    assert out[("port", "prom")] == out[("ref", "prom")]
    assert out[("port", "jsonl")] == out[("ref", "jsonl")]


# --------------------------------------------------------------- trace
def _malformed(m):
    schema = m["trace"].TRACE_SCHEMA
    base = {"otherData": {"schema": schema}}
    ev = {"ph": "i", "name": "x", "ts": 0, "pid": 1, "tid": 1, "cat": "serve"}
    return [
        {"traceEvents": []},
        {**base, "traceEvents": [{"ph": "Z", "name": "x", "ts": 0, "pid": 1, "tid": 1}]},
        {**base, "traceEvents": [{**ev, "cat": "nonsense"}]},
        {**base, "traceEvents": [{**ev, "ph": "X"}]},
        {**base, "traceEvents": [{**ev, "ph": "X", "dur": -1}]},
        {**base, "traceEvents": [{"ph": "i", "cat": "serve"}]},
        {**base, "traceEvents": [{**ev, "args": {"o": object()}}]},
        {**base, "traceEvents": [{**ev, "name": "wire.reconcile",
                                  "args": {"unattributed_steps": 2}}]},
        {**base, "traceEvents": "no"},
        {**base, "traceEvents": [3, ev]},
        "not a doc",
        {**base, "traceEvents": [ev, {**ev, "ph": "X", "dur": 1.5}, {**ev, "ph": "C"}]},
    ]


def test_validate_trace_as_the_reference():
    def build(m):
        out = [m["trace"].validate_trace(d) for d in _malformed(m)]
        return [[e.replace("object at", "") for e in errs] for errs in out]

    port, ref = _both(build)
    assert [len(e) for e in port] == [len(e) for e in ref]
    # an unserialisable argument's message carries no address: the rest is equal
    assert port == ref
    assert port[-1] == [] and all(port[:-1])


def test_trace_args_of_tensors_are_the_numbers_of_the_reference():
    rec = ttrace.TraceRecorder()
    rec.instant("x", cat="obs", a=torch.arange(3), f=torch.tensor(1.5),
                h=torch.tensor(2.5, dtype=torch.bfloat16), n=np.float32(1.5),
                nested={"t": (1, torch.tensor([2.0, 3.0]))}, s=torch.Size([2, 3]))
    ref = jtrace.TraceRecorder()
    ref.instant("x", cat="obs", a=np.arange(3), f=np.float32(1.5), h=np.float32(2.5),
                n=np.float32(1.5), nested={"t": (1, np.array([2.0, 3.0]))}, s=(2, 3))
    got, want = rec.to_json(), ref.to_json()
    json.dumps(got)
    assert ttrace.validate_trace(got) == [] and got["traceEvents"][0]["args"] == \
        want["traceEvents"][0]["args"]
    assert got["otherData"] == want["otherData"]


def test_device_span_enters_record_function():
    """``device_span`` names a range of a running ``torch.profiler``
    capture (the reference enters ``jax.profiler.TraceAnnotation``)."""
    rec = tobs.FlightRecorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.device_span("denoise.run", dim=1, codec="int8"):
            torch.ones(4).add_(1)
    assert "denoise.run" in {e.key for e in prof.key_averages()}
    ev = rec.trace.events[-1]
    assert ev["name"] == "denoise.run" and ev["cat"] == "denoise" and ev["dur"] >= 0
    assert tobs.validate_trace(rec.trace.to_json()) == []


# ---------------------------------------------------------- accounting
CODEC_RUNS = [["int8"] * 4, ["fp32", "bf16", "int8", "int8-residual"],
              ["int4-residual", "int4-residual", "int8", "bf16"],
              ["displaced:int8-residual"] * 3 + ["int8-residual"]]
TIMELINES = [[(1, 3)], [(1, 3), (3, 2)], [(1, 4), (2, 3), (4, 2)]]


def test_attribution_as_the_reference():
    def build(m):
        acc, links = m["account"], m["autotune"].DEFAULT_LINKS
        out = []
        for dims in ((8, 8, 12), (8, 2, 2)):
            cfg = _ccfg(m, dims, steps=4)
            for codecs in CODEC_RUNS:
                for geom in TIMELINES:
                    for tp, ws, impl in ((1, False, "halo"), (2, False, "halo_hybrid"),
                                         (2, True, "halo_hybrid"), (1, False, "shard_map"),
                                         (1, False, "gspmd")):
                        out.append(_errors(acc.attribute_denoise_steps, cfg, R, codecs, geom,
                                           tp=tp, wire_shard=ws, lp_impl=impl, links=links,
                                           batch_size=2))
                out.append(_errors(acc.attribute_denoise_steps, cfg, R, codecs, [(1, 3)]))
            for dim in range(3):
                out.append(_errors(acc.step_wire_attribution, cfg, 3, R, dim, "int8", tp=2,
                                   wire_shard=True, lp_impl="halo_hybrid"))
        cfg = _ccfg(m)
        out.append(_errors(acc.attribute_denoise_steps, cfg, R, ["int8"], [(2, 3)]))
        out.append(_errors(acc.attribute_denoise_steps, cfg, R, ["int8"], []))
        out.append(acc.tiered_collectives({"all-gather[3]": 600.0, "collective-permute[3]": 400.0,
                                           "all-gather[2]": 1000.0, "all-reduce": 8.0}, 3, 2))
        out.append([acc.tier_for_group_size(g, M, T) for g in (2, 3, 4, 5)
                    for M, T in ((3, 2), (4, 4), (2, 3))])
        recs = acc.attribute_denoise_steps(_ccfg(m, steps=4), R, ["int8"] * 2, [(1, 3)],
                                           links=links)
        unpriced = acc.attribute_denoise_steps(_ccfg(m, steps=4), R, ["int8"] * 4, [(1, 3)])
        measured = [{"start": 1, "stop": 2, "wall_s": 0.2, "codec": "int8", "dim": 0},
                    {"start": 3, "stop": 4, "wall_s": 0.2, "codec": "int8"}]
        out.append(acc.reconcile_segments(recs, measured))
        out.append(acc.reconcile_segments(unpriced, measured))
        return out

    port, ref = _both(build)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, i
    raised = [r for r in port if isinstance(r, tuple) and r[0] == "raise"]
    assert sum("must start at step 1" in r[2] for r in raised) == 2


# ----------------------------------------------------------------- SLO
def _rows():
    rng = np.random.default_rng(5)
    rows = []
    for i in range(40):
        submit = float(rng.uniform(0, 10))
        admit = submit + float(rng.exponential(0.5))
        done = admit + float(rng.uniform(0.5, 4.0))
        row = {"request_id": i, "priority": ("interactive", "standard", "batch", "other")[i % 4],
               "submit_s": submit, "admit_s": admit, "done_s": done,
               "queue_wait_s": admit - submit, "e2e_s": done - submit}
        if i % 5 == 0:
            row["replica"] = i % 3
        rows.append(row)
    return rows


SLO_SPECS = [None, "", "interactive:2.0@0.999,standard:4,batch:30@0.9",
             "interactive:1@1.0", "x:0", "x:1@1.5", "x", "x:1,x:2", "x:abc", ",",
             "interactive:3.5@0.5,standard:1e9"]


def test_slo_as_the_reference():
    def build(m):
        slo = m["slo"]
        out = [_errors(lambda s: slo.SLOSpec.parse(s).spec, s) for s in SLO_SPECS]
        rows = _rows()
        shed = [{"request_id": 100 + i, "priority": "standard", "submit_s": 1.0,
                 "shed_s": 2.0, "reason": "queue"} for i in range(3)]
        failed = [{"request_id": 3, "priority": "batch", "terminal": True},
                  {"request_id": 200, "priority": "batch", "terminal": True}]
        for spec in ("interactive:2.0@0.999,standard:4,batch:30@0.9", "interactive:1@1.0",
                     None):
            for kw in ({}, {"num_devices": 4}, {"shed_rows": shed, "failed_rows": failed}):
                rec = m["obs"].FlightRecorder()
                report = slo.evaluate_slo(rows, spec, recorder=rec, **kw)
                out.append((report, slo.format_report(report), rec.metrics.snapshot()))
            routerless = [{k: v for k, v in r.items() if k != "replica"} for r in rows]
            out.append(slo.evaluate_slo(routerless, spec))
        out.append(slo.evaluate_slo([], "interactive:2"))
        # rows through a recorder's trace and metrics, and back
        rec = m["obs"].FlightRecorder()
        spec = slo.SLOSpec.parse("interactive:2.0,standard:4")
        for r in rows:
            rec.record_request({**r, "violated": r["e2e_s"] > spec.deadline_for(r["priority"])})
        for r in shed:
            rec.record_shed(r)
        for r in failed + [{"request_id": 9, "priority": "batch"}]:
            rec.record_failed(r)
        doc = rec.trace.to_json()
        out.append((slo.rows_from_trace(doc) == rec.request_rows, slo.shed_from_trace(doc),
                    slo.failures_from_trace(doc), slo.failures_from_trace(doc, False)))
        out.append(slo.disposition(rows, shed, failed))
        text = "\n".join(json.dumps(r) for r in rec.metrics.snapshot())
        report = slo.report_from_metrics_jsonl(text, spec)
        out.append((report, slo.format_report(report)))
        return out

    port, ref = _both(build)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, i


# ------------------------------------------------------ FlightRecorder
def _events(rec):
    """The trace's events without their clock: name, category, phase, args."""
    return [(e["name"], e["cat"], e["ph"], e.get("args")) for e in rec.trace.events]


def test_flight_recorder_feeders_as_the_reference():
    def build(m):
        rec = m["obs"].FlightRecorder()
        cfg = _ccfg(m, steps=4)
        recs = m["account"].attribute_denoise_steps(cfg, R, ["int8", "int8", "bf16", "bf16"],
                                                    [(1, 3), (3, 2)], tp=2, wire_shard=True,
                                                    lp_impl="halo_hybrid", links=rec.links)
        rec.record_run(1, 2, 0.3, dim=0, codec="int8", epoch=0)
        rec.record_run(3, 3, 0.1, dim=1, codec="bf16", epoch=1)
        rec.record_snapshot(2)
        rec.record_resume(2)
        rec.record_replan(3, 2, 1)
        rec.record_wire_steps(recs)
        rec.record_reconciliations(m["account"].reconcile_segments(recs, rec.measured_runs))
        pol = m["policy"]
        for spec in ("auto", "int8-residual@0.85,int8@0.6,bf16"):
            pol.resolve_cli_schedule(spec, cfg, 3, R, m["flow"](4), 4, tp=2, recorder=rec)
        rec.record_request({"request_id": 0, "priority": "interactive", "submit_s": 1.0,
                            "admit_s": 1.5, "done_s": 3.0, "queue_wait_s": 0.5, "e2e_s": 2.0,
                            "violated": True, "replica": 1})
        rec.record_shed({"request_id": 1, "priority": "batch", "submit_s": 1.0})
        rec.record_failed({"request_id": 2, "terminal": True})
        rec.counter_sample("c", {"a": 1.0})
        rec.inc("n", 2, k="v")
        rec.gauge("g", 3.0)
        rec.observe("h", 0.25)
        off = m["obs"].FlightRecorder(trace=False, metrics=False)
        with off.span("x"), off.device_span("y"):
            off.instant("z")
            off.record_snapshot(1)
            off.record_wire_steps(recs)
            off.record_plan(pol.resolve_cli_schedule("fp32", cfg, 3, R, m["flow"](4), 4))
        return (_events(rec), rec.metrics.snapshot(), rec.wire_steps, rec.plans,
                rec.measured_runs, rec.reconciliations, rec.request_rows, rec.shed_rows,
                rec.failed_rows, m["trace"].validate_trace(rec.trace.to_json()),
                off.trace, off.metrics, len(off.wire_steps), len(off.plans))

    port, ref = _both(build)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, i
    assert port[9] == [] and port[10] is None


# --------------------------------------------------------- the engines
SHAPE = (4, 8, 12)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("wan21-dit-1.3b").reduced()
    params = jax.jit(jdit.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tcfg = get_config("wan21-dit-1.3b").reduced()
    model = tdit.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    contexts = [np.array(jfrontends.text_context(jax.random.PRNGKey(i), 1, jcfg))
                for i in range(2)]
    return jcfg, params, tcfg, model, contexts


def _jax_noise(shape, seed, device):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), shape)))


def _serve_both(models, monkeypatch, n=2, priorities=("interactive", "standard"), **kw):
    """The reference engine and the port's, each with its own recorder, on
    the same ``n`` requests in one batch (the port fed the reference's
    noise)."""
    jcfg, params, tcfg, model, contexts = models

    def fwd(p, z, t, c, cfg_model):
        return jdit.forward(p, z, t, c, cfg_model)

    args = dict(num_partitions=2, overlap_ratio=0.5, num_steps=3, max_batch=2)
    args.update(kw)
    jrec = jobs.FlightRecorder()
    jeng = JEngine(fwd, params, jcfg, recorder=jrec, **args)
    for i in range(n):
        jeng.submit(JRequest(i, jax.numpy.asarray(contexts[i]), SHAPE, seed=i,
                             priority=priorities[i]))
    jres = {r.request_id: r for r in jeng.run()}
    monkeypatch.setattr(teng, "initial_noise", _jax_noise)
    trec = tobs.FlightRecorder()
    eng = teng.LPServingEngine(model, tcfg, device="cpu", recorder=trec, **args)
    for i in range(n):
        eng.submit(teng.VideoRequest(i, torch.from_numpy(contexts[i]), SHAPE, seed=i,
                                     priority=priorities[i]))
    tres = {r.request_id: r for r in eng.run()}
    return (eng, trec, tres), (jeng, jrec, jres)


def _untimed_metrics(rec):
    """Counters and gauges, and each histogram's count: what does not
    measure time."""
    out = []
    for row in rec.metrics.snapshot():
        if row["type"] == "histogram":
            timed = row["name"].endswith("_s")
            out.append((row["name"], row["labels"], row["count"],
                        None if timed else (row["sum"], row["p50"], row["p99"])))
        else:
            out.append((row["name"], row["labels"], row["value"]))
    return out


def test_engine_recorder_as_the_reference(models, monkeypatch):
    (eng, trec, tres), (jeng, jrec, jres) = _serve_both(
        models, monkeypatch, lp_impl="halo", wire_codec="int8")
    doc, jdoc = trec.trace.to_json(), jrec.trace.to_json()
    assert tobs.validate_trace(doc) == [] and jobs.validate_trace(jdoc) == []
    names = collections.Counter(e["name"] for e in doc["traceEvents"])
    assert names == collections.Counter(e["name"] for e in jdoc["traceEvents"])
    for required in ("request.enqueue", "batch.admit", "batch.denoise", "denoise.run",
                     "wire.step", "request.lifecycle", "wire.reconcile"):
        assert names[required], required
    assert trec.wire_steps == jrec.wire_steps and len(trec.wire_steps) == 3
    assert _untimed_metrics(trec) == _untimed_metrics(jrec)
    assert [(r["start"], r["stop"], r["dim"], r["codec"], r["epoch"])
            for r in trec.measured_runs] == [(r["start"], r["stop"], r["dim"], r["codec"],
                                              r["epoch"]) for r in jrec.measured_runs]
    rows = [{k: v for k, v in r.items() if not k.endswith("_s")} for r in trec.request_rows]
    assert rows == [{k: v for k, v in r.items() if not k.endswith("_s")}
                    for r in jrec.request_rows]
    for i in (0, 1):
        assert tres[i].e2e_s >= tres[i].queue_wait_s >= 0
    wire = sum(r["value"] for r in trec.metrics.snapshot() if r["name"] == tmetrics.WIRE_BYTES)
    assert wire == sum(r["inter_bytes"] + r["intra_bytes"] for r in trec.wire_steps)


def _close_per_codec(got, want, codecs):
    """One code step of the coarsest codec that ran (``test_torch_engine.py``'s
    rule, ``qmax`` 127 for int8 and 7 for int4), and a bf16 step's flip
    counted at its size (``test_torch_policy.py``)."""
    a, b = np.asarray(want), got.numpy()
    d = np.abs(b - a)
    qmax = 7 if any("int4" in c for c in codecs) else 127
    assert d.max() <= 1e-4 + np.abs(a).max() / qmax, d.max()
    rel = 2.0 ** -7 if "bf16" in codecs else 1e-4
    assert (d > 1e-4 + rel * np.abs(a)).mean() <= 0.01


def _plan_fields(plan):
    return ({k: v for k, v in vars(plan).items() if k not in ("schedule", "segments")},
            plan.schedule.spec, [(s.codec, s.start, s.stop) for s in plan.segments],
            plan.describe())


@pytest.mark.parametrize("schedule,floor", [("int8-residual@0.85,int8@0.6,bf16", None),
                                            ("auto", 40.0)], ids=["explicit", "auto"])
def test_scheduled_engine_as_the_reference(models, monkeypatch, schedule, floor):
    (eng, trec, tres), (jeng, jrec, jres) = _serve_both(
        models, monkeypatch, num_partitions=3, num_steps=4, codec_schedule=schedule,
        psnr_floor=floor, slo="interactive:1e-6,standard:1000")
    assert _plan_fields(eng.plan) == _plan_fields(jeng.plan)
    assert eng.lp_impl == jeng.lp_impl == "halo" and eng._compiler.schedule is not None
    assert trec.plans == jrec.plans and trec.wire_steps == jrec.wire_steps
    codecs = set(eng.plan.step_codecs)
    for i in (0, 1):
        _close_per_codec(tres[i].latent, jres[i].latent, codecs)
    assert eng._compiler.state_inits == jeng._compiler.state_inits
    assert eng._compiler.compiles <= 3 * eng.plan.num_segments
    assert tobs.validate_trace(trec.trace.to_json()) == []
    # the live SLO counter against the offline report of the trace's rows
    live = {r["labels"]["priority"]: r["value"] for r in trec.metrics.snapshot()
            if r["name"] == tmetrics.SLO_VIOLATIONS}
    offline = tslo.evaluate_slo(tslo.rows_from_trace(trec.trace.to_json()), eng.slo)
    assert live == {"interactive": 1.0}
    assert {p: c["violations"] for p, c in offline["classes"].items() if c["violations"]} == \
        live
    assert [r["violated"] for r in trec.request_rows] == [True, False]
    # a new floor re-resolves the plan as the reference does (auto only)
    for f in (24.0, 24.0, 50.0):
        assert eng.set_psnr_floor(f) == jeng.set_psnr_floor(f)
        assert _plan_fields(eng.plan) == _plan_fields(jeng.plan)
        assert eng._compiler.schedule.spec == jeng._compiler.schedule.spec
    assert trec.plans == jrec.plans


def test_engine_policy_refusals_as_the_reference(models):
    jcfg, params, tcfg, model, _ = models
    for kw in (dict(psnr_floor=40.0), dict(wire_codec="int8", codec_schedule="auto"),
               dict(codec_schedule="int8@0.5,bf16", lp_impl="shard_map"),
               dict(codec_schedule="displaced:int8-residual@0.5,int8-residual",
                    lp_impl="shard_map"),
               dict(codec_schedule="int7"), dict(codec_schedule="auto", psnr_floor=90.0),
               dict(codec_schedule="int8@0.5,bf16", inject_fault="corrupt@2"),
               dict(codec_schedule="int8@0.5,bf16", psnr_floor=45.0)):
        want = _errors(JEngine, lambda *a: None, params, jcfg, num_partitions=3, **kw)
        got = _errors(teng.LPServingEngine, model, tcfg, num_partitions=3, device="cpu", **kw)
        assert got[0] == want[0] and (got == want or got[0] == "ok"), kw
        if got[0] == "ok":                  # an unmet floor that fp32 meets: the same plan
            assert _plan_fields(got[1].plan) == _plan_fields(want[1].plan), kw


def test_serve_cli_schedule_and_records_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(serve, "get_config", lambda name: get_config(name).reduced())
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    serve.main(["--device", "cpu", "--requests", "2", "--steps", "4", "--partitions", "3",
                "--frames-latent", "4", "--codec-schedule", "auto", "--psnr-floor", "40",
                "--trace-out", str(trace), "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    assert "engine: lp_impl=halo" in out and "step policy: halo schedule=" in out
    assert f"trace: {trace}" in out and "request 1: latent (1, 4, 8, 12, 4)" in out
    doc = json.loads(trace.read_text())
    assert tobs.validate_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"policy.plan", "request.lifecycle", "denoise.run", "wire.step"} <= names
    report = tslo.report_from_metrics_jsonl(metrics.read_text(), "standard:1000")
    assert report["classes"]["standard"]["count"] == 2
    prom = tmp_path / "m.prom"
    serve.main(["--device", "cpu", "--requests", "1", "--steps", "2", "--frames-latent", "4",
                "--codec-schedule", "int8", "--metrics-out", str(prom)])
    assert prom.read_text().startswith("# TYPE")
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--codec-schedule", "auto", "--wire-codec", "int8"])
    assert math.isfinite(report["classes"]["standard"]["e2e_p50_s"])
