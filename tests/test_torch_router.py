"""The port's replica router (``repro_torch/serving/router.py``) against the
JAX package's, on the CPU.

* One framework-free stub engine (the surface the router touches: queue,
  lifecycle, in-flight batch, clock, ``set_psnr_floor``), built on each
  package's ``VideoResult`` and raising each package's ``ReplicaDeath`` /
  ``ServingFault``, drives both routers through every scenario of
  ``tests/test_router.py`` and two more (a replica that recovers from a
  terminal fault, a replica drained by its heartbeats alone).  The stub
  records a lifecycle row per completed request.  The stats, the replica
  states, the router instants (name and arguments, in order), the shed
  and failed rows, the metric snapshots, the results and the SLO reports
  must be equal; the port must also show what the reference's test
  asserts of each scenario.
* A real-engine chaos test, port only: two reduced-DiT engines on the CPU
  behind the router, ``replica:1:dead@1``: zero lost, every row carries its
  replica, the offline report equals the live one.  The trace's only
  validation errors are the router's category, which ``validate_trace``
  does not list in either package.
"""
import json
from types import SimpleNamespace

import pytest

from repro.obs import FlightRecorder as JRecorder
from repro.obs import slo as jslo
from repro.runtime import faults as jfaults
from repro.serving import engine as jengine
from repro.serving import loadgen as jloadgen
from repro.serving import router as jrouter
from repro_torch.obs import FlightRecorder as TRecorder
from repro_torch.obs import slo as tslo
from repro_torch.runtime import faults as tfaults
from repro_torch.serving import engine as tengine
from repro_torch.serving import loadgen as tloadgen
from repro_torch.serving import router as trouter

REF = SimpleNamespace(rec=JRecorder, slo=jslo, faults=jfaults, engine=jengine,
                      loadgen=jloadgen, router=jrouter)
PORT = SimpleNamespace(rec=TRecorder, slo=tslo, faults=tfaults, engine=tengine,
                       loadgen=tloadgen, router=trouter)
SLO = "interactive:2,standard:8,batch:30"


class StubEngine:
    """The engine surface the router touches, no model: ``submit`` queues,
    ``run`` serves the whole queue as one batch after ``wall`` virtual
    seconds (recording each request's lifecycle row, with its replica),
    ``fail(dispatch_no)`` scripts an exception for a dispatch."""

    def __init__(self, pkg, clock, wall=0.1, max_batch=2, recorder=None, fail=None,
                 psnr_floor=None):
        self.pkg = pkg
        self.clock = clock
        self.wall = wall
        self.max_batch = max_batch
        self.max_queue = None
        self.replica_id = None
        self.recorder = recorder
        self.slo = pkg.slo.SLOSpec.parse(SLO)
        self.psnr_floor = psnr_floor
        self._plan_resolver = None
        self._fault_plan = None
        self._queue = []
        self._lifecycle = {}
        self._enqueued_at = {}
        self._inflight = []
        self.dispatches = 0
        self.fail = fail or (lambda pkg, n: None)
        self.floor_history = []
        self.served = []          # (request id, psnr floor, submit_s) served

    def submit(self, req, submit_s=None):
        self._queue.append((req, submit_s))
        self._lifecycle[req.request_id] = {"submit_s": submit_s}

    def set_psnr_floor(self, floor):
        self.psnr_floor = floor
        self.floor_history.append(floor)
        return True

    def run(self, max_batches=None, max_restarts_per_batch=2):
        self.dispatches += 1
        batch, self._queue = self._queue, []
        self._inflight = [r for r, _ in batch]
        exc = self.fail(self.pkg, self.dispatches)
        if exc is not None:
            raise exc
        admit = self.clock.now
        self.clock.advance(self.wall)
        done = self.clock.now
        out = []
        for req, s in batch:
            self._lifecycle.pop(req.request_id, None)
            res = self.pkg.engine.VideoResult(req.request_id, None, 2, batch_wall_s=self.wall,
                                              batch_size=len(batch))
            res.queue_wait_s = admit - s
            res.e2e_s = done - s
            out.append(res)
            self.served.append((req.request_id, req.psnr_floor, s))
            if self.recorder is not None:
                self.recorder.record_request({
                    "request_id": req.request_id, "priority": str(req.priority),
                    "submit_s": s, "admit_s": admit, "done_s": done,
                    "queue_wait_s": admit - s, "e2e_s": done - s, "restarts": 0,
                    "replica": self.replica_id})
        self._inflight = []
        return out


def _arrivals(pkg, specs):
    """(request id, arrival, class name, priority, psnr floor) -> Arrivals."""
    return [pkg.loadgen.Arrival(i, t, pkg.loadgen.RequestClass(name, (4, 8, 12),
                                                                priority=prio,
                                                                psnr_floor=psnr),
                                seed=i)
            for i, t, name, prio, psnr in specs]


def _same(n, t=0.0, prio="standard", psnr=None, name="s"):
    return [(i, t, name, prio, psnr) for i in range(n)]


def _death(pkg, n):
    return pkg.faults.ReplicaDeath("boom", replica=0, step=1)


def _wire_fault(pkg, n):
    return pkg.faults.ServingFault("wire fault")


def _first_fault(pkg, n):
    return pkg.faults.ServingFault("wire fault") if n == 1 else None


SCENARIOS = {
    # name: (stub engines: (wall, max_batch, fail, psnr floor), router kwargs, arrivals)
    "spread_and_replica_ids": ([(0.1, 2, None, None)] * 2, {}, _same(4)),
    "round_robin": ([(0.0, 1, None, None)] * 3, dict(policy="round-robin"), _same(6)),
    "requeue_with_original_stamp": ([(0.1, 2, _death, None), (0.1, 2, None, None)],
                                    dict(backoff_base_s=0.01), _same(2)),
    "terminal_after_max_redispatch": ([(0.1, 2, _death, None)] * 2,
                                      dict(max_redispatch=1, backoff_base_s=0.01), _same(1)),
    "engine_fault_degrades_then_drains": ([(0.1, 2, _wire_fault, None), (0.1, 2, None, None)],
                                          dict(dead_after_failures=2, backoff_base_s=0.01),
                                          [(i, float(i), "s", "standard", None)
                                           for i in range(6)]),
    "engine_fault_recovers": ([(0.1, 2, _first_fault, None), (0.5, 2, None, None)],
                              dict(backoff_base_s=0.01),
                              [(i, 0.3 * i, "s", "standard", None) for i in range(8)]),
    "sheds_lowest_priority_newest_first": ([(5.0, 1, None, None)], dict(shed_watermark=3),
                                           [(0, 0.0, "i", "interactive", None)]
                                           + [(i, 0.0, "b", "batch", None)
                                              for i in range(1, 6)]),
    "degrades_floors_and_restores": ([(1.0, 1, None, 32.0)],
                                     dict(shed_watermark=100, degrade_watermark=2,
                                          degrade_step_db=2.0, min_psnr_floor_db=24.0),
                                     _same(6, psnr=32.0)),
    "degrade_precedes_violations": ([(0.5, 1, None, None)],
                                    dict(shed_watermark=100, degrade_watermark=1),
                                    _same(5, psnr=30.0)),
    "all_replicas_dead": ([(0.1, 2, _death, None)] * 2, dict(max_redispatch=0),
                          [(i, 0.1 * i, "s", "standard", None) for i in range(4)]),
    "heartbeat_drain": ([(0.1, 1, None, None), (0.1, 1, None, None), (5.0, 1, None, None)],
                        dict(policy="round-robin"),
                        [(i, 0.2 * i, "s", "standard", None) for i in range(12)]),
}


def _run(pkg, name):
    stubs, kw, specs = SCENARIOS[name]
    rec = pkg.rec()
    engines = [StubEngine(pkg, pkg.loadgen.VirtualClock(), wall=w, max_batch=mb, recorder=rec,
                          fail=fail, psnr_floor=floor) for w, mb, fail, floor in stubs]
    router = pkg.router.ReplicaRouter(engines, recorder=rec, slo=SLO, **kw)
    out = router.serve(_arrivals(pkg, specs), make_context=lambda a: None)
    report = pkg.slo.evaluate_slo(rec.request_rows, spec=SLO, num_devices=len(engines),
                                  shed_rows=rec.shed_rows, failed_rows=rec.failed_rows)
    return {
        "results": [(r.request_id, r.batch_size, r.queue_wait_s, r.e2e_s) for r in out],
        "stats": dict(router.stats), "states": [r.state for r in router.replicas],
        "replica_ids": [e.replica_id for e in engines],
        "dispatches": [e.dispatches for e in engines],
        "served": [e.served for e in engines],
        "floors": [e.floor_history for e in engines],
        "degrade_level": router.degrade_level, "now": router.now,
        "instants": [(e["name"], e["args"]) for e in rec.trace.events
                     if e.get("cat") == "router"],
        "shed": rec.shed_rows, "failed": rec.failed_rows,
        "metrics": rec.metrics.snapshot(),
        "report": json.loads(json.dumps(report)),
    }


@pytest.fixture(scope="module")
def outcomes():
    return {name: (_run(PORT, name), _run(REF, name)) for name in SCENARIOS}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_scenario_as_the_reference(outcomes, name):
    port, ref = outcomes[name]
    for key in ref:
        assert port[key] == ref[key], key


def _names(o):
    return [n for n, _ in o["instants"]]


# what tests/test_router.py asserts of each scenario, held on the port
EXPECT = {
    "spread_and_replica_ids": lambda o: (
        sorted(r[0] for r in o["results"]) == [0, 1, 2, 3] and o["replica_ids"] == [0, 1]
        and min(o["dispatches"]) >= 1 and o["stats"]["completed"] == 4),
    "round_robin": lambda o: o["dispatches"] == [2, 2, 2],
    "requeue_with_original_stamp": lambda o: (
        sorted(r[0] for r in o["results"]) == [0, 1] and o["states"][0] == "dead"
        and o["stats"]["replica_deaths"] == 1 and o["stats"]["redispatches"] == 2
        and [s for _, _, s in o["served"][1]] == [0.0, 0.0]
        and {"router.replica_dead", "router.redispatch"} <= set(_names(o))),
    "terminal_after_max_redispatch": lambda o: (
        o["results"] == [] and o["stats"]["failed"] == 1
        and o["failed"][0]["terminal"] is True and o["failed"][0]["submit_s"] == 0.0
        and o["report"]["disposition"]["accounted"] == 1),
    "engine_fault_degrades_then_drains": lambda o: (
        sorted(r[0] for r in o["results"]) == list(range(6))
        and o["states"][0] in ("degraded", "draining") and o["stats"]["failed"] == 0),
    "engine_fault_recovers": lambda o: (
        o["stats"]["completed"] == 8 and o["states"] == ["healthy", "healthy"]
        and [a["state"] for n, a in o["instants"] if n == "router.replica_state"]
        == ["degraded", "healthy"]),
    "sheds_lowest_priority_newest_first": lambda o: (
        o["stats"]["shed"] == 3 and {r["request_id"] for r in o["shed"]} == {3, 4, 5}
        and all(r["reason"] == "watermark" and r["priority"] == "batch" for r in o["shed"])
        and 0 in {r[0] for r in o["results"]}
        and o["report"]["disposition"]["accounted"] == 6),
    "degrades_floors_and_restores": lambda o: (
        o["stats"]["completed"] == 6
        and {"router.degrade", "router.restore"} <= set(_names(o))
        and any(f < 32.0 for _, f, _ in o["served"][0])
        and all(f >= 24.0 for _, f, _ in o["served"][0])
        and o["floors"][0][-1] == 32.0 and o["degrade_level"] == 0),
    "degrade_precedes_violations": lambda o: (
        [a["now_s"] for n, a in o["instants"] if n == "router.degrade"][0] == 0.0),
    "all_replicas_dead": lambda o: (
        o["results"] == [] and o["states"] == ["dead", "dead"]
        and o["stats"]["admitted"] == 4 and len(o["failed"]) == 4
        and all(r["terminal"] for r in o["failed"])),
    "heartbeat_drain": lambda o: (
        o["states"][2] == "draining" and o["stats"]["completed"] == 12
        and ("router.replica_state", "heartbeat_misses") in
        [(n, a.get("reason")) for n, a in o["instants"]]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_scenario_outcome(outcomes, name):
    assert EXPECT[name](outcomes[name][0])


def _stubs(pkg, n, shared=False):
    clock = pkg.loadgen.VirtualClock()
    return [StubEngine(pkg, clock if shared else pkg.loadgen.VirtualClock()) for _ in range(n)]


REFUSALS = {
    "no_engine": (lambda pkg: pkg.router.ReplicaRouter([], slo=SLO), "at least one"),
    "policy": (lambda pkg: pkg.router.ReplicaRouter(_stubs(pkg, 1), slo=SLO, policy="random"),
               "policy"),
    "shared_clock": (lambda pkg: pkg.router.ReplicaRouter(_stubs(pkg, 2, shared=True),
                                                          slo=SLO), "share"),
    "unscoped_fault": (lambda pkg: pkg.router.ReplicaRouter(_stubs(pkg, 2), slo=SLO,
                                                            inject_fault="dead:1@3"),
                       "unscoped"),
    "unknown_replica": (lambda pkg: pkg.router.ReplicaRouter(_stubs(pkg, 2), slo=SLO,
                                                             inject_fault="replica:7:dead@3"),
                        "replica"),
    "wall_clock": (lambda pkg: pkg.router.ReplicaRouter(
        [SimpleNamespace(clock=lambda: 0.0, max_batch=1)], slo=SLO), "VirtualClock"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_router_refusal_as_the_reference(name):
    """The same refusal, with the same message, on both packages."""
    build, match = REFUSALS[name]
    msgs = []
    for pkg in (PORT, REF):
        with pytest.raises(ValueError, match=match) as e:
            build(pkg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_replica_kill_end_to_end_zero_lost():
    """Real port engines (the reduced DiT, f32, on the CPU) behind the
    router; replica 1 dies at denoise step 1 of its first batch: every
    request completes (redispatched with its arrival stamp), each row
    carries the replica that served it, the report accounts for all 8 and
    the offline report equals the live one."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import dit
    from repro_torch.obs import validate_trace

    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    rec = TRecorder()
    slo = tslo.SLOSpec.parse("interactive:60,standard:120")

    def mk():
        return tengine.LPServingEngine(model, cfg, num_partitions=2, num_steps=2, max_batch=2,
                                       max_queue=8, recorder=rec, slo=slo, device="cpu",
                                       clock=tloadgen.VirtualClock())

    engines = [mk(), mk()]
    router = trouter.ReplicaRouter(engines, recorder=rec, slo=slo,
                                   inject_fault="replica:1:dead@1", max_redispatch=2)
    assert engines[1]._fault_plan.die_step == 1 and engines[0]._fault_plan is None
    mix = (tloadgen.RequestClass("i", (4, 8, 12), priority="interactive"),
           tloadgen.RequestClass("s", (4, 8, 12), priority="standard"))
    wl = tloadgen.build_workload(tloadgen.WorkloadSpec(rate_rps=50.0, num_requests=8, seed=3,
                                                       mix=mix))
    results = router.serve(wl)
    assert sorted(r.request_id for r in results) == list(range(8))
    assert router.replicas[1].state == "dead"
    assert router.stats["replica_deaths"] == 1 and router.stats["redispatches"] >= 1
    arrival = {a.request_id: a.arrival_s for a in wl}
    redispatched = {e["args"]["request_id"] for e in rec.trace.events
                    if e["name"] == "router.redispatch"}
    assert redispatched
    for row in rec.request_rows:
        assert row["replica"] == 0 and row["submit_s"] == arrival[row["request_id"]]
    live = tslo.evaluate_slo(rec.request_rows, spec=slo, num_devices=2,
                             shed_rows=rec.shed_rows, failed_rows=rec.failed_rows)
    assert live["disposition"]["accounted"] == 8 and set(live["replicas"]) == {"0"}
    doc = json.loads(json.dumps(rec.trace.to_json()))
    # the router's own instants carry the category "router", which the
    # validator (a copy of the reference's) does not list: that is all it finds
    errors = validate_trace(doc)
    assert errors and all(e.endswith("unknown category 'router'") for e in errors)
    offline = tslo.evaluate_slo(tslo.rows_from_trace(doc), spec=slo, num_devices=2,
                                shed_rows=tslo.shed_from_trace(doc),
                                failed_rows=tslo.failures_from_trace(doc))
    assert json.dumps(live, sort_keys=True) == json.dumps(offline, sort_keys=True)
