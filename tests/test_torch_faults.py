"""Fault recovery in the port against the reference, on the CPU, one process.

* ``runtime/health``, ``runtime/straggler`` and ``runtime/faults``' plan
  grammar are copies: each scenario of ``tests/test_fault_recovery.py``
  (health monitor, straggler EMA, fault plans) and of
  ``tests/test_replan.py`` (the EMA's layout change and threshold) runs on
  the reference's classes and on the port's, and every value it reads,
  and every error it raises, must be the same.  ``plan_weighted_partition``
  gives the reference's plans.
* ``CorruptingCodec`` poisons the wire mirror as the reference's does, and
  the NaN guard absorbs it; a finite wire is the same with and without
  the guard.
* Mid-request re-planning (``LPStepCompiler.replan``,
  ``runtime/elastic.replan_lp_compiler``) on the scenarios of
  ``tests/test_replan.py``, the port's and the reference's compilers side
  by side: the same state inits, step-cache misses and hits, snapshot
  steps and epochs, and the latents within one code step of the
  ``int8-residual`` wire (``test_torch_lp.py``'s reason: the two
  packages' ``tanh`` can differ by an ulp, which can flip a code).  The
  port's resumed run equals its fault-free twin bit for bit.
* The engine's off-mesh drills (``dead:3@2`` on ``int8`` at K 4 with
  ``elastic``, without it, and ``corrupt@2`` with and without the NaN
  guard) against the reference engine on the reduced DiT in f32 with the
  same noise: the same ``evictions``, ``K``, ``restarts``,
  ``resumed_from_step`` and ``last_steps_lost``, and the latent within
  ``test_torch_engine.py``'s coded tolerance (one code step: max, and
  beyond 1e-4 on at most 1% of the values).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.comm import get_codec as jget_codec
from repro.comm.wire import simulate_halo_forward as jsimulate
from repro.configs import get_config as jget_config
from repro.core import LPStepCompiler as JCompiler
from repro.core import comm_model as jcm
from repro.core import lp_denoise as jlp_denoise
from repro.core import plan_uniform as jplan_uniform
from repro.core.lp_step import DenoiseSnapshot as JSnapshot
from repro.diffusion.sampler import FlowMatchEuler as JSampler
from repro.models import dit as jdit
from repro.models import frontends as jfrontends
from repro.obs import FlightRecorder as JRecorder
from repro.obs import metrics as jmetrics
from repro.policy import resolve_cli_schedule as jresolve
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro.runtime import health as jhealth
from repro.runtime import straggler as jstraggler
from repro.serving.engine import LPServingEngine as JEngine
from repro.serving.engine import VideoRequest as JRequest
from repro_torch.comm.codecs import get_codec
from repro_torch.comm.wire import simulate_halo_forward
from repro_torch.configs import get_config
from repro_torch.core import LPStepCompiler, lp_denoise, plan_uniform
from repro_torch.core.lp_step import DenoiseSnapshot
from repro_torch.diffusion.sampler import FlowMatchEuler
from repro_torch.models import dit as tdit
from repro_torch.obs import FlightRecorder
from repro_torch.obs import metrics as tmetrics
from repro_torch.runtime import elastic, faults, health, straggler
from repro_torch.serving import engine as teng

REF = dict(health=jhealth, straggler=jstraggler, faults=jfaults,
           registry=jmetrics.MetricsRegistry)
PORT = dict(health=health, straggler=straggler, faults=faults,
            registry=tmetrics.MetricsRegistry)


def _plain(x):
    """A value as plain Python, comparable across the two packages."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if hasattr(x, "new_mesh_shape"):                      # an EvictionProposal
        return ("proposal", x.group, tuple(x.new_mesh_shape), x.reason)
    return x


class Trace(list):
    def read(self, *values):
        self.append(tuple(_plain(v) for v in values))

    def call(self, fn, *a, **kw):
        try:
            self.read("ok", fn(*a, **kw))
        except Exception as e:          # the error type and its message are part of the trace
            self.read("raise", type(e).__name__, str(e))


# ------------------------------------------------------------ scenarios
def health_death_after_miss_budget(m, t):
    mon = m["health"].GroupHealthMonitor(3, max_misses=2, default_deadline_s=10.0)
    for times in ([1.0] * 3, [1.0] * 3, [1.0] * 3, [1.0, None, 1.0], [1.0, math.inf, 1.0]):
        mon.observe(times)
        t.read(mon.dead_groups(), mon._misses)
    mon.observe([1.0, math.nan, 1.0])
    t.read(mon.dead_groups(), mon.propose((3, 2)))


def health_on_time_round_clears_misses(m, t):
    mon = m["health"].GroupHealthMonitor(2, max_misses=2, default_deadline_s=10.0)
    for times in ([1.0, None], [1.0, None], [1.0, 1.0]):
        mon.observe(times)
        t.read(mon._misses, mon.dead_groups())


def health_backoff_extends_deadline(m, t):
    mon = m["health"].GroupHealthMonitor(2, backoff=2.0, max_misses=3)
    t.read(mon.deadline_s(1), mon.default_deadline_s)
    for times in ([1.0, 1.0], [1.0, 1.0], [1.0, 1.0], [1.0, None], [1.0, None]):
        mon.observe(times)
        t.read(mon.deadline_s(0), mon.deadline_s(1))


def health_miss_does_not_trip_slow_ema(m, t):
    mon = m["health"].GroupHealthMonitor(4, max_misses=3, default_deadline_s=10.0)
    for _ in range(3):
        mon.observe([1.0] * 4)
    mon.observe([1.0, 1.0, 1.0, None])
    t.read(mon.propose((4, 1)), mon.straggler._ema)


def health_dead_takes_precedence_over_slow(m, t):
    mon = m["health"].GroupHealthMonitor(4, max_misses=0, default_deadline_s=10.0)
    for _ in range(5):
        mon.observe([1.0, 3.0, 1.0, 1.0])
    t.read(mon.propose((4, 1)))
    mon.observe([1.0, 3.0, 1.0, None])
    t.read(mon.propose((4, 1)), mon.straggler.speeds)


def health_refuses_eviction_at_two_groups(m, t):
    mon = m["health"].GroupHealthMonitor(2, max_misses=0, default_deadline_s=10.0)
    mon.observe([1.0, None])
    t.read(mon.dead_groups(), mon.propose((2, 4)))


def health_evict_remaps_indices(m, t):
    mon = m["health"].GroupHealthMonitor(4, max_misses=0, default_deadline_s=10.0)
    mon.observe([1.0, 1.0, None, None])
    t.read(mon.dead_groups())
    mon.evict(2)
    t.read(mon.num_groups, mon.dead_groups(), mon.straggler.num_partitions, mon._misses)
    t.call(mon.evict, 3)


def health_restarts_on_layout_change(m, t):
    mon = m["health"].GroupHealthMonitor(3, max_misses=0, default_deadline_s=10.0)
    mon.observe([1.0, None, 1.0])
    t.read(mon.dead_groups())
    mon.observe([1.0, 1.0, 1.0, 1.0])
    t.read(mon.num_groups, mon.dead_groups(), mon._misses)


def health_flapping_dead_recovered_slow_dead(m, t):
    mon = m["health"].GroupHealthMonitor(3, max_misses=1, default_deadline_s=10.0)
    for _ in range(3):
        mon.observe([1.0, 1.0, 1.0])
    t.read(mon.deadline_s(2))
    for times in ([1.0, 1.0, None], [1.0, 1.0, None]):
        mon.observe(times)
        t.read(mon.dead_groups(), mon.deadline_s(2), mon.propose((3, 1)))
    mon.mark_recovered(2)
    t.read(mon.dead_groups(), mon.deadline_s(2))
    for _ in range(8):
        mon.observe([1.0, 1.0, 2.5])
    t.read(mon.dead_groups(), mon.propose((3, 1)))
    mon.observe([1.0, 1.0, None])
    mon.observe([1.0, 1.0, None])
    t.read(mon.dead_groups(), mon.propose((3, 1)))
    t.call(mon.mark_recovered, 5)


def straggler_restarts_ema_on_group_count_change(m, t):
    st = m["straggler"].StragglerState(3)
    for _ in range(4):
        st.observe([1.0, 1.0, 5.0])
    t.read(st._ema, st.speeds, st.needs_rebalance(), st.slowest)
    st.observe([2.0, 2.0])
    t.read(st.num_partitions, st._ema)


def straggler_refuses_eviction_at_two_groups(m, t):
    st = m["straggler"].StragglerState(2)
    for _ in range(5):
        st.observe([1.0, 99.0])
    t.read(st.propose_group_eviction((2, 2)),
           m["straggler"].StragglerState(4).propose_group_eviction((4, 1)))


def straggler_evict_remaps_ema_rows(m, t):
    st = m["straggler"].StragglerState(4)
    st.observe([1.0, 2.0, 3.0, 9.0])
    st.evict(1)
    t.read(st.num_partitions, st._ema, st.slowest, st.propose_group_eviction((3, 1)))
    t.call(st.evict, 3)


def straggler_survives_layout_change_without_evict(m, t):
    st = m["straggler"].StragglerState(num_partitions=4)
    st.observe([1.0, 1.0, 1.0, 2.0])
    st.observe([1.0, 1.0, 1.0])
    t.read(st.num_partitions, st.speeds)


def straggler_no_eviction_below_threshold(m, t):
    st = m["straggler"].StragglerState(num_partitions=4)
    for _ in range(5):
        st.observe([1.0, 1.1, 1.0, 1.2])
    t.read(st.propose_group_eviction((4, 1)), st.needs_rebalance(), st.speeds)
    st2 = m["straggler"].StragglerState(num_partitions=2)
    for _ in range(5):
        st2.observe([1.0, 99.0])
    t.read(st2.propose_group_eviction((2, 1)))


def straggler_weighted_partition(m, t):
    for extent, patch, r, speeds in ((26, 2, 0.5, (1.0, 2.0, 1.0)), (40, 1, 0.25, (3, 1, 1, 1)),
                                     (9, 1, 1.0, (1.0, 1.0)), (6, 2, 0.5, (1, 1, 1, 1))):
        t.call(lambda: _partition_fields(m["straggler"].plan_weighted_partition(
            extent, patch, r, speeds)))


def _partition_fields(plan):
    return tuple((k, _plain(v)) for k, v in sorted(vars(plan).items()))


def fault_plan_parses_and_describes(m, t):
    f = m["faults"]
    plan = f.parse_fault_plan("dead:1@4, slow:0x2.5, corrupt@3")
    t.read(plan.dead, plan.slow, plan.corrupt, plan.describe(), plan.touches_health)
    t.read(f.parse_fault_plan(None), f.parse_fault_plan(plan) is plan,
           f.parse_fault_plan("corrupt@2").touches_health)
    t.call(f.parse_fault_plan, "explode@7")


def fault_plan_dead_is_sticky_until_recovered(m, t):
    plan = m["faults"].ServingFaultPlan.parse("dead:1@4")
    t.read(plan.active_dead(3), plan.heartbeats(3, 3), plan.active_dead(4),
           plan.active_dead(2), plan.heartbeats(2, 3))
    plan.mark_recovered(1)
    t.read(plan.active_dead(9), plan.heartbeats(9, 2), plan.drain_events())


def fault_plan_corrupt_fires_once(m, t):
    plan = m["faults"].ServingFaultPlan.parse("corrupt@2")
    t.read(plan.corrupt_fires(1), plan.corrupt_fires(2), plan.corrupt_fires(2),
           plan.drain_events())


def fault_plan_parse_errors_name_offending_chunk(m, t):
    for spec in ("dead:@3", "dead:1@0", "slow:1x0", "dead:1@2,dead:1@5", "corrupt@2,corrupt@2",
                 "replica:0:dead@0", "replica:0:slow:1x2,replica:0:slow:1x3",
                 "replica:1:replica:0:dead@2", "replica:x:dead@2"):
        t.call(m["faults"].ServingFaultPlan.parse, spec)


def fault_plan_describe_round_trips(m, t):
    for spec in ("dead:1@4,slow:0x2.5,corrupt@3", "replica:1:dead@3",
                 "replica:0:slow:1x2,replica:1:dead@5,dead:2@7",
                 "replica:2:corrupt@2,replica:2:slow:0x3"):
        plan = m["faults"].ServingFaultPlan.parse(spec)
        rt = m["faults"].ServingFaultPlan.parse(plan.describe())
        t.read(plan.describe(), rt.describe(), rt.dead, rt.slow, rt.corrupt, rt.replica_dead,
               sorted(rt.replica_scoped), plan.has_replica_targets)


def fault_plan_for_replica_splits_scoped_chunks(m, t):
    plan = m["faults"].ServingFaultPlan.parse("replica:1:dead@3,replica:0:slow:1x2,dead:2@7")
    t.read(plan.has_replica_targets, plan.replicas_targeted())
    sub0, sub1 = plan.for_replica(0), plan.for_replica(1)
    t.read(sub0.slow, sub0.die_step, sub1.die_step, sub1.die_replica, sub1.dead,
           plan.for_replica(2), sub1.describe())
    t.read(sub1.die_fires(2), sub1.die_fires(3), sub1.die_fires(1), sub1.drain_events())


def health_and_straggler_feed_their_metrics(m, t):
    reg = m["registry"]()
    mon = m["health"].GroupHealthMonitor(4, max_misses=1, default_deadline_s=10.0,
                                         metrics=reg)
    for times in ([1.0] * 4, [1.0, 2.5, 1.0, 1.0], [1.0, None, 1.0, 1.0],
                  [1.0, math.inf, 1.0, None], [1.0, None, 1.0, 1.0]):
        mon.observe(times)
        t.read(reg.snapshot())
    mon.mark_recovered(1)
    mon.evict(3)
    t.read(reg.snapshot(), mon.straggler.metrics is reg)
    ema = m["straggler"].StragglerState(3, metrics=reg)
    ema.observe([1.0, 3.0, 1.0])
    t.read(reg.gauge_value("straggler.imbalance"), reg.gauge_value("straggler.slowest_group"))


SCENARIOS = [health_and_straggler_feed_their_metrics, health_death_after_miss_budget, health_on_time_round_clears_misses,
             health_backoff_extends_deadline, health_miss_does_not_trip_slow_ema,
             health_dead_takes_precedence_over_slow, health_refuses_eviction_at_two_groups,
             health_evict_remaps_indices, health_restarts_on_layout_change,
             health_flapping_dead_recovered_slow_dead,
             straggler_restarts_ema_on_group_count_change,
             straggler_refuses_eviction_at_two_groups, straggler_evict_remaps_ema_rows,
             straggler_survives_layout_change_without_evict,
             straggler_no_eviction_below_threshold, straggler_weighted_partition,
             fault_plan_parses_and_describes, fault_plan_dead_is_sticky_until_recovered,
             fault_plan_corrupt_fires_once, fault_plan_parse_errors_name_offending_chunk,
             fault_plan_describe_round_trips, fault_plan_for_replica_splits_scoped_chunks]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_copy_reads_what_the_reference_reads(scenario):
    want, got = Trace(), Trace()
    scenario(REF, want)
    scenario(PORT, got)
    assert len(got) > 0 and got == want


# ---------------------------------------------------------- corrupt wire
def _simulate(sim, codec, nan_guard, to):
    z = np.random.default_rng(0).normal(size=(26, 3, 2)).astype(np.float32)
    plan = (plan_uniform if to is torch.from_numpy else jplan_uniform)(26, 2, 3, 0.5)
    tanh = torch.tanh if to is torch.from_numpy else jnp.tanh
    return np.asarray(sim(lambda x: tanh(x) * 0.5 + x, to(z), plan, 0, codec,
                          nan_guard=nan_guard))


def test_corrupting_codec_and_nan_guard_as_the_reference():
    corrupt = faults.CorruptingCodec.wrap(get_codec("int8"))
    jcorrupt = jfaults.CorruptingCodec.wrap(jget_codec("int8"))
    assert (corrupt.name, corrupt.stateful, corrupt.meta_bytes) == \
        (jcorrupt.name, jcorrupt.stateful, jcorrupt.meta_bytes) == ("int8-corrupt", False, 4)
    for guard in (False, True):
        got = _simulate(simulate_halo_forward, corrupt, guard, torch.from_numpy)
        want = _simulate(jsimulate, jcorrupt, guard, jnp.asarray)
        assert np.isfinite(got).all() == np.isfinite(want).all() == guard
        assert np.array_equal(np.isnan(got), np.isnan(want))
    clean = [_simulate(simulate_halo_forward, get_codec("int8"), g, torch.from_numpy)
             for g in (False, True)]
    assert np.array_equal(clean[0], clean[1])
    with pytest.raises(ValueError, match="stateless"):
        faults.CorruptingCodec.wrap(get_codec("int8-residual"))


# --------------------------------------------------------------- replan
def _single_dim_z(seed):
    # spatial (8, 2, 2) with patches (1, 2, 2): only dim 0 is usable at every K
    return np.random.default_rng(seed).normal(size=(1, 8, 2, 2, 3)).astype(np.float32)


def _den_port(w, t):
    return torch.tanh(w) * 0.1 + w * 1e-4 * t


def _den_ref(w, t):
    return jnp.tanh(w) * 0.1 + w * 1e-4 * t


def _both(build):
    """``build(pkg)`` with the port's and the reference's pieces."""
    port = dict(compiler=LPStepCompiler, denoise=lp_denoise, sampler=FlowMatchEuler,
                snapshot=DenoiseSnapshot, replan=elastic.replan_lp_compiler, den=_den_port,
                z=lambda a: torch.from_numpy(a), straggler=straggler)
    ref = dict(compiler=JCompiler, denoise=jlp_denoise, sampler=JSampler, snapshot=JSnapshot,
               replan=jelastic.replan_lp_compiler, den=_den_ref, z=jnp.asarray,
               straggler=jstraggler)
    return build(port), build(ref)


def _within_a_code_step(got, want):
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want)
    assert d.max() <= 1e-4 + np.abs(want).max() / 127, d.max()
    assert (d > 1e-4 + 1e-4 * np.abs(want)).mean() <= 0.01


def test_replan_resets_codec_state_once_and_never_reuses_stale():
    def build(p):
        sampler = p["sampler"](10)
        comp = p["compiler"](p["den"], sampler.update, 4, 0.5, (1, 2, 2), (1, 2, 3),
                             uniform=True, codec="int8-residual", mesh_shape=(4, 1))
        st = p["straggler"].StragglerState(num_partitions=4)
        for _ in range(5):
            st.observe([1.0, 1.0, 1.0, 5.0])
        evicted, new_shape = st.propose_group_eviction((4, 1))

        def hook(i):
            if i == 6:
                assert p["replan"](comp, new_shape)

        out = p["denoise"](None, p["z"](_single_dim_z(0)), sampler, 10, 4, 0.5, (1, 2, 2),
                           (1, 2, 3), uniform=True, compiler=comp, step_hook=hook)
        return out, (evicted, new_shape, comp.num_partitions, comp.mesh_shape,
                     comp.plan_epoch, comp.state_inits, comp.compiles, comp.hits)

    (got, port), (want, ref) = _both(build)
    assert port == ref == (3, (3, 1), 3, (3, 1), 1, 2, 2, 8)
    _within_a_code_step(got, want)


def test_replan_fault_resume_twice_bit_identical_to_fault_free():
    class Fault(RuntimeError):
        pass

    def build(p):
        steps = 10
        sampler = p["sampler"](steps)
        z = p["z"](_single_dim_z(2))

        def mk(shape):
            return p["compiler"](p["den"], sampler.update, 4, 0.5, (1, 2, 2), (1, 2, 3),
                                 uniform=True, codec="int8-residual", mesh_shape=shape)

        def run(comp, hook, snap):
            return p["denoise"](None, z, sampler, steps, 4, 0.5, (1, 2, 2), (1, 2, 3),
                                uniform=True, compiler=comp, step_hook=hook, snapshot=snap)

        twin = mk((4, 1))
        clean = run(twin, lambda i: (i == 4 and twin.plan_epoch == 0
                                     and p["replan"](twin, (2, 1))), None)
        comp, snap, seen = mk((4, 1)), p["snapshot"](), []

        def hook1(i):
            if i == 4:
                assert p["replan"](comp, (3, 1))
            if i == 6:
                raise Fault

        def hook2(i):
            if i == 4 and comp.plan_epoch == 1:
                assert p["replan"](comp, (2, 1))
            if i == 6:
                raise Fault

        for hook in (hook1, hook2):
            with pytest.raises(Fault):
                run(comp, hook, snap)
            seen.append((snap.step, snap.plan_epoch, snap.resumes))
        out = run(comp, lambda i: None, snap)
        seen.append((snap.resumes, comp.num_partitions, comp.plan_epoch, comp.state_inits))
        return out, clean, seen

    (got, got_clean, port), (want, want_clean, ref) = _both(build)
    assert port == ref and port[:2] == [(3, 1, 0), (3, 2, 1)]
    assert torch.equal(got, got_clean)          # the port's own fault-free twin, bit for bit
    _within_a_code_step(got, want)


def test_replan_contract_checks_as_the_reference():
    """A group-bound hook needs a re-bound one when K changes (not when only
    T does); a no-op re-plan is free; ``wire_shard`` flips need a re-bound
    hook; without a re-plan the hooked loop threads the state across
    same-dim steps (one init)."""
    def never(fn, z, plan, axis):
        raise AssertionError("never called")

    def build(p):
        t = Trace()
        sampler = p["sampler"](2)
        comp = p["compiler"](p["den"], sampler.update, 4, 0.5, (1, 2, 2), (1, 2, 3),
                             uniform=True, forward=never, mesh_shape=(4, 2))
        t.call(p["replan"], comp, (3, 2))
        t.read(p["replan"](comp, (4, 1)), comp.plan_epoch)
        t.read(p["replan"](comp, (3, 2), forward=never), comp.num_partitions,
               comp.mesh_shape, comp.plan_epoch)
        t.call(comp.replan, wire_shard=True)
        t.read(comp.wire_shard, comp.replan(wire_shard=True, forward=lambda *a: None),
               comp.wire_shard, comp.plan_epoch)
        free = p["compiler"](p["den"], sampler.update, 4, 0.5, (1, 2, 2), (1, 2, 3),
                             uniform=True, codec="int8-residual", mesh_shape=(4, 2))
        t.read(p["replan"](free, (4, 2)), free.plan_epoch, free.state_inits)
        s6 = p["sampler"](6)
        carry = p["compiler"](p["den"], s6.update, 2, 0.5, (1, 2, 2), (1, 2, 3),
                              uniform=True, codec="int8-residual")
        p["denoise"](None, p["z"](_single_dim_z(1)), s6, 6, 2, 0.5, (1, 2, 2), (1, 2, 3),
                     uniform=True, compiler=carry, step_hook=lambda i: None)
        t.read(carry.state_inits, carry.compiles, carry.hits)
        return t

    port, ref = _both(build)
    assert port == ref
    assert port[0][:2] == ("raise", "ValueError") and "re-bound forward" in port[0][2]


# ----------------------------------------------------- engine drills
@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("wan21-dit-1.3b").reduced()
    params = jmodels.build(jcfg).init(jax.random.PRNGKey(0))
    tcfg = get_config("wan21-dit-1.3b").reduced()
    model = tdit.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    ctx = np.array(jfrontends.text_context(jax.random.PRNGKey(100), 1, jcfg))
    return jcfg, params, tcfg, model, ctx


def _jax_noise(shape, seed, device):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), shape)))


def _drill(models, monkeypatch, shape, recorders=(None, None), **kw):
    """One request through the reference engine and the port's (the
    reference's noise; ``recorders``: the port's and the reference's):
    each engine and its result, or the error raised."""
    jcfg, params, tcfg, model, ctx = models
    args = dict(overlap_ratio=0.5, num_steps=3, max_batch=1, **kw)
    jeng = JEngine(lambda p, z, t, c, m: jdit.forward(p, z, t, c, m), params, jcfg, **args,
                   recorder=recorders[1])
    jeng.submit(JRequest(0, jnp.asarray(ctx), shape, seed=0))
    monkeypatch.setattr(teng, "initial_noise", _jax_noise)
    eng = teng.LPServingEngine(model, tcfg, device="cpu", **args, recorder=recorders[0])
    eng.submit(teng.VideoRequest(0, torch.from_numpy(ctx), shape, seed=0))
    out = []
    for e in (eng, jeng):
        try:
            out.append((e, e.run()[0]))
        except jfaults.ServingFault as err:
            out.append((e, err))
        except faults.ServingFault as err:
            out.append((e, err))
    return out


def _outcome(eng, res):
    fields = (eng.evictions, eng.K, eng._compiler.num_partitions, eng.health.num_groups,
              eng.last_steps_lost, len(eng._lifecycle))
    if isinstance(res, Exception):
        return fields + (type(res).__name__, str(res))
    return fields + (res.restarts, res.resumed_from_step)


def test_dead_group_evicted_and_batch_resumed_as_the_reference(models, monkeypatch):
    (eng, res), (jeng, jres) = _drill(models, monkeypatch, (8, 8, 12), num_partitions=4,
                                      elastic=True, wire_codec="int8",
                                      inject_fault="dead:3@2")
    assert _outcome(eng, res) == _outcome(jeng, jres) == (1, 3, 3, 3, 0, 0, 2, 1)
    _within_a_code_step(res.latent.numpy(), jres.latent)


def test_dead_group_without_elastic_exhausts_restarts_as_the_reference(models, monkeypatch):
    (eng, res), (jeng, jres) = _drill(models, monkeypatch, (8, 8, 12), num_partitions=4,
                                      elastic=False, wire_codec="int8",
                                      inject_fault="dead:3@2")
    assert _outcome(eng, res) == _outcome(jeng, jres)
    assert isinstance(res, faults.ServingFault) and "stopped heartbeating" in str(res)


@pytest.mark.parametrize("guard", [True, False])
def test_corrupt_drill_as_the_reference(models, monkeypatch, guard):
    (eng, res), (jeng, jres) = _drill(models, monkeypatch, (4, 8, 12), num_partitions=2,
                                      wire_codec="int8", inject_fault="corrupt@2",
                                      wire_nan_guard=guard)
    assert _outcome(eng, res) == _outcome(jeng, jres)
    got, want = res.latent.numpy(), np.asarray(jres.latent, np.float32)
    assert np.isfinite(got).all() == np.isfinite(want).all() == guard
    assert eng._compiler.codec.name == jeng._compiler.codec.name == "int8"
    assert {k[7] for k in eng._compiler._cache} == {k[6] for k in jeng._compiler._cache} == \
        {"int8", "int8-corrupt"}
    if guard:
        _within_a_code_step(got, want)
    else:
        assert np.array_equal(np.isnan(got), np.isnan(want))


def test_fault_config_errors_as_the_reference(models):
    _, _, tcfg, model, _ = models
    for kw, match in ((dict(num_partitions=2, inject_fault="corrupt@1"), "has none"),
                      (dict(num_partitions=2, wire_codec="int8-residual",
                            inject_fault="corrupt@1"), "stateless"),
                      (dict(num_partitions=2, inject_fault="replica:1:dead@3"),
                       "replica:-scoped")):
        with pytest.raises(ValueError, match=match):
            teng.LPServingEngine(model, tcfg, num_steps=2, device="cpu", **kw)


SCHEDULE = "int8-residual@0.85,int8@0.6,bf16"


def test_scheduled_drill_as_the_reference(models, monkeypatch):
    """``dead:3@2`` with ``elastic`` on a scheduled engine (K 4, 3 steps:
    int8-residual, int8-residual, int8), each engine with its recorder: the
    same outcome, the plan re-resolved at K 3 the same, the same per-step
    attribution across the eviction, the latent within one code step."""
    jrec, rec = JRecorder(), FlightRecorder()
    kw = dict(num_partitions=4, elastic=True, codec_schedule=SCHEDULE, inject_fault="dead:3@2")
    (eng, res), (jeng, jres) = _drill(models, monkeypatch, (8, 8, 12), recorders=(rec, jrec),
                                      **kw)
    assert _outcome(eng, res) == _outcome(jeng, jres) == (1, 3, 3, 3, 0, 0, 2, 1)
    assert dataclasses.asdict(eng.plan) == dataclasses.asdict(jeng.plan)
    assert eng.plan.wire_bytes != 0 and eng._geom_events == jeng._geom_events == [(1, 4), (2, 3)]
    assert rec.wire_steps == jrec.wire_steps and [r["K"] for r in rec.wire_steps] == [4, 3, 3]
    assert rec.plans == jrec.plans and len(rec.plans) == 2
    names = sorted(e["name"] for e in rec.trace.events)
    assert names == sorted(e["name"] for e in jrec.trace.events)
    _within_a_code_step(res.latent.numpy(), jres.latent)


# ----------------------------------------------- a scheduled 3x2 world
SCHED_LATENT = (8, 8, 12)
SCHED_RUNS = (("scheduled-shard", None, True, {"codec_schedule": SCHEDULE}),)
SCHED_DRILL = dict(codec_schedule=SCHEDULE, elastic=True, inject_fault="dead:1@3")


@pytest.fixture(scope="module")
def scheduled_world(tmp_path_factory):
    """A 3x2 gloo world, the exact stand-in DiT: a scheduled request on the
    sharded wire (recorded), then the scheduled drill ``dead:1@3``."""
    import torch_dist_cases as cases
    from repro_torch.launch import mesh as tmesh

    rng = np.random.default_rng(7)
    ctx = [(0.02 * rng.normal(size=(1, 16, 128))).astype(np.float32) for _ in range(2)]
    reqs = [(0, ctx[0], SCHED_LATENT, 0), (1, ctx[1], SCHED_LATENT, 1)]
    ranks = tmesh.run_lp_world(cases.hybrid_engine_runs, 3,
                               (SCHED_RUNS, SCHED_DRILL, reqs, 4, True), tp=2,
                               workdir=str(tmp_path_factory.mktemp("scheduled_world")),
                               device="cpu", deadline_s=300)
    return ranks, ctx


def _one_process_scheduled(ctx, **kw):
    import torch_dist_cases as cases

    cfg = get_config("wan21-dit-1.3b").reduced()
    eng = teng.LPServingEngine(cases.exact_dit, cfg, num_partitions=3, num_steps=4,
                               max_batch=1, device="cpu", **kw)
    out = []
    for rid in (0, 1):
        eng.submit(teng.VideoRequest(rid, torch.from_numpy(ctx[rid]), SCHED_LATENT, seed=rid))
        out.append(eng.run()[0])
    return eng, out


def test_scheduled_sharded_request_on_a_3x2_group(scheduled_world):
    """Every rank bit-equal to the one-process scheduled engine; each
    rank's recorder attribution equal to its byte counter per step and
    tier; one plan on every rank (the sharded hybrid halo)."""
    ranks, ctx = scheduled_world
    _, (want, _) = _one_process_scheduled(ctx, codec_schedule=SCHEDULE)
    kinds = ("all-gather", "all-reduce", "collective-permute")
    for r in ranks:
        run = r["runs"]["scheduled-shard"]
        assert torch.equal(run["latent"], want.latent)
        assert run["plan"] == ranks[0]["runs"]["scheduled-shard"]["plan"]
        assert run["plan"]["lp_impl"] == "halo_hybrid" and run["wire_shard"] is True
        assert run["trace_ok"] and run["compiles"] <= 3 * 3 and len(run["wire_steps"]) == 4
        snaps = run["snaps"]
        for i, rec in enumerate(run["wire_steps"]):
            for tier in ("inter", "intra"):
                a, b = snaps[i]["tiers"][tier]["payload"], snaps[i + 1]["tiers"][tier]["payload"]
                assert {k: b[k] - a[k] for k in kinds} == \
                    {k: rec[tier].get(k, 0.0) for k in kinds}, (i, tier)
        assert sum(rec["intra_bytes"] for rec in run["wire_steps"]) > 0


def test_scheduled_drill_on_a_3x2_group(scheduled_world):
    """The scheduled ``dead:1@3`` drill: group 1's ranks leave, the
    survivors shrink to 2x2, finish bit-equal to the one-process scheduled
    drill, and hold the plan re-resolved at K 2, equal to the reference's
    resolution at K 2 (tp 2; the one-process engine's at tp 1)."""
    ranks, ctx = scheduled_world
    eng, (first, second) = _one_process_scheduled(ctx, **SCHED_DRILL)
    assert eng.K == 2 and eng.evictions == 1
    left = [w for w, r in enumerate(ranks) if "evicted" in r]
    assert left == [2, 3] and all(ranks[w]["evicted"] == (1, 3) for w in left)
    jcfg = jget_config("wan21-dit-1.3b").reduced()
    ccfg = jcm.VDMCommConfig(latent_dims=(13, 60, 104), latent_channels=jcfg.latent_channels,
                             patch_sizes=jcfg.patch_sizes, d_model=jcfg.d_model,
                             num_blocks=jcfg.num_layers, num_steps=4)
    for tp, plan in ((2, None), (1, dataclasses.asdict(eng.plan))):
        want = dataclasses.asdict(jresolve(SCHEDULE, ccfg, 2, 0.5, JSampler(4), 4, tp=tp))
        if plan is None:
            for w, r in enumerate(ranks):
                if w not in left:
                    assert r["drill"]["plan"] == want
        else:
            assert plan == want
    for w, r in enumerate(ranks):
        if w in left:
            continue
        d, a = r["drill"], r["after"]
        assert (d["evictions"], d["K"], d["mesh_shape"], d["restarts"],
                d["resumed_from_step"]) == (1, 2, (2, 2), first.restarts,
                                            first.resumed_from_step)
        assert torch.equal(d["latent"], first.latent) and torch.equal(a["latent"],
                                                                       second.latent)
