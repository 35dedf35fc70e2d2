"""The port's step policy (``repro_torch/policy``) against the JAX package, on the CPU.

* The copies (``policy/envelope``, ``schedule``, ``autotune``) read what
  the reference reads: the same scenarios run on the reference's modules
  and on the port's, and every value they read, and every error they raise
  (type and message), must be equal.  ``parse_schedule`` over valid and
  malformed specs; ``step_codecs`` / ``segment_steps`` over FlowMatch
  trajectories (4-20 steps, shift 1 and 3) and DDIM's timestep fallback;
  the envelope functions; ``auto_plan`` and ``resolve_cli_schedule`` (every
  ``StepPolicyPlan`` field and the recorder's plan rows) over K 2-4, tp 1
  and 2, floors 24 / 40 / 50 / None, ``wire_shard`` None / False / True, on
  the reduced WAN geometry, the smoke's (13, 30, 52), the 480p
  (21, 60, 104) and a geometry with one usable dim (where displaced codecs
  are offered).
* The scheduled step contracts of ``LPStepCompiler`` / ``lp_denoise``
  (``tests/test_step_policy.py``) on both packages with an elementwise
  denoiser: misses, state inits, the cache's codec slot, re-plans with a
  group-bound factory, the refusals.
* A scheduled ``lp_denoise`` on the reduced DiT (f32) against the
  reference's ``lp_denoise(schedule=...)``: the latents within the coded
  tolerance of ``test_torch_engine.py`` (one code step: ``max |d| <= 1e-4
  + max|a| / 127``, at most 1% of the values beyond ``1e-4 + 1e-4 |a|``),
  equal ``state_inits``, misses <= 3 x segments, and a resume from a
  segment-boundary snapshot bit-equal to the port's uninterrupted run.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import policy as jpolicy
from repro.configs import get_config as jget_config
from repro.core import LPStepCompiler as JCompiler
from repro.core import comm_model as jcm
from repro.core import lp_denoise as jlp_denoise
from repro.core.lp_step import DenoiseSnapshot as JSnapshot
from repro.diffusion.pipeline import make_guided_step_denoiser as jguided_step
from repro.diffusion.sampler import DDIM as JDDIM
from repro.diffusion.sampler import FlowMatchEuler as JFlow
from repro.models import dit as jdit
from repro.policy import autotune as jautotune
from repro.policy import schedule as jschedule
from repro.runtime import elastic as jelastic
from repro_torch import obs as tobs
from repro_torch import policy as tpolicy
from repro_torch.configs import get_config
from repro_torch.core import DenoiseSnapshot, LPStepCompiler, lp_denoise
from repro_torch.core import comm_model as tcm
from repro_torch.diffusion.pipeline import make_guided_step_denoiser
from repro_torch.diffusion.sampler import DDIM, FlowMatchEuler
from repro_torch.models import dit as tdit
from repro_torch.policy import autotune as tautotune
from repro_torch.policy import schedule as tschedule
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime.ft import DeviceFailure

REF = dict(policy=jpolicy, schedule=jschedule, autotune=jautotune, cm=jcm, Flow=JFlow,
           DDIM=JDDIM, obs=jobs, Compiler=JCompiler, denoise=jlp_denoise,
           elastic=jelastic, z=jnp.asarray, snapshot=JSnapshot, codec_slot=6,
           den=lambda w, t: jnp.tanh(w) * 0.1 + w * 1e-4 * t)
PORT = dict(policy=tpolicy, schedule=tschedule, autotune=tautotune, cm=tcm, Flow=FlowMatchEuler,
            DDIM=DDIM, obs=tobs, Compiler=LPStepCompiler, denoise=lp_denoise,
            elastic=telastic, z=torch.from_numpy, snapshot=DenoiseSnapshot, codec_slot=7,
            den=lambda w, t: torch.tanh(w) * 0.1 + w * 1e-4 * t)


def _plain(x):
    """A value as plain Python, comparable across the two packages."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating, np.bool_)):
        return x.item()
    if type(x) in (list, tuple):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "segments") and hasattr(x, "fixed_codec"):          # a CodecSchedule
        return ("schedule", x.spec, x.fixed_codec,
                tuple((s.codec, s.sigma_lo) for s in x.segments))
    if hasattr(x, "num_steps") and hasattr(x, "codec") and hasattr(x, "start"):  # a StepRun
        return ("run", x.codec, x.start, x.stop, x.num_steps)
    if hasattr(x, "reduction_vs_fp32_halo"):                           # a StepPolicyPlan
        return ("plan", {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)},
                x.num_segments, x.reduction_vs_fp32_halo, x.describe())
    return x


class Trace(list):
    def read(self, *values):
        self.append(tuple(_plain(v) for v in values))

    def call(self, fn, *a, **kw):
        try:
            self.read("ok", fn(*a, **kw))
        except Exception as e:          # the error type and its message are part of the trace
            self.read("raise", type(e).__name__, str(e))


def _both(build):
    return build(PORT), build(REF)


# ------------------------------------------------------------- grammar
SPECS = [None, "fp32", "int8", " int8-residual@0.85 , int8@0.6 ,bf16 ",
         "int4-residual@0.85,int8-residual@0.45,bf16", "int8@0.9,int8@0.5,bf16",
         "displaced:int8-residual@0.75,int8-residual", "bf16@0.999,fp32",
         # malformed: the reference's cases and more
         "", ",", "int8@0.5", "int8@0.5,bf16@0.7,fp32", "int8@0.5,int4@0.5,fp32",
         "int8@zz,fp32", "int7", "bf16,int8", "int8-residual@4.5,bf16",
         "int8@1.0,bf16", "int8@-0.1,bf16", "auto", "displaced:int8@0.5,bf16"]


def test_parse_schedule_as_the_reference():
    def build(m):
        t = Trace()
        for spec in SPECS:
            t.call(m["policy"].parse_schedule, spec)
        s = m["policy"].parse_schedule("int4-residual@0.85,int8-residual@0.45,bf16")
        t.read(m["policy"].parse_schedule(s.spec) == s, m["policy"].parse_schedule(s) is s,
               m["policy"].CodecSchedule.fixed("bf16"), s.codec_for_sigma(0.9),
               s.codec_for_sigma(0.45), s.codec_for_sigma(-1.0))
        t.call(m["policy"].CodecSchedule, ())
        t.call(m["policy"].CodecSchedule, (m["schedule"].ScheduleSegment("int8", 0.5),))
        return t

    port, ref = _both(build)
    assert port == ref
    assert sum(r[0] == "raise" for r in port) == 15       # every malformed spec refused


def _samplers(m):
    out = [(f"flow{n}-shift{s}", m["Flow"](n, shift=s), n)
           for n in (4, 5, 6, 8, 12, 16, 20) for s in (1.0, 3.0)]
    return out + [(f"ddim{n}", m["DDIM"](n), n) for n in (4, 8, 20)]


SCHEDULES = ["int8-residual@0.85,int8@0.6,bf16", "int4-residual@0.8,int8-residual@0.45,bf16",
             "int8@0.75,bf16", "int8@0.9,int8@0.5,bf16", "fp32", "int4@0.3,fp32"]


def test_trajectory_resolution_as_the_reference():
    def build(m):
        t = Trace()
        for name, sampler, n in _samplers(m):
            sigmas = m["schedule"].trajectory_sigmas(sampler, n)
            t.read(name, sigmas)
            for spec in SCHEDULES:
                s = m["policy"].parse_schedule(spec)
                t.read(s.step_codecs(sigmas), m["policy"].segment_steps(s, sigmas))
        t.call(m["schedule"].trajectory_sigmas, m["Flow"](4), 5)
        return t

    port, ref = _both(build)
    assert port == ref
    # the smoke's trajectory: 4 FlowMatch steps at shift 3, and its schedule's segments
    sig = tschedule.trajectory_sigmas(FlowMatchEuler(4), 4)
    assert np.allclose(sig, (1.0, 0.9, 0.75, 0.5))
    runs = tpolicy.segment_steps(tpolicy.parse_schedule(SCHEDULES[0]), sig)
    assert [(r.codec, r.start, r.stop) for r in runs] == [
        ("int8-residual", 1, 2), ("int8", 3, 3), ("bf16", 4, 4)]


def test_envelope_as_the_reference():
    def build(m):
        t = Trace()
        p = m["policy"]
        names = sorted(p.PSNR_ENVELOPE_DB) + ["int7"]
        t.read(p.PSNR_ENVELOPE_DB, p.HIGH_NOISE_CREDIT_DB)
        for name in names:
            t.call(p.codec_floor_db, name)
            for sigma in (0.0, 0.2, 0.5, 0.85, 1.0, -0.3):
                t.call(p.effective_floor_db, name, sigma)
                t.call(p.effective_floor_db, name, sigma, credit_db=10.0)
        env = __import__(p.__name__ + ".envelope", fromlist=["x"])
        for floor in (12.0, 24.0, 40.0, 50.0, 60.0):
            for sigma in (0.0, 0.3, 0.8, 1.0):
                t.read(env.admissible_codecs(floor, sigma),
                       env.admissible_codecs(floor, sigma, ("int8", "bf16"), credit_db=5.0))
        t.call(p.schedule_envelope_db, ["int4", "bf16"], [0.8, 0.0], credit_db=20.0)
        t.call(p.schedule_envelope_db, ["int8", "int8-residual", "bf16"], [1.0, 0.9, 0.5])
        t.call(p.schedule_envelope_db, ["int8"], [0.5, 0.1])
        t.call(p.schedule_envelope_db, [], [])
        return t

    port, ref = _both(build)
    assert port == ref


# ------------------------------------------------------------ autotune
def _geometries(m):
    """(name, VDMCommConfig factory of num_steps): the reduced WAN latent,
    the smoke's, the 480p one, one usable dim (tests/test_step_policy.py:414)."""
    red = get_config("wan21-dit-1.3b").reduced()
    full = get_config("wan21-dit-1.3b")

    def cfg(dims, c, steps):
        return m["cm"].VDMCommConfig(latent_dims=dims, latent_channels=c.latent_channels,
                                     patch_sizes=c.patch_sizes, d_model=c.d_model,
                                     num_blocks=c.num_layers, num_steps=steps)

    return {
        "reduced": lambda n: cfg((4, 8, 12), red, n),
        "smoke": lambda n: cfg((13, 30, 52), full, n),
        "480p": lambda n: cfg((21, 60, 104), full, n),
        "one-dim": lambda n: m["cm"].VDMCommConfig(latent_dims=(61, 2, 2), latent_channels=16,
                                                   patch_sizes=(1, 2, 2), d_model=96,
                                                   num_blocks=2, num_steps=n),
    }


EXPLICIT = ["int8-residual@0.85,int8@0.6,bf16", "int4-residual@0.8,int8-residual@0.45,bf16",
            "fp32", "int8", "displaced:int8-residual@0.75,int8-residual"]
FLOORS = (24.0, 40.0, 50.0, None)


@pytest.mark.parametrize("K", [2, 3, 4])
@pytest.mark.parametrize("geometry", ["reduced", "smoke", "480p", "one-dim"])
def test_plans_as_the_reference(geometry, K):
    """Every field of every plan, the recorder's plan rows, the ranked
    candidates and the byte-minimal schedules, over the grid: ``auto`` at
    every (tp, wire_shard, floor), ``auto_plan`` without a recorder where
    ``wire_shard`` is left to the cost model, the explicit specs at tp 1
    unpinned (every floor) and at tp 2 with every pin (floors 40 / 50 /
    None)."""
    def build(m):
        t = Trace()
        at, policy = m["autotune"], m["policy"]
        for n in (4, 12):
            ccfg = _geometries(m)[geometry](n)
            sampler = m["Flow"](n)
            t.read(at._rank_candidates(ccfg, K, 0.5, at.DEFAULT_CANDIDATES))
            for floor in (12.0, 24.0, 40.0, 50.0, 70.0):
                t.call(at.schedule_for_floor, ccfg, K, 0.5, floor)
            for tp in (1, 2):
                for ws in (None, False, True):
                    rec = m["obs"].FlightRecorder()
                    for floor in FLOORS:
                        t.call(policy.resolve_cli_schedule, "auto", ccfg, K, 0.5, sampler, n,
                               psnr_floor_db=floor, tp=tp, wire_shard=ws, recorder=rec)
                        # "auto" above is auto_plan with a recorder: itself,
                        # without one, only where wire_shard is unpinned
                        if floor is not None and ws is None:
                            t.call(policy.auto_plan, ccfg, K, 0.5, sampler, n,
                                   psnr_floor_db=floor, tp=tp, wire_shard=ws)
                        if (tp, ws) != (1, None) and (tp == 1 or floor == 24.0):
                            continue
                        for spec in EXPLICIT:
                            t.call(policy.resolve_cli_schedule, spec, ccfg, K, 0.5, sampler,
                                   n, psnr_floor_db=floor, tp=tp, wire_shard=ws, recorder=rec)
                    t.read(rec.plans, rec.metrics.snapshot())
        return t

    port, ref = _both(build)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (geometry, K, i)
    assert any(r[0] == "ok" and r[1][0] == "plan" for r in port)


def test_link_model_and_candidates_as_the_reference():
    def build(m):
        t = Trace()
        at = m["autotune"]
        t.read(at.DEFAULT_CANDIDATES, dataclasses.asdict(at.DEFAULT_LINKS))
        for links in (at.DEFAULT_LINKS, at.LinkModel(10.0, 10.0), at.LinkModel(1.0, 900.0)):
            t.read(links.wire_time_ms(1e6, 3e5), links.wire_time_ms(0, 0))
        ccfg = _geometries(m)["smoke"](4)
        t.call(m["policy"].auto_plan, ccfg, 3, 0.5, m["Flow"](4), 4, tp=2,
               links=at.LinkModel(10.0, 10.0))
        t.call(m["policy"].auto_plan, ccfg, 5, 0.5, m["Flow"](4), 4)       # too few patches
        t.call(m["policy"].auto_plan, ccfg, 3, 0.5, m["Flow"](4), 4, psnr_floor_db=80.0,
               candidates=("int8", "bf16"))
        return t

    port, ref = _both(build)
    assert port == ref


# ------------------------------------------- scheduled step contracts
def _single_dim_z(seed=0):
    # spatial (8, 2, 2) with patches (1, 2, 2): only dim 0 rotates
    return np.random.default_rng(seed).normal(size=(1, 8, 2, 2, 3)).astype(np.float32)


def test_scheduled_step_contracts_as_the_reference():
    """``tests/test_step_policy.py``'s compile, cache-key, refusal and
    re-plan scenarios on both packages: the same state inits, codec slots,
    snapshots, epochs, recorder events and errors.  The step cache's
    misses are held apart: the reference keys a fused scan's length too,
    the port (which runs a run step by step) does not, so the port misses
    at most as often, and at most 3 x the segments."""
    def build(m):
        t = Trace()
        t.misses = []
        C, den, run = m["Compiler"], m["den"], m["denoise"]
        z = m["z"](np.random.default_rng(0).normal(size=(1, 8, 8, 12, 4)).astype(np.float32))
        s12 = m["Flow"](12)
        spec = "int4-residual@0.8,int8-residual@0.45,bf16"
        comp = C(den, s12.update, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True, schedule=spec)
        run(None, z, s12, 12, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True, compiler=comp)
        t.read(comp.state_inits, comp.schedule)
        t.misses.append(comp.compiles)
        run(None, z, s12, 12, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True, compiler=comp)
        t.read(comp.state_inits)
        t.misses.append(comp.compiles)

        s6 = m["Flow"](6)
        one = m["z"](_single_dim_z())
        comp = C(den, s6.update, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True,
                 schedule="int8@0.7,bf16")
        run(None, one, s6, 6, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True, compiler=comp)
        t.read(sorted({k[m["codec_slot"]] for k in comp._cache}))
        t.misses.append(comp.compiles)
        comp = C(den, s6.update, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True,
                 schedule="int8-residual@0.8,int8@0.5,int8-residual")
        run(None, one, s6, 6, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True, compiler=comp)
        t.read(comp.state_inits)              # a fresh state in each residual run
        t.misses.append(comp.compiles)
        snap = m["snapshot"]()
        run(None, one, s6, 6, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True, compiler=comp,
            snapshot=snap)
        t.read(snap.step, snap.boundaries, comp.state_inits)

        for kw in (dict(codec="int8", schedule="int8@0.5,bf16"),
                   dict(forward=lambda *a: None, schedule="int8@0.5,bf16"),
                   dict(schedule="int8@0.5,bf16", uniform=False),
                   dict(schedule="auto"), dict(schedule="int8@0.5")):
            kw = {"uniform": True, **kw}
            t.call(C, den, m["Flow"](2).update, 2, 0.5, (1, 2, 2), (1, 2, 3), **kw)

        def factory(codec):
            raise AssertionError("never called")

        comp = C(den, m["Flow"](2).update, 4, 0.5, (1, 2, 2), (1, 2, 3), uniform=True,
                 schedule="int8@0.5,bf16", forward_factory=factory, mesh_shape=(4, 1))
        t.call(m["elastic"].replan_lp_compiler, comp, (3, 1))
        t.read(m["elastic"].replan_lp_compiler(comp, (4, 2)), comp.plan_epoch)
        t.call(comp.replan, wire_shard=True)
        t.read(m["elastic"].replan_lp_compiler(comp, (3, 2), forward_factory=lambda c: None),
               comp.num_partitions, comp.plan_epoch)
        rec = m["obs"].FlightRecorder()
        t.read(m["elastic"].replan_lp_compiler(comp, (2, 2), forward_factory=factory,
                                               recorder=rec),
               [(e["name"], e["args"]) for e in rec.trace.events])

        s8 = m["Flow"](8)
        comp = C(den, s8.update, 4, 0.5, (1, 2, 2), (1, 2, 3), uniform=True,
                 schedule="int8-residual@0.7,int4-residual", mesh_shape=(4, 1))

        def hook(i):
            if i == 3:
                m["elastic"].replan_lp_compiler(comp, (3, 1))

        rec = m["obs"].FlightRecorder()
        snap = m["snapshot"]()
        run(None, m["z"](_single_dim_z(1)), s8, 8, 4, 0.5, (1, 2, 2), (1, 2, 3),
            uniform=True, compiler=comp, step_hook=hook, snapshot=snap, recorder=rec)
        t.read(comp.state_inits, comp.plan_epoch, snap.step, snap.plan_epoch, snap.boundaries,
               [(e["name"], {k: v for k, v in e["args"].items()})
                for e in rec.trace.events if e["ph"] != "X"],
               [(e["name"], e["args"]) for e in rec.trace.events if e["ph"] == "X"],
               [{k: v for k, v in r.items() if k != "wall_s"} for r in rec.measured_runs])
        return t

    port, ref = _both(build)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, i
    assert port[3][0] == 2                 # the second residual run starts without state
    assert all(p <= r for p, r in zip(port.misses, ref.misses)), (port.misses, ref.misses)
    assert port.misses[:2] == [port.misses[0]] * 2          # the re-run misses nothing
    assert port.misses[0] <= 3 * 3 and port.misses[2:] == [2, 2]


# -------------------------------------- scheduled lp_denoise on the DiT
LATENT = (1, 4, 8, 12, 4)
ONE_DIM = (1, 8, 2, 2, 4)


@pytest.fixture(scope="module")
def dit_setup():
    jcfg = jget_config("wan21-dit-1.3b").reduced()
    tcfg = get_config("wan21-dit-1.3b").reduced()
    params = jax.jit(jdit.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = tdit.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    ctx = (rng.normal(size=(1, 16, 128)) * 0.02).astype(np.float32)

    def jfwd(p, zz, t, c, cm):
        return jdit.forward(p, zz, t, c, cm)

    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model, ctx=ctx, jfwd=jfwd,
                rng=rng)


def _within_a_code_step(got, want, bf16_step=False):
    """Within one code step (``test_torch_engine.py``); a step on the bf16
    wire moves a value whose bf16 rounding the DiTs' ~1e-6 difference
    flipped by one bf16 step, up to ``2**-7 |a|``, so with one the 1% rule
    counts the values beyond ``1e-4 + 2**-7 |a|``."""
    a, b = np.asarray(want), got.numpy()
    d = np.abs(b - a)
    assert d.max() <= 1e-4 + np.abs(a).max() / 127, d.max()
    rel = 2.0 ** -7 if bf16_step else 1e-4
    assert (d > 1e-4 + rel * np.abs(a)).mean() <= 0.01


@pytest.mark.parametrize("case", [
    (LATENT, 3, 4, "int8-residual@0.85,int8@0.6,bf16"),          # the smoke's schedule
    (ONE_DIM, 2, 6, "int8-residual@0.8,int8@0.5,int8-residual"),  # residual across segments
    (LATENT, 2, 3, "int8@0.9,fp32"),
], ids=["rotating", "one-dim", "k2"])
def test_scheduled_lp_denoise_matches_reference(dit_setup, case):
    shape, K, steps, spec = case
    s = dit_setup
    z = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jsampler = JFlow(steps)
    jcomp = JCompiler(jguided_step(s["jfwd"], s["params"], s["jcfg"]), jsampler.update, K,
                      0.5, s["jcfg"].patch_sizes, uniform=True, schedule=spec)
    jctx = jnp.asarray(s["ctx"])
    want = jlp_denoise(None, jnp.asarray(z), jsampler, steps, K, 0.5, s["jcfg"].patch_sizes,
                       (1, 2, 3), uniform=True, extras=(jctx, jnp.zeros_like(jctx),
                                                        jnp.float32(5.0)), compiler=jcomp)
    sampler = FlowMatchEuler(steps)
    comp = LPStepCompiler(make_guided_step_denoiser(s["model"]), sampler.update, K, 0.5,
                          s["tcfg"].patch_sizes, uniform=True, schedule=spec)
    ctx = torch.from_numpy(s["ctx"])
    extras = (ctx, torch.zeros_like(ctx), 5.0)
    args = (torch.from_numpy(z), sampler, steps, K, 0.5, s["tcfg"].patch_sizes, (1, 2, 3))
    got = lp_denoise(None, *args, uniform=True, extras=extras, compiler=comp)
    codecs = comp.schedule.step_codecs(tschedule.trajectory_sigmas(sampler, steps))
    _within_a_code_step(got, want, bf16_step="bf16" in codecs)
    assert comp.state_inits == jcomp.state_inits
    n_seg = len(tpolicy.segment_steps(comp.schedule,
                                      tschedule.trajectory_sigmas(sampler, steps)))
    assert comp.compiles <= 3 * n_seg, (comp.compiles, n_seg)

    # a fault after a segment boundary resumes there, bit-equal to the
    # uninterrupted run
    boundary = next(i for i in range(1, steps) if codecs[i] != codecs[i - 1])

    def fail(i):
        if i == boundary + 1:
            raise DeviceFailure(f"injected at step {i}")

    snap = DenoiseSnapshot()
    with pytest.raises(DeviceFailure):
        lp_denoise(None, *args, uniform=True, extras=extras, compiler=comp, step_hook=fail,
                   snapshot=snap)
    assert snap.step == boundary
    resumed = lp_denoise(None, *args, uniform=True, extras=extras, compiler=comp,
                         snapshot=snap)
    assert snap.resumes == 1 and torch.equal(resumed, got)
