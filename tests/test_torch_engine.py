"""The port's serving engine against the JAX engine, on the CPU.

Same reduced DiT weights (``params_from_numpy``), same prompts, and the
port's ``initial_noise`` patched to hand out the JAX engine's noise:
3 requests in 2 (shape, guidance) buckets must come back equal to the
reference within 1e-4 (f32, 3 steps at guidance 5-6).  The coded engine
(``wire_codec``, the halo wire mirror) is held to the coded reference
engine within one code step (``test_torch_lp.py`` gives the reason: the
DiTs' ~1e-6 difference can flip a code at a rounding half-way point).
Plus admission, DeviceFailure retry, the resolved engine name and the
reference's other engine arguments, each served.
"""
import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.models import dit as jdit
from repro.models import frontends as jfrontends
from repro.serving.engine import LPServingEngine as JEngine
from repro.serving.engine import VideoRequest as JRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import dit as tdit
from repro_torch.obs import FlightRecorder, validate_trace
from repro_torch.runtime.faults import ServingFault
from repro_torch.runtime.ft import DeviceFailure
from repro_torch.serving import engine as teng

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = (4, 8, 12)
GUIDANCE = (5.0, 5.0, 6.0)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("wan21-dit-1.3b").reduced()
    params = jmodels.build(jcfg).init(jax.random.PRNGKey(0))
    tcfg = get_config("wan21-dit-1.3b").reduced()
    model = tdit.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    contexts = [np.array(jfrontends.text_context(jax.random.PRNGKey(100 + i), 1, jcfg))
                for i in range(3)]
    return jcfg, params, tcfg, model, contexts


def _port_engine(models, **kw):
    _, _, tcfg, model, _ = models
    args = dict(num_partitions=2, overlap_ratio=0.5, num_steps=3, max_batch=2,
                device="cpu")
    args.update(kw)
    return teng.LPServingEngine(model, tcfg, **args)


def _port_requests(models, n=3):
    contexts = models[4]
    return [teng.VideoRequest(i, torch.from_numpy(contexts[i]), SHAPE, seed=i,
                              guidance=GUIDANCE[i]) for i in range(n)]


def _jax_noise(shape, seed, device):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), shape)))


def _both_engines(models, monkeypatch, **kw):
    """The reference engine and the port's on the same 3 requests (2
    buckets), the port fed the reference's noise."""
    jcfg, params, tcfg, _, contexts = models

    def fwd(p, z, t, c, cfg_model):
        return jdit.forward(p, z, t, c, cfg_model)

    args = dict(num_partitions=2, overlap_ratio=0.5, num_steps=3, max_batch=2)
    args.update(kw)
    jeng = JEngine(fwd, params, jcfg, **args)
    for i in range(3):
        jeng.submit(JRequest(i, jax.numpy.asarray(contexts[i]), SHAPE, seed=i,
                             guidance=GUIDANCE[i]))
    jres = {r.request_id: r for r in jeng.run()}

    monkeypatch.setattr(teng, "initial_noise", _jax_noise)
    eng = _port_engine(models, **kw)
    assert eng.lp_impl == jeng.lp_impl
    for r in _port_requests(models):
        eng.submit(r)
    tres = {r.request_id: r for r in eng.run()}
    assert sorted(tres) == sorted(jres) == [0, 1, 2]
    for i in range(3):
        assert tres[i].batch_size == jres[i].batch_size == (2 if i < 2 else 1)
        assert tuple(tres[i].latent.shape) == (1, *SHAPE, tcfg.latent_channels)
    return eng, jeng, tres, jres


def test_engine_matches_reference_engine(models, monkeypatch):
    eng, _, tres, jres = _both_engines(models, monkeypatch)
    for i in range(3):
        np.testing.assert_allclose(tres[i].latent.numpy(), np.asarray(jres[i].latent), **TOL)
    assert eng._compiler.compiles == 6     # 3 dims x 2 batch geometries (sizes 2 and 1)


@pytest.mark.parametrize("codec", ["int8", "int8-residual"])
def test_coded_engine_matches_reference_engine(models, monkeypatch, codec):
    eng, jeng, tres, jres = _both_engines(models, monkeypatch, num_partitions=3,
                                          wire_codec=codec)
    assert eng.lp_impl == "halo" and eng.codec.name == jeng.codec.name == codec
    assert eng._compiler.codec.name == codec and eng._compiler.nan_guard
    for i in range(3):
        a, b = np.asarray(jres[i].latent), tres[i].latent.numpy()
        d = np.abs(b - a)
        assert d.max() <= 1e-4 + np.abs(a).max() / 127, d.max()
        assert (d > TOL["atol"] + TOL["rtol"] * np.abs(a)).mean() <= 0.01
    assert eng._compiler.state_inits == jeng._compiler.state_inits


def test_queue_full_and_admission(models):
    eng = _port_engine(models, max_queue=2)
    reqs = _port_requests(models)
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    with pytest.raises(teng.QueueFull) as exc:
        eng.submit(reqs[2])
    assert exc.value.request_id == 2 and exc.value.depth == 2
    assert [r.request_id for r in eng._next_batch()] == [0, 1]     # a full bucket
    with pytest.raises(ValueError, match="max_queue"):
        _port_engine(models, max_queue=1)


def test_device_failure_retries_from_snapshot(models):
    clean = _port_engine(models)
    clean.submit(_port_requests(models, 1)[0])
    want = clean.run()[0].latent

    eng = _port_engine(models)
    eng.submit(_port_requests(models, 1)[0])
    fired = []

    def fault(step):
        if step == 3 and not fired:
            fired.append(step)
            raise DeviceFailure("injected device loss")

    eng._step_fault = fault
    res = eng.run()[0]
    assert res.restarts == 1 and res.resumed_from_step == 2
    assert torch.equal(res.latent, want)

    eng = _port_engine(models)
    eng.submit(_port_requests(models, 1)[0])

    def bug(step):
        raise RuntimeError("not a device failure")

    eng._step_fault = bug
    with pytest.raises(RuntimeError, match="not a device failure"):
        eng.run()


@pytest.mark.parametrize("K", [2, 3, 4])
def test_lp_impl_name_matches_reference(models, K):
    jcfg, params, _, _, _ = models
    jeng = JEngine(lambda *a: None, params, jcfg, num_partitions=K)
    assert _port_engine(models, num_partitions=K).lp_impl == jeng.lp_impl


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(wire_codec="int8"),
                                dict(codec_schedule="auto"), dict(psnr_floor=40.0),
                                dict(elastic=True), dict(inject_fault="dead:1@2"),
                                dict(recorder=FlightRecorder()), dict(slo="interactive:20"),
                                dict(lp_impl="halo")])
def test_unported_engine_arguments_raise(models, kw):
    """The engine's arguments of the reference, each served as the
    reference serves it (the step policy and the flight recorder since
    their port; ``replica_id`` and ``clock=``, the fleet layer's, are held
    to the reference in ``test_torch_loadgen.py``).
    ``wire_codec=`` and ``lp_impl="halo"`` run the halo wire mirror,
    ``codec_schedule="auto"`` the autotuned schedule through it
    (``test_torch_obs.py`` holds it to the reference), ``psnr_floor``
    alone raises as the reference does, ``recorder=`` records the request
    (a trace that validates), ``slo=`` stamps its deadline, ``elastic=``
    has nothing to evict, ``inject_fault=`` (a dead group at K = 2, the
    floor, cannot be evicted: the restarts run out, as in the reference,
    ``tests/test_fault_recovery.py``; the drills: ``test_torch_faults.py``)
    and ``mesh=`` (anything but a group is refused; groups:
    ``test_torch_dist.py``, ``test_torch_hybrid.py``)."""
    if "mesh" in kw:
        with pytest.raises(ValueError, match="LPGroup or a HybridGroup"):
            _port_engine(models, **kw)
        return
    if "inject_fault" in kw:
        eng = _port_engine(models, num_steps=2, **kw)
        eng.submit(_port_requests(models, 1)[0])
        with pytest.raises(ServingFault, match="stopped heartbeating"):
            eng.run()
        assert eng.evictions == 0 and eng._lifecycle == {}
        return
    if "psnr_floor" in kw:
        with pytest.raises(ValueError, match="psnr_floor needs codec_schedule"):
            _port_engine(models, **kw)
        return
    eng = _port_engine(models, num_steps=2, **kw)
    assert (eng.lp_impl == "halo" and (eng._compiler.codec is not None
                                       or eng._compiler.schedule is not None)) \
        or eng.elastic or eng.recorder is not None or eng.slo is not None
    eng.submit(_port_requests(models, 1)[0])
    res = eng.run()[0]
    assert tuple(res.latent.shape) == (1, *SHAPE, 4) and bool(torch.isfinite(res.latent).all())
    assert eng.evictions == 0 and res.restarts == 0
    if "recorder" in kw:
        rec = kw["recorder"]
        assert validate_trace(rec.trace.to_json()) == [] and len(rec.wire_steps) == 2
        assert rec.request_rows[0]["request_id"] == 0
    if "slo" in kw:
        assert eng.slo.deadline_for("interactive") == 20.0


@pytest.mark.parametrize("kw,match", [
    (dict(wire_codec="int8", lp_impl="shard_map"), "needs the halo family"),
    (dict(wire_codec="displaced", lp_impl="gspmd"), "displaced halo codec"),
    (dict(wire_codec="int8", uniform=False), "uniform-window"),
    (dict(wire_codec="int3"), "unknown wire codec"),
])
def test_coded_engine_refuses_what_the_reference_refuses(models, kw, match):
    with pytest.raises(ValueError, match=match):
        _port_engine(models, **kw)


def test_serve_cli_on_cpu(capsys, monkeypatch):
    # the CLI serves the full width; the CPU test serves the reduced config
    monkeypatch.setattr(serve, "get_config", lambda name: get_config(name).reduced())
    serve.main(["--device", "cpu", "--requests", "2", "--steps", "2",
                "--frames-latent", "4"])
    out = capsys.readouterr().out
    assert "engine: lp_impl=shard_map codec=fp32" in out
    assert "request 0: latent (1, 4, 8, 12, 4)" in out and "request 1:" in out
    serve.main(["--device", "cpu", "--requests", "1", "--steps", "2", "--frames-latent", "4",
                "--partitions", "3", "--wire-codec", "int8-residual", "--no-wire-nan-guard"])
    out = capsys.readouterr().out
    assert "engine: lp_impl=halo codec=int8-residual" in out
    assert "request 0: latent (1, 4, 8, 12, 4)" in out
