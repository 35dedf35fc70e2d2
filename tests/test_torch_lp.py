"""The port's LP slice end to end against the JAX reference, on the CPU.

``generate_lp`` / ``lp_denoise`` with the reduced WAN DiT (f32, weights
carried over by ``params_from_numpy``) and the same ``z_T``: K 2-4,
uniform windows and paper-exact partitions.  Stated tolerance 1e-4 on
latents of magnitude ~3 (f32 DiT, guidance 5 amplifies the cond/uncond
difference).  Plus the step cache's miss bound and a bit-exact resume
from a boundary snapshot.

Coded steps (``codec=``, the halo wire mirror) are held to the reference
within one code step: the two frameworks' DiTs differ by ~1e-6, and when
a value's ``x / scale`` lies that close to a rounding half-way point its
code flips by one, which moves the output by at most one step of its
message's scale, ``<= max|latent| / qmax``.  So every element must be
within ``1e-4 + max|ref| / qmax`` and at most 1% of them beyond the
plain 1e-4 tolerance; ``state_inits`` must equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import LPStepCompiler as JLPStepCompiler
from repro.core import lp_denoise as jlp_denoise
from repro.diffusion import generate_lp as jgenerate_lp
from repro.diffusion import make_guided_denoiser as jguided
from repro.diffusion.pipeline import make_guided_step_denoiser as jguided_step
from repro.diffusion.sampler import FlowMatchEuler as JFlowMatchEuler
from repro.models import dit as jdit
from repro_torch.configs import get_config
from repro_torch.core import DenoiseSnapshot, LPStepCompiler, lp_denoise, lp_forward_uniform
from repro_torch.diffusion import FlowMatchEuler, generate_lp, make_guided_denoiser
from repro_torch.diffusion.pipeline import make_guided_step_denoiser
from repro_torch.models import dit as tdit
from repro_torch.obs import FlightRecorder, validate_trace
from repro_torch.runtime.ft import DeviceFailure

TOL = dict(rtol=1e-4, atol=1e-4)
LATENT = (1, 4, 8, 12, 4)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("wan21-dit-1.3b").reduced()
    tcfg = get_config("wan21-dit-1.3b").reduced()
    params = jdit.init_params(jax.random.PRNGKey(0), jcfg)
    model = tdit.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    ctx = (rng.normal(size=(1, 16, 128)) * 0.02).astype(np.float32)
    z = rng.normal(size=LATENT).astype(np.float32)

    def jfwd(p, zz, t, c, cm):
        return jdit.forward(p, zz, t, c, cm)

    jden = jguided(jfwd, params, jcfg, jnp.asarray(ctx), jnp.zeros_like(jnp.asarray(ctx)), 5.0)
    tctx = torch.from_numpy(ctx)
    tden = make_guided_denoiser(model, tctx, torch.zeros_like(tctx), 5.0)
    return dict(jcfg=jcfg, tcfg=tcfg, model=model, jden=jden, tden=tden, z=z, ctx=tctx,
                params=params, jfwd=jfwd, np_ctx=ctx)


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("K", [2, 3, 4])
def test_generate_lp_matches_reference(setup, K, uniform):
    s = setup
    a = np.asarray(jgenerate_lp(s["jden"], jnp.asarray(s["z"]), 2, K, 0.5,
                                s["jcfg"].patch_sizes, uniform=uniform))
    b = generate_lp(s["tden"], torch.from_numpy(s["z"]), 2, K, 0.5, s["tcfg"].patch_sizes,
                    uniform=uniform)
    assert b.shape == s["z"].shape and bool(torch.isfinite(b).all())
    np.testing.assert_allclose(b.numpy(), a, **TOL)
    # the step-cached loop and the eager reference loop do the same arithmetic
    c = generate_lp(s["tden"], torch.from_numpy(s["z"]), 2, K, 0.5, s["tcfg"].patch_sizes,
                    uniform=uniform, compiled=False)
    assert torch.equal(b, c)


def _step_setup(s, K=3):
    sampler = FlowMatchEuler(6)
    guided = make_guided_step_denoiser(s["model"])
    comp = LPStepCompiler(guided, sampler.update, K, 0.5, s["tcfg"].patch_sizes,
                          uniform=True)
    extras = (s["ctx"], torch.zeros_like(s["ctx"]), 5.0)
    return sampler, comp, extras


def test_step_cache_misses_at_most_once_per_dim(setup):
    sampler, comp, extras = _step_setup(setup)
    z = torch.from_numpy(setup["z"])
    args = (z, sampler, 6, 3, 0.5, setup["tcfg"].patch_sizes, (1, 2, 3))
    first = lp_denoise(None, *args, uniform=True, extras=extras, compiler=comp)
    assert comp.compiles == 3 and comp.hits == 3          # dims T H W T H W
    second = lp_denoise(None, *args, uniform=True, extras=extras, compiler=comp)
    assert comp.compiles == 3 and comp.hits == 9
    assert torch.equal(first, second)


def test_snapshot_resume_is_bit_exact(setup):
    sampler, comp, extras = _step_setup(setup)
    z = torch.from_numpy(setup["z"])
    args = (z, sampler, 6, 3, 0.5, setup["tcfg"].patch_sizes, (1, 2, 3))
    clean = lp_denoise(None, *args, uniform=True, extras=extras, compiler=comp)

    def fail_at_5(i):
        if i == 5:
            raise DeviceFailure("injected at step 5")

    snap = DenoiseSnapshot()
    with pytest.raises(DeviceFailure):
        lp_denoise(None, *args, uniform=True, extras=extras, compiler=comp,
                   step_hook=fail_at_5, snapshot=snap)
    assert snap.step == 4 and snap.boundaries == 4 and snap.z.device.type == "cpu"
    resumed = lp_denoise(None, *args, uniform=True, extras=extras, compiler=comp,
                         snapshot=snap)
    assert snap.resumes == 1
    assert torch.equal(resumed, clean)


def test_unported_arguments_name_their_roadmap_item(setup):
    """Every argument of the reference's step cache and loop is served
    now: ``schedule=`` and ``recorder=`` (since the step policy and the
    flight recorder were ported: ``test_torch_policy.py`` and
    ``test_torch_obs.py`` hold them to the reference), ``forward_factory``
    (a schedule's group-bound hooks), ``codec=``, ``forward=``, a
    ``mesh_shape`` (with a tp axis too) and ``wire_shard``; their cases
    check that they run and key the step cache.  ``schedule="auto"`` is
    refused as the reference refuses it (a compiler takes a spec, the
    engine resolves ``auto``)."""
    sampler, comp, extras = _step_setup(setup)
    z = torch.from_numpy(setup["z"])
    guided = make_guided_step_denoiser(setup["model"])
    rec = FlightRecorder()
    for kw in (dict(schedule="int8@0.95,bf16"), dict(recorder=rec)):
        out = lp_denoise(guided, z, sampler, 2, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True,
                         extras=extras, **kw)
        assert out.shape == z.shape and bool(torch.isfinite(out).all())
    assert [(r["start"], r["stop"]) for r in rec.measured_runs] == [(1, 1), (2, 2)]
    assert validate_trace(rec.trace.to_json()) == []
    coded = lp_denoise(guided, z, sampler, 2, 2, 0.5, (1, 2, 2), (1, 2, 3), uniform=True,
                       codec="int8", extras=extras)
    assert coded.shape == z.shape and bool(torch.isfinite(coded).all())

    def factory(codec):
        return lambda fn, zz, plan, axis: lp_forward_uniform(fn, zz, plan, axis)

    hooked = LPStepCompiler(guided, sampler.update, 2, 0.5, (1, 2, 2), uniform=True,
                            schedule="int8@0.95,bf16", forward_factory=factory)
    assert hooked.forward_factory is factory
    out = lp_denoise(None, z, sampler, 2, 2, 0.5, (1, 2, 2), (1, 2, 3), compiler=hooked,
                     extras=extras)
    assert torch.equal(out, lp_denoise(guided, z, sampler, 2, 2, 0.5, (1, 2, 2), (1, 2, 3),
                                       uniform=True, extras=extras))
    with pytest.raises(ValueError, match="unknown wire codec 'auto'"):
        LPStepCompiler(None, sampler.update, 2, 0.5, (1, 2, 2), schedule="auto")
    # a forward hook on a (K, 1) mesh is served: the step runs through it
    # (the lp-group engines behind it: tests/test_torch_dist.py)
    calls = []

    def hook(fn, z, plan, axis):
        calls.append(plan.dim)
        return lp_forward_uniform(fn, z, plan, axis)

    hooked = LPStepCompiler(make_guided_step_denoiser(setup["model"]), sampler.update, 2, 0.5,
                            (1, 2, 2), uniform=True, forward=hook, mesh_shape=(2, 1))
    plain = LPStepCompiler(make_guided_step_denoiser(setup["model"]), sampler.update, 2, 0.5,
                           (1, 2, 2), uniform=True)
    outs = [lp_denoise(None, z, sampler, 2, 2, 0.5, (1, 2, 2), (1, 2, 3), compiler=c,
                       extras=extras) for c in (hooked, plain)]
    assert len(calls) == 2 and torch.equal(outs[0], outs[1])
    assert hooked.compiles == plain.compiles and hooked.mesh_shape == (2, 1)
    # a (2, 2) mesh and a sharded wire are served too (tests/test_torch_hybrid.py);
    # both are part of the step-cache key
    tp_mesh = LPStepCompiler(make_guided_step_denoiser(setup["model"]), sampler.update, 2,
                             0.5, (1, 2, 2), uniform=True, forward=hook, mesh_shape=(2, 2),
                             wire_shard=True)
    out = lp_denoise(None, z, sampler, 2, 2, 0.5, (1, 2, 2), (1, 2, 3), compiler=tp_mesh,
                     extras=extras)
    assert torch.equal(out, outs[1]) and len(calls) == 4
    assert {k[-2:] for k in tp_mesh._cache} == {((2, 2), True)}
    bf16 = LPStepCompiler(None, sampler.update, 2, 0.5, (1, 2, 2), uniform=True,
                          codec="bf16")
    assert bf16.codec.name == "bf16" and not bf16.stateful
    with pytest.raises(ValueError, match="uniform-window"):
        LPStepCompiler(None, sampler.update, 2, 0.5, (1, 2, 2), codec="bf16")


CODED_CASES = [
    # codec, K, latent: (1, 6, 4, 4, 4) has one usable dim (T), so the 3 steps
    # are one run and residual state is threaded across them; (1, 4, 8, 12, 4)
    # rotates dims every step, so state is re-created 3 times
    ("int8", 3, (1, 6, 4, 4, 4)),
    ("int8", 4, (1, 6, 4, 4, 4)),
    ("int4-residual", 3, (1, 6, 4, 4, 4)),
    ("int4-residual", 4, (1, 6, 4, 4, 4)),
    ("displaced:int8-residual", 3, (1, 6, 4, 4, 4)),
    ("displaced:int8-residual", 4, (1, 6, 4, 4, 4)),
    ("int4-residual", 3, LATENT),
    ("displaced:int8-residual", 4, LATENT),
]


@pytest.mark.parametrize("name,K,shape", CODED_CASES)
def test_coded_lp_denoise_matches_reference(setup, name, K, shape):
    s = setup
    z = np.random.default_rng(K).normal(size=shape).astype(np.float32)
    ctx = s["np_ctx"]
    jsampler = JFlowMatchEuler(3)
    jcomp = JLPStepCompiler(jguided_step(s["jfwd"], s["params"], s["jcfg"]), jsampler.update,
                            K, 0.5, s["jcfg"].patch_sizes, uniform=True, codec=name)
    a = np.asarray(jlp_denoise(None, jnp.asarray(z), jsampler, 3, K, 0.5,
                               s["jcfg"].patch_sizes, (1, 2, 3), uniform=True,
                               extras=(jnp.asarray(ctx), jnp.zeros_like(jnp.asarray(ctx)), 5.0),
                               compiler=jcomp))
    sampler = FlowMatchEuler(3)
    comp = LPStepCompiler(make_guided_step_denoiser(s["model"]), sampler.update, K, 0.5,
                          s["tcfg"].patch_sizes, uniform=True, codec=name)
    b = lp_denoise(None, torch.from_numpy(z), sampler, 3, K, 0.5, s["tcfg"].patch_sizes,
                   (1, 2, 3), uniform=True, extras=(s["ctx"], torch.zeros_like(s["ctx"]), 5.0),
                   compiler=comp).numpy()
    assert comp.state_inits == jcomp.state_inits == (0 if name == "int8" else
                                                       1 if shape[1] == 6 else 3)
    assert comp.compiles == jcomp.compiles
    qmax = 7 if "int4" in name else 127
    d = np.abs(b - a)
    assert d.max() <= 1e-4 + np.abs(a).max() / qmax, d.max()
    assert (d > TOL["atol"] + TOL["rtol"] * np.abs(a)).mean() <= 0.01
