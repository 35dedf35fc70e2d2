"""LP across ranks: the port's psum and halo engines on gloo worlds, on the CPU.

Each world is a few spawned processes (``launch/mesh.run_lp_world``,
``file://`` rendezvous under ``tmp_path``, a deadline on the world and a
timeout on every group), one per K, running many cases from
``torch_dist_cases.py`` (which imports no JAX).  Inputs are made from
numpy seeds; the denoiser ``0.5 x + 0.25`` is elementwise, so a window
gives the same values alone or stacked and no DiT rounding enters.

* The halo engine at K = 3 and 4, uncoded and through every codec of
  ``CODEC_NAMES``, with and without ``eager_sends`` and ``nan_guard``,
  and with one NaN in the latent (so one message decodes to NaN): every
  rank's output equals the port's ``simulate_halo_forward`` bit for bit
  (NaNs in the same places; -0 and +0 compare equal), over steps that
  rotate dims and steps that thread residual state; each rank's state
  equals its row of the mirror's state, bit for bit.
* The psum engine at K = 2 equals ``lp_forward_uniform`` bit for bit.
* The byte counter: per step and rank, the payload of each collective
  kind equals ``lp_halo_step_collectives`` / ``lp_halo_codec_step_collectives``
  (the psum's all-reduce: the latent's bytes); summed over the ranks and
  the steps, the halo's sent bytes equal ``comm_lp_halo`` /
  ``comm_lp_halo_codec`` of the port's ``comm_model``, exactly.  The
  psum sends its buffer to the transport; the all-reduce's wire bytes
  are modelled (``collective_wire_bytes``), and from the counted
  payloads the model gives ``comm_lp_spmd``.
* ``LPServingEngine(mesh=...)`` on the reduced WAN DiT in f32 (psum at
  K = 2; halo at K = 3 uncoded, ``int8`` and ``int8-residual``) equals
  the one-process engine within ``test_torch_engine.py``'s tolerances
  (the ranks run the DiT window by window, the one-process engine on the
  stack), with at most 3 step-cache misses a denoise and the bytes of
  the model; ``serve --mesh 3 --device cpu`` runs in a world.
* A rank that raises fails its world at once; a wire sharded over the lp
  group itself and a group of the wrong size raise (the tp axis and the
  sharded wire: ``test_torch_hybrid.py``).
"""
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro_torch.comm.codecs import CODEC_NAMES
from repro_torch.comm.wire import put_rank_wire_state, rank_wire_state
from repro_torch.configs import get_config
from repro_torch.core import comm_model as cm
from repro_torch.core import lp_forward_uniform, plan_uniform
from repro_torch.core.spmd import lp_forward_halo
from repro_torch.device import generator
from repro_torch.distributed.collectives import KINDS, LPGroup
from repro_torch.launch import mesh as tmesh
from repro_torch.models import dit
from repro_torch.serving import engine as teng

ROTATING = (1, 9, 6, 10, 4)         # T, H and W usable at K 3 and 4: the dims rotate
ONE_DIM = (1, 9, 4, 4, 4)           # only T usable: 3 steps thread the residual state
R = 0.5
WIRES = (None,) + CODEC_NAMES
NAN_WIRES = (None, "int8", "int8-residual", "displaced:int8-residual")
DEADLINE_S = 300


def _halo_cases():
    out = []
    for i, codec in enumerate(WIRES):
        out.append(dict(codec=codec, shape=ROTATING, seed=i, steps=4, eager=False, guard=False))
        out.append(dict(codec=codec, shape=ONE_DIM, seed=20 + i, steps=3, eager=True,
                        guard=True))
    for i, codec in enumerate(NAN_WIRES):
        out.append(dict(codec=codec, shape=ONE_DIM, seed=40 + i, steps=3, eager=bool(i % 2),
                        guard=True, nan_at=(0, 4, 1, 2, 3)))
    for c in out:
        c["r"] = R
    return out


HALO_CASES = _halo_cases()


def _case_id(c):
    return f"{c['codec']}-{c['shape'][2]}{'-eager' if c['eager'] else ''}" \
           f"{'-guard' if c['guard'] else ''}{'-nan' if 'nan_at' in c else ''}"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("lp_worlds")


@pytest.fixture(scope="module")
def halo_worlds(workdir):
    """One world per K, every halo case inside it."""
    return {K: tmesh.run_lp_world(cases.halo_cases, K, (HALO_CASES,), workdir=str(workdir),
                                  device="cpu", deadline_s=DEADLINE_S)
            for K in (3, 4)}


def _comm_cfg(shape, steps):
    return cm.VDMCommConfig(latent_dims=tuple(shape[1:4]), latent_channels=shape[4],
                            patch_sizes=cases.PATCH, d_model=1, num_blocks=1,
                            num_steps=steps, bytes_per_el=4)


@pytest.mark.parametrize("K", [3, 4])
@pytest.mark.parametrize("ci", range(len(HALO_CASES)),
                         ids=[_case_id(c) for c in HALO_CASES])
def test_halo_engine_equals_the_mirror(halo_worlds, K, ci):
    case = HALO_CASES[ci]
    ranks = [res[ci] for res in halo_worlds[K]]
    outs, states, dims = cases.mirror_run(case, K)
    for r, got in enumerate(ranks):
        for i, want in enumerate(outs):
            assert cases.same(got["outs"][i], want), (r, i)
        for i, want in enumerate(states):          # rank r's state is row r of the mirror's
            mine = dict(cases.flat_state(got["states"][i]))
            for path, leaf in cases.flat_state(rank_wire_state(want, r)):
                assert cases.same(mine[path], leaf), (r, i, path)
    if states:                                     # and the helpers invert each other
        back = put_rank_wire_state(states[-1], 1, ranks[1]["states"][-1])
        assert all(cases.same(a, b) for (_, a), (_, b) in zip(cases.flat_state(back),
                                                              cases.flat_state(states[-1])))


@pytest.mark.parametrize("K", [3, 4])
@pytest.mark.parametrize("ci", [i for i, c in enumerate(HALO_CASES) if "nan_at" not in c],
                         ids=[_case_id(c) for c in HALO_CASES if "nan_at" not in c])
def test_halo_bytes_equal_the_comm_model(halo_worlds, K, ci):
    case = HALO_CASES[ci]
    ranks = [res[ci] for res in halo_worlds[K]]
    cfg = _comm_cfg(case["shape"], case["steps"])
    _, _, dims = cases.mirror_run(case, K)
    prev = [dict.fromkeys(KINDS, 0) for _ in ranks]
    for i, d in enumerate(dims):
        if case["codec"] is None:
            want = cm.lp_halo_step_collectives(cfg, K, R, d)
        else:
            want = cm.lp_halo_codec_step_collectives(cfg, K, R, d, codec=case["codec"])
        for r, got in enumerate(ranks):
            step = {k: got["counts"][i]["payload"][k] - prev[r][k] for k in prev[r]}
            assert step == {"all-gather": want["all-gather"], "all-reduce": 0,
                            "collective-permute": want["collective-permute"]}, (r, i)
            prev[r] = got["counts"][i]["payload"]
    total = sum(got["counts"][-1]["sent"] for got in ranks)
    if case["codec"] is None:
        assert total == cm.comm_lp_halo(cfg, K, R)
    else:
        assert total == cm.comm_lp_halo_codec(cfg, K, R, codec=case["codec"])


PSUM_CASES = [dict(shape=ROTATING, seed=60, steps=4, r=R),
              dict(shape=(2, 7, 8, 6, 3), seed=61, steps=3, r=1.0)]


@pytest.fixture(scope="module")
def psum_world(workdir):
    return tmesh.run_lp_world(cases.psum_cases, 2, (PSUM_CASES,), workdir=str(workdir),
                              device="cpu", deadline_s=DEADLINE_S)


@pytest.mark.parametrize("ci", range(len(PSUM_CASES)))
def test_psum_engine_equals_uniform_and_comm_model(psum_world, ci):
    case = PSUM_CASES[ci]
    z = cases.case_latent(case["shape"], case["seed"])
    plans = list(cases.step_plans(z, 2, case["r"], case["steps"]))
    for i, (_, d, plan) in enumerate(plans):
        z = lp_forward_uniform(cases.exact_denoiser, z, plan, 1 + d)
        for got in psum_world:
            assert torch.equal(got[ci]["outs"][i], z), i
            assert got[ci]["counts"][i]["payload"]["all-reduce"] == (i + 1) * z.numel() * 4
    cfg = _comm_cfg(case["shape"], case["steps"])
    batch = case["shape"][0]
    # a rank sends its buffer to the transport (the HLO payload); what the
    # all-reduce puts on the wire is the byte model's ring, the buffer at K = 2
    payloads = [got[ci]["counts"][-1]["payload"]["all-reduce"] for got in psum_world]
    assert [got[ci]["counts"][-1]["sent"] for got in psum_world] == payloads
    assert sum(cm.collective_wire_bytes("all-reduce", p, 2) for p in payloads) == \
        batch * cm.comm_lp_spmd(cfg, 2, case["r"])
    assert all(got[ci]["counts"][-1]["calls"] == {"all-gather": 0, "all-reduce": case["steps"],
                                                   "collective-permute": 0}
               for got in psum_world)


# ---------------------------------------------------------------- engine
SHAPE = (4, 8, 12)
STEPS = 3
ENGINE_RUNS = {2: [None], 3: [None, "int8", "int8-residual"]}


def _contexts(cfg, n=2):
    rng = np.random.default_rng(7)
    return [(0.02 * rng.normal(size=(1, cfg.context_len, cfg.context_dim))).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def engine_worlds(workdir):
    cfg = get_config("wan21-dit-1.3b").reduced()
    reqs = [(0, _contexts(cfg)[0], SHAPE, 0)]
    return {K: tmesh.run_lp_world(cases.engine_runs, K, (ENGINE_RUNS[K], reqs, STEPS),
                                  workdir=str(workdir), device="cpu", deadline_s=DEADLINE_S)
            for K in ENGINE_RUNS}


@pytest.fixture(scope="module")
def one_process():
    cfg = get_config("wan21-dit-1.3b").reduced()
    model = dit.init_params(cfg, generator(0, "cpu"), "cpu")
    out = {}
    for K, codecs in ENGINE_RUNS.items():
        for codec in codecs:
            eng = teng.LPServingEngine(model, cfg, num_partitions=K, num_steps=STEPS,
                                       device="cpu", wire_codec=codec)
            eng.submit(teng.VideoRequest(0, torch.from_numpy(_contexts(cfg)[0]), SHAPE,
                                         seed=0))
            out[(K, codec)] = eng.run()[0].latent
    return cfg, out


@pytest.mark.parametrize("K,ri", [(K, i) for K in ENGINE_RUNS for i in range(len(ENGINE_RUNS[K]))])
def test_engine_on_a_group_matches_one_process(engine_worlds, one_process, K, ri):
    cfg, ref = one_process
    codec = ENGINE_RUNS[K][ri]
    want = ref[(K, codec)].numpy()
    latents = [w[ri]["latents"][0] for w in engine_worlds[K]]
    for lat in latents[1:]:
        assert torch.equal(lat, latents[0])        # every rank holds the same latent
    got = latents[0].numpy()
    d = np.abs(got - want)
    if codec is None:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:                          # within one code step, as test_torch_engine holds the wire
        assert d.max() <= 1e-4 + np.abs(want).max() / 127, d.max()
        assert (d > 1e-4 + 1e-4 * np.abs(want)).mean() <= 0.01
    rank0 = engine_worlds[K][0][ri]
    assert rank0["lp_impl"] == ("shard_map" if K == 2 else "halo")
    assert rank0["compiles"] <= 3 and rank0["eager_sends"] is False
    ccfg = _comm_cfg((1, *SHAPE, cfg.latent_channels), STEPS)
    sent = sum(w[ri]["counts"]["sent"] for w in engine_worlds[K])
    if K == 2:                     # the buffers handed over; the ring's bytes modelled
        payload = sum(w[ri]["counts"]["payload"]["all-reduce"] for w in engine_worlds[K])
        assert sent == payload
        assert cm.collective_wire_bytes("all-reduce", payload, K) == \
            cm.comm_lp_spmd(ccfg, K, 0.5)
    else:                          # the engine's halo wire is a codec, fp32 when uncoded
        assert sent == cm.comm_lp_halo_codec(ccfg, K, 0.5, codec=codec or "fp32")
        if codec is None:
            assert sent == cm.comm_lp_halo(ccfg, K, 0.5)


def test_serve_cli_with_a_mesh_in_a_world(workdir):
    argv = ["--device", "cpu", "--mesh", "3", "--partitions", "3", "--requests", "1",
            "--steps", "2", "--frames-latent", "4", "--wire-codec", "int8", "--eager-sends"]
    outs = tmesh.run_lp_world(cases.serve_cli, 3, (argv,), workdir=str(workdir),
                              device="cpu", deadline_s=DEADLINE_S)
    assert "engine: lp_impl=halo codec=int8" in outs[0] and "ranks=3 backend=gloo" in outs[0]
    assert "eager_sends=True" in outs[0]
    assert "request 0: latent (1, 4, 8, 12, 4)" in outs[0]
    assert outs[1] == outs[2] == ""                # only rank 0 prints


def test_a_failing_rank_fails_its_world(workdir):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmesh.run_lp_world(cases.fail_on_rank, 3, (1,), workdir=str(workdir), device="cpu",
                           deadline_s=120)


def test_what_is_not_served_raises():
    assert tmesh.parse_mesh("4") == (4, 1) and tmesh.parse_mesh("3x2") == (3, 2)
    for bad in ("1", "4x0", "2x2x2", "a"):
        with pytest.raises(ValueError):
            tmesh.parse_mesh(bad)
    with pytest.raises(ValueError, match="lp, tp >= 1"):     # a tp axis is served (hybrid tests)
        tmesh.make_lp_group(4, 0, device="cpu")
    if not torch.cuda.is_available():          # a world runs on the card unless asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.run_lp_world(cases.fail_on_rank, 2, (1,), workdir="unused")
    cfg = get_config("wan21-dit-1.3b").reduced()
    group = LPGroup(rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="3 ranks"):
        teng.LPServingEngine(lambda *a: None, cfg, num_partitions=2, device="cpu", mesh=group)
    z = torch.zeros((1, 9, 4, 4, 4))
    plan = plan_uniform(9, 1, 4, R, 0)
    with pytest.raises(ValueError, match="3 ranks"):
        lp_forward_halo(cases.exact_denoiser, z, plan, 1, group)
    with pytest.raises(ValueError, match="must differ from the lp axis"):
        lp_forward_halo(cases.exact_denoiser, z, plan, 1, group, shard_axis=group)


# ------------------------------------------------- against the JAX package
REFERENCE_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.core import plan_uniform
from repro.core.spmd import lp_forward_halo, lp_forward_shard_map
from repro.launch.mesh import make_hybrid_mesh

out = {}
for name, impl, K, codec, shape, seed, r, dim, patch in json.loads(sys.argv[2]):
    z = jnp.asarray(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    plan = plan_uniform(shape[1 + dim], patch, K, r, dim)
    mesh = make_hybrid_mesh(K, 1)
    fn = lambda x: 0.5 * x + 0.25
    with compat.set_mesh(mesh):
        if impl == "halo":
            step = jax.jit(lambda zz: lp_forward_halo(fn, zz, plan, 1 + dim, mesh, "data",
                                                      codec=codec))
        else:
            step = jax.jit(lambda zz: lp_forward_shard_map(fn, zz, plan, 1 + dim, mesh, "data"))
        out[name] = np.asarray(step(z))
np.savez(sys.argv[1], **out)
"""


def test_first_step_equals_the_jax_package(halo_worlds, psum_world, tmp_path):
    """The reference's ``lp_forward_halo`` (uncoded and ``int8``, K = 3 and
    4) and ``lp_forward_shard_map`` (K = 2), run with 4 fake XLA devices
    in a subprocess on the same numpy-seeded latents and the same
    denoiser, against the first step of the port's gloo worlds.  The halo
    engines are bit-equal (0.5 x is exact, so a fused multiply-add gives
    the same bits).  The psum engine is within one ulp: XLA multiplies by
    the reciprocal of the constant normalizer where the port divides
    (shown exactly on the port's own numerator)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    runs, got = [], {}
    for K in (3, 4):
        for ci, c in enumerate(HALO_CASES):
            if c["shape"] == ROTATING and c["codec"] in (None, "int8"):
                z = cases.case_latent(c["shape"], c["seed"])
                _, d, plan = next(cases.step_plans(z, K, R, 1))
                name = f"halo{K}_{c['codec']}"
                runs.append((name, "halo", K, c["codec"], list(c["shape"]), c["seed"], R, d,
                             cases.PATCH[d]))
                got[name] = [w[ci]["outs"][0] for w in halo_worlds[K]]
    c = PSUM_CASES[0]
    _, d, plan = next(cases.step_plans(cases.case_latent(c["shape"], c["seed"]), 2, c["r"], 1))
    runs.append(("psum2", "psum", 2, None, list(c["shape"]), c["seed"], c["r"], d,
                 cases.PATCH[d]))
    got["psum2"] = [w[0]["outs"][0] for w in psum_world]
    out = tmp_path / "reference.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT, str(out), json.dumps(runs)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(out)
    assert sorted(want.files) == sorted(got)
    for name, outs in got.items():
        for r, o in enumerate(outs):
            if name != "psum2":
                assert np.array_equal(o.numpy(), want[name]), (name, r)
                continue
            # XLA rewrites the psum's division by the constant normalizer
            # as a product with its reciprocal: one ulp at most, and the
            # reference is exactly that product of the port's numerator
            ulp = np.spacing(np.abs(want[name]))
            assert (np.abs(o.numpy() - want[name]) <= ulp).all(), (name, r)
    num, norm = _psum_numerator(PSUM_CASES[0])
    assert np.array_equal((num * (1.0 / norm)).numpy(), want["psum2"])
    assert torch.equal(num / norm, got["psum2"][0])


def _psum_numerator(case):
    """The psum's first step before the normalizer: the weighted windows
    summed into the global buffer, and the normalizer shaped to divide it."""
    z = cases.case_latent(case["shape"], case["seed"])
    _, d, plan = next(cases.step_plans(z, 2, case["r"], 1))
    shape = [-1 if i == 1 + d else 1 for i in range(z.ndim)]
    num = torch.zeros_like(z)
    for k in range(2):
        w = torch.from_numpy(plan.weight_1d(k)).reshape(shape)
        num.narrow(1 + d, plan.starts[k], plan.window).add_(
            cases.exact_denoiser(z.narrow(1 + d, plan.starts[k], plan.window)) * w)
    return num, torch.from_numpy(plan.normalizer()).reshape(shape)
