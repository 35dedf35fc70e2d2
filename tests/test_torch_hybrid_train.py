"""The port's hybrid LM (Zamba2) training path against the JAX reference,
on the CPU.

* ``kernels/ref.ssd_scan_bwd`` (the plain backward of the SSD scan, in the
  chunked formulas of the ``mamba_ssd_bwd`` kernel) against
  ``torch.autograd`` of ``ref.ssd_scan`` and against ``jax.vjp`` of the
  reference's ``gated_linear_scan``, at chunk 16 and 64, a ragged length
  and steep decays with the +-60 clip active: each gradient within 1e-4
  of its max-abs (f32, sums in another order).
* ``ops.MambaSSD`` on CPU tensors (its plain forward and backward) equals
  autograd of the plain scan within the same tolerance.
* The reduced zamba2 config in f32 (4 Mamba2 blocks, 2 shared-attention
  invocations with nonzero LoRA), the reference's weights carried over by
  ``params_from_numpy``: ``Model.loss`` and every gradient leaf against
  ``jax.value_and_grad`` (loss rtol 1e-5, each leaf within 1e-5 + 1e-4 x
  its max-abs), with and without remat; two ``make_train_step`` steps
  (AdamW, 2 microbatches, remat full) against the reference's, losses
  within 1e-4 relative (as the dense family's test: at a peak LR of 0.5
  AdamW's update of a near-zero gradient is about LR times its sign, so
  parameters are no fair comparison).
* The hybrid tree (its stacked Mamba2 leaves, the shared block, the LoRA
  stacks) in bf16 and f32, with AdamW's state, round-trips bit-equal
  through ``runtime/checkpoint``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.configs.base import ParallelConfig as JParallel
from repro.models import ssm as jssm
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import tree
from repro_torch.configs.base import ParallelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as ttr
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train.loop import make_train_step

ARCH = "zamba2-2.7b"
B, S = 2, 24
GRAD_NAMES = ("dx", "dlog_decay", "dscale", "dB", "dC")

# b, s, h, p, n, chunk, steep
SCAN_CASES = {
    "chunk16": (2, 48, 3, 8, 16, 16, False),
    "chunk64": (1, 128, 2, 16, 8, 64, False),
    "ragged": (2, 37, 3, 8, 16, 16, False),
    "steep_clipped": (1, 70, 2, 16, 16, 32, True),
    "steep_ragged": (2, 75, 2, 8, 8, 64, True),
}


def _scan_inputs(b, s, h, p, n, steep, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a = dt * -rng.uniform(0.5, 8.0, size=(h,)).astype(np.float32)
    if steep:        # |cum - centre| passes 60 inside a chunk: the clip decides
        a = -rng.uniform(2.0, 6.0, size=(b, s, h)).astype(np.float32)
    Bm = rng.normal(size=(b, s, 1, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, 1, n)).astype(np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    return x, a, dt, Bm, Cm, dy


def _close(got, want, what):
    for name, g, w in zip(GRAD_NAMES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_ssd_scan_bwd_matches_autograd_and_jax_vjp(case):
    b, s, h, p, n, chunk, steep = SCAN_CASES[case]
    arrays = _scan_inputs(b, s, h, p, n, steep, seed=len(case))
    x, a, dt, Bm, Cm, dy = (torch.from_numpy(v) for v in arrays)
    if steep:
        cum = torch.cumsum(torch.nn.functional.pad(a, (0, 0, 0, -s % chunk)).reshape(
            b, -1, chunk, h), dim=2)
        assert float((cum.amax(2) - cum.amin(2)).max()) > 120   # the clip is active
    got = ref.ssd_scan_bwd(x, a, dt, Bm, Cm, dy, chunk)
    leaves = [t.clone().requires_grad_() for t in (x, a, dt, Bm, Cm)]
    want = torch.autograd.grad(ref.ssd_scan(*leaves, chunk=chunk), leaves, dy)
    _close([g.numpy() for g in got], [w.numpy() for w in want], "autograd")
    _, vjp = jax.vjp(lambda *t: jssm.gated_linear_scan(*t, chunk=chunk, factorized=True),
                     *(jnp.asarray(v) for v in arrays[:5]))
    _close([g.numpy() for g in got], vjp(jnp.asarray(arrays[5])), "jax.vjp")


# b, s, h, p, n, chunk, steep: Zamba2's p = n = chunk = 64 at a ragged
# length, steep decays with the clip active, p = n = 16, and p != n
TF32_BWD_CASES = {
    "zamba_ragged": (1, 150, 2, 64, 64, 64, False),
    "steep_clipped": (1, 150, 2, 16, 16, 32, True),
    "p16_n16": (2, 70, 3, 16, 16, 16, False),
    "p32_n16": (1, 64, 2, 32, 16, 32, False),
}


def _ssd_bwd_shares(got, want):
    """Each gradient's largest share of the card's limit for
    ``mamba_ssd_bwd`` (``test_torch_kernels_cuda._ssd_bwd_close``): 1e-4 of
    the gradient's max-abs plus 1e-4 of the element."""
    shares = []
    for g, w in zip(got, want):
        g, w = np.asarray(g, dtype=np.float64), np.asarray(w, dtype=np.float64)
        assert g.shape == w.shape and np.isfinite(g).all()
        shares.append(float((np.abs(g - w) / (1e-4 * np.abs(w).max() + 1e-4 * np.abs(w))).max()))
    return shares


@pytest.mark.parametrize("case", sorted(TF32_BWD_CASES))
def test_ssd_bwd_pass_split_in_3xtf32_matches_plain_and_jax_vjp(case):
    """``ref.mamba_ssd_bwd_tf32`` (the kernel's passes: the local terms, the
    carry, the chunk-local rest, every product in 3xTF32) within the card's
    tolerance of ``ref.ssd_scan_bwd`` and of ``jax.vjp`` of the reference's
    ``gated_linear_scan``; one TF32 pass misses it."""
    b, s, h, p, n, chunk, steep = TF32_BWD_CASES[case]
    arrays = _scan_inputs(b, s, h, p, n, steep, seed=len(case) + 7)
    x, a, dt, Bm, Cm, dy = (torch.from_numpy(v) for v in arrays)
    args = (x, a, dt, Bm[:, :, 0], Cm[:, :, 0], dy, chunk)
    got = ref.mamba_ssd_bwd_tf32(*args)
    plain = ref.mamba_ssd_bwd_plain(*args)
    assert max(_ssd_bwd_shares(got, plain)) <= 1.0
    _, vjp = jax.vjp(lambda *t: jssm.gated_linear_scan(*t, chunk=chunk, factorized=True),
                     *(jnp.asarray(v) for v in arrays[:5]))
    want = [np.asarray(w) for w in vjp(jnp.asarray(arrays[5]))]
    want[3], want[4] = want[3][:, :, 0], want[4][:, :, 0]
    assert max(_ssd_bwd_shares(got, want)) <= 1.0
    assert max(_ssd_bwd_shares(ref.mamba_ssd_bwd_tf32(*args, passes=1), plain)) > 1.0


def test_mamba_ssd_autograd_function_on_the_cpu_is_the_plain_gradient():
    x, a, dt, Bm, Cm, dy = (torch.from_numpy(v) for v in _scan_inputs(2, 37, 3, 16, 16, True,
                                                                        seed=3))
    args = (x, a, dt, Bm[:, :, 0], Cm[:, :, 0])
    leaves = [t.clone().requires_grad_() for t in args]
    y = ops.mamba_ssd_autograd(*leaves, chunk=16)
    got = torch.autograd.grad(y, leaves, dy)
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ref.mamba_ssd_plain(*plain, chunk=16), plain, dy)
    assert ops.launch_counts() == {name: 0 for name in ops.WRAPPERS}   # the plain versions
    _close([g.numpy() for g in got], [w.numpy() for w in want], "MambaSSD")


# ---------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port cfg, port model, port params): the
    reduced zamba2 in f32 with nonzero LoRA ``b``."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    jm = jmodels.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for nm in ("q", "k", "v"):
        w = params["lora"][nm]["b"]["w"]
        params["lora"][nm]["b"]["w"] = jnp.asarray(
            rng.normal(size=w.shape).astype(np.float32) * 0.05)
    cfg = tconfigs.get_config(ARCH).reduced()
    return jm, params, cfg, tmodels.build(cfg, device="cpu"), _port_params(params, cfg)


def _port_params(params, cfg):
    return ttr.params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")


def _batch(cfg, seed, B_=B, S_=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B_, S_)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, size=(B_, S_)).astype(np.int32)
    lab[0, -3:] = -1                                  # ignored positions
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})


@pytest.fixture(scope="module")
def jax_results(pair):
    """The reference's loss and gradients on one batch, and its two train
    steps' losses."""
    jm, params, cfg, _, _ = pair
    jb, tb = _batch(cfg, 1)
    jloss, jgrads = jax.value_and_grad(jm.loss)(params, jb)
    raw = j_make_train_step(jm, JParallel(remat="full", microbatch=2), peak_lr=0.5,
                            total_steps=20)
    step = jax.jit(raw)
    p, o, losses = params, raw.opt_init(params), []
    for s in range(2):
        p, o, m = step(p, o, _batch(cfg, 20 + s, B_=4)[0], jnp.int32(s + 5))
        losses.append(float(m["loss"]))
    return {"loss": float(jloss), "grads": [np.asarray(g) for g in jax.tree.leaves(jgrads)],
            "batch": tb, "losses": losses}


@pytest.mark.parametrize("remat", [False, True])
def test_hybrid_loss_and_every_gradient_match_reference(pair, jax_results, remat):
    _, params, cfg, tm, tp = pair
    leaves, paths = tree.flatten(tp)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = tm.loss(tree.unflatten(tp, live), jax_results["batch"], remat=remat)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), jax_results["loss"], rtol=1e-5)
    assert paths == ["/".join(str(getattr(k, "key", k)) for k in kp)
                     for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert len(grads) == len(jax_results["grads"])
    assert any("A_log" in path for path in paths) and any("lora" in path for path in paths)
    for path, g, w in zip(paths, grads, jax_results["grads"]):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_hybrid_train_step_matches_reference(pair, jax_results):
    _, params, cfg, tm, _ = pair
    step_fn = make_train_step(tm, ParallelConfig(remat="full", microbatch=2), peak_lr=0.5,
                              total_steps=20)
    p = _port_params(params, cfg)
    o, losses = step_fn.opt_init(p), []
    for s in range(2):
        p, o, m = step_fn(p, o, _batch(cfg, 20 + s, B_=4)[1], s + 5)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, jax_results["losses"], rtol=1e-4)
    assert all(bool(torch.isfinite(t).all()) for t in tree.flatten(p)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hybrid_tree_checkpoint_round_trip(tmp_path, dtype):
    """Zamba2's tree as the trainer saves it, (params, AdamW state), with
    the model's leaves in ``dtype`` (bf16 at full width) and the f32
    leaves (``A_log``, ``D``, ``dt_bias``, norms, the optimizer's moments):
    every leaf bit-equal and of its dtype after ``restore``."""
    import dataclasses

    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                              dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    model = tmodels.build(cfg, device="cpu")
    params = model.init(3)
    opt = make_train_step(model, ParallelConfig()).opt_init(params)
    state = (params, opt)
    leaves, paths = tree.flatten(state)
    assert {t.dtype for t in leaves} >= {dtype, torch.float32}
    assert any(p.startswith("0/mamba/") for p in paths) and any("/lora/" in p for p in paths)
    ckpt.save(str(tmp_path), 4, state)
    restored, meta = ckpt.restore(str(tmp_path), state)
    assert meta["step"] == 4
    for path, a, b in zip(paths, leaves, tree.flatten(restored)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b), path
