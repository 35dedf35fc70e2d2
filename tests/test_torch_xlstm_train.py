"""The port's xLSTM training path against the JAX reference, on the CPU.

* ``kernels/ref.ssd_scan_bwd`` with B and C in groups (the plain version of
  ``mamba_ssd_wide_bwd``) against ``torch.autograd`` of ``ref.ssd_scan``
  and against ``jax.vjp`` of the reference's ``gated_linear_scan``: g < h,
  g = h, p = 1 (the mLSTM's normaliser), a ragged last chunk and steep
  decays with the +-60 clip active; each gradient within 1e-4 of its
  max-abs (f32, sums in another order).
* ``ops.MambaSSDWide`` on CPU tensors (its plain forward and backward)
  equals autograd of the plain scan within the same tolerance.
* The reduced xlstm-1.3b in f32 (4 blocks: two groups of one mLSTM and one
  sLSTM block; the mLSTM's scans at p = n = 128, g = h = 2), the
  reference's weights carried over by ``params_from_numpy``:
  ``Model.loss`` with remat and every gradient leaf against
  ``jax.value_and_grad`` (loss rtol 1e-5, each leaf within 1e-5 + 1e-4 x
  its max-abs, the tolerance of the other families' gradient tests); two
  ``make_train_step`` steps (AdamW, 2 microbatches, remat full) against
  the reference's, losses within 1e-4 relative (as the dense and hybrid
  families' tests: at a peak LR of 0.5 AdamW's update of a near-zero
  gradient is about LR times its sign, so parameters are no fair
  comparison).
* The train CLI on the CPU for xlstm-1.3b.
* Routing: f32 at head dim 32 (the reduced configs') names the f32 flash
  kernels, and ``gated_linear_scan`` under grad takes the wide scan's
  autograd route by shape; the plain f32 flash backward at D 32 against
  ``jax.vjp`` of the reference's ``attention_chunked`` (causal and
  windowed, 1e-5 + 1e-5 relative: f32, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.configs.base import ParallelConfig as JParallel
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import tree
from repro_torch.configs.base import ParallelConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train.loop import make_train_step

ARCH = "xlstm-1.3b"
B, S = 2, 20
GRAD_NAMES = ("dx", "dlog_decay", "dscale", "dB", "dC")

# b, s, h, g, p, n, chunk, steep
SCAN_CASES = {
    "g_below_h": (2, 48, 4, 2, 8, 16, 16, False),
    "g_equals_h": (1, 64, 2, 2, 16, 16, 32, False),
    "normaliser_p1": (2, 40, 2, 2, 1, 16, 16, False),
    "ragged_g1": (2, 37, 3, 1, 5, 8, 16, False),
    "steep_ragged_g2": (1, 75, 4, 2, 8, 16, 32, True),
}


def _scan_inputs(b, s, h, g, p, n, steep, seed):
    """Inputs as an mLSTM feeds its scans: logsigmoid forget gates around a
    per-head bias, exp of a clipped input gate, B a key over sqrt(n)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    f = rng.normal(size=(b, s, h)) + np.linspace(3.0, 6.0, h)
    a = (-np.logaddexp(0.0, -f)).astype(np.float32)
    if steep:        # |cum - centre| passes 60 inside a chunk: the clip decides
        a = -rng.uniform(2.0, 6.0, size=(b, s, h)).astype(np.float32)
    dt = np.exp(np.clip(rng.normal(size=(b, s, h)), -10, 10)).astype(np.float32)
    Bm = (rng.normal(size=(b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    return x, a, dt, Bm, Cm, dy


def _close(got, want, what):
    for name, g, w in zip(GRAD_NAMES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_grouped_ssd_scan_bwd_matches_autograd_and_jax_vjp(case):
    b, s, h, g, p, n, chunk, steep = SCAN_CASES[case]
    arrays = _scan_inputs(b, s, h, g, p, n, steep, seed=len(case))
    x, a, dt, Bm, Cm, dy = (torch.from_numpy(v) for v in arrays)
    if steep:
        cum = torch.cumsum(torch.nn.functional.pad(a, (0, 0, 0, -s % chunk)).reshape(
            b, -1, chunk, h), dim=2)
        assert float((cum.amax(2) - cum.amin(2)).max()) > 120   # the clip is active
    got = ref.ssd_scan_bwd(x, a, dt, Bm, Cm, dy, chunk)
    leaves = [t.clone().requires_grad_() for t in (x, a, dt, Bm, Cm)]
    want = torch.autograd.grad(ref.ssd_scan(*leaves, chunk=chunk), leaves, dy)
    _close([t.numpy() for t in got], [w.numpy() for w in want], "autograd")
    vjp = jax.jit(lambda args, ct: jax.vjp(
        lambda *t: jssm.gated_linear_scan(*t, chunk=chunk, factorized=True), *args)[1](ct))
    _close([t.numpy() for t in got],
           vjp(tuple(jnp.asarray(v) for v in arrays[:5]), jnp.asarray(arrays[5])), "jax.vjp")
    # in float64: the same formulas, within the same tolerance of f32's
    got64 = ref.ssd_scan_bwd(*(t.double() for t in (x, a, dt, Bm, Cm, dy)), chunk)
    assert all(t.dtype == torch.float64 for t in got64)
    _close([t.float().numpy() for t in got64], [w.numpy() for w in want], "float64")


def test_mamba_ssd_wide_autograd_function_on_the_cpu_is_the_plain_gradient():
    x, a, dt, Bm, Cm, dy = (torch.from_numpy(v)
                            for v in _scan_inputs(2, 37, 4, 2, 8, 16, True, seed=3))
    args = (x, a, dt, Bm, Cm)
    leaves = [t.clone().requires_grad_() for t in args]
    before = ops.launch_counts()
    y = ops.mamba_ssd_wide_autograd(*leaves, chunk=16)
    got = torch.autograd.grad(y, leaves, dy)
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ref.ssd_scan(*plain, chunk=16), plain, dy)
    assert ops.launch_counts() == before                     # the plain versions
    _close([t.numpy() for t in got], [w.numpy() for w in want], "MambaSSDWide")
    y2, states = ops.mamba_ssd_wide(*args, chunk=16, return_states=True)
    assert torch.equal(y2, y.detach()) and states.shape == (2, 3, 4, 16, 8)


# b, s, h, g, p, n, chunk, steep: the wide backward's passes (ref.mamba_ssd_wide_bwd_tf32)
TF32_CASES = {
    "g_below_h_ragged": (2, 37, 4, 2, 8, 16, 16, False),
    "steep_ragged_g2": (1, 75, 4, 2, 8, 16, 32, True),
    "normaliser_p1": (2, 40, 2, 2, 1, 16, 16, False),
    "narrow_p3_g1": (2, 37, 3, 1, 3, 32, 16, False),
    "two_block_cluster_n144": (1, 70, 2, 2, 8, 144, 32, True),
}


def _jax_scan_vjp(arrays, chunk):
    vjp = jax.jit(lambda args, ct: jax.vjp(
        lambda *t: jssm.gated_linear_scan(*t, chunk=chunk, factorized=True), *args)[1](ct))
    return vjp(tuple(jnp.asarray(v) for v in arrays[:5]), jnp.asarray(arrays[5]))


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_wide_bwd_tf32_passes_match_jax_vjp(case):
    """The kernel's arithmetic on the CPU (3xTF32 products over its
    k-groups, the cluster's partials of B dS in rank order, f32 FMA on the
    narrow path) against ``jax.vjp`` of the reference's scan, each
    gradient within 1e-4 of its max-abs; without dx the other four are
    bit-equal."""
    b, s, h, g, p, n, chunk, steep = TF32_CASES[case]
    arrays = _scan_inputs(b, s, h, g, p, n, steep, seed=len(case) + 7)
    args = [torch.from_numpy(v) for v in arrays]
    got = ref.mamba_ssd_wide_bwd_tf32(*args, chunk)
    _close([t.numpy() for t in got], _jax_scan_vjp(arrays, chunk), f"tf32 {case}")
    rest = ref.mamba_ssd_wide_bwd_tf32(*args, chunk, need_dx=False)
    assert rest[0] is None and all(torch.equal(u, v) for u, v in zip(got[1:], rest[1:]))


def test_one_tf32_pass_misses_the_wide_bwd_tolerance():
    """One TF32 pass (hi.hi: what the kernel's broken copy `one_pass_tf32`
    issues) takes some gradient past the 1e-4-of-max-abs tolerance that
    three passes meet, on the value scan's path and on the narrow one."""
    for case in ("g_below_h_ragged", "normaliser_p1"):
        b, s, h, g, p, n, chunk, steep = TF32_CASES[case]
        arrays = _scan_inputs(b, s, h, g, p, n, steep, seed=len(case) + 7)
        want = _jax_scan_vjp(arrays, chunk)
        got = ref.mamba_ssd_wide_bwd_tf32(*(torch.from_numpy(v) for v in arrays), chunk,
                                          passes=1)
        shares = [float(np.abs(np.asarray(gv) - np.asarray(w)).max() / (1e-4 * np.abs(
            np.asarray(w)).max())) for gv, w in zip(got, want)]
        assert max(shares) > 1.0, (case, shares)


def test_mamba_ssd_wide_autograd_returns_no_dx_where_none_is_needed(monkeypatch):
    """The normaliser's x is a constant: ``MambaSSDWide`` on CPU tensors
    returns None for its gradient and the other four as with it."""
    x, a, dt, Bm, Cm, dy = (torch.from_numpy(v)
                            for v in _scan_inputs(2, 37, 4, 2, 1, 16, False, seed=5))
    leaves = [t.clone().requires_grad_() for t in (a, dt, Bm, Cm)]
    y = ops.mamba_ssd_wide_autograd(x, *leaves, chunk=16)
    y.backward(dy)
    assert x.grad is None
    full = [t.clone().requires_grad_() for t in (x, a, dt, Bm, Cm)]
    want = torch.autograd.grad(ops.mamba_ssd_wide_autograd(*full, chunk=16), full, dy)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want[1:]))
    seen, real = [], ops.mamba_ssd_wide_bwd
    monkeypatch.setattr(ops, "mamba_ssd_wide_bwd",
                        lambda *args, **kw: seen.append(kw) or real(*args, **kw))
    ops.mamba_ssd_wide_autograd(x, *leaves, chunk=16).backward(dy)
    assert [kw["need_dx"] for kw in seen] == [False]


# ---------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port cfg, port model, port params): the
    reduced xlstm-1.3b in f32."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    jm = jmodels.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
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
    """The reference's loss and gradients with remat on one batch, and its
    two train steps' losses (AdamW, 2 microbatches, remat full)."""
    jm, params, cfg, _, _ = pair
    jb, tb = _batch(cfg, 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b, remat=True)))(
        params, jb)
    raw = j_make_train_step(jm, JParallel(remat="full", microbatch=2), peak_lr=0.5,
                            total_steps=20)
    step = jax.jit(raw)
    p, o, losses = params, raw.opt_init(params), []
    for s in range(2):
        p, o, m = step(p, o, _batch(cfg, 20 + s, B_=4)[0], jnp.int32(s + 5))
        losses.append(float(m["loss"]))
    return {"loss": float(jloss), "grads": [np.asarray(g) for g in jax.tree.leaves(jgrads)],
            "batch": tb, "losses": losses}


def test_xlstm_loss_and_every_gradient_match_reference_with_remat(pair, jax_results):
    _, params, cfg, tm, tp = pair
    leaves, paths = tree.flatten(tp)
    live = [t.detach().requires_grad_() for t in leaves]
    loss = tm.loss(tree.unflatten(tp, live), jax_results["batch"], remat=True)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), jax_results["loss"], rtol=1e-5)
    assert paths == ["/".join(str(getattr(k, "key", k)) for k in kp)
                     for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert len(grads) == len(jax_results["grads"])
    assert any("mlstm" in path for path in paths) and any("rec" in path for path in paths)
    for path, g, w in zip(paths, grads, jax_results["grads"]):
        assert g.shape == w.shape, path
        assert float(np.abs(w).max()) > 0, path                 # every leaf is trained
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_xlstm_train_step_matches_reference(pair, jax_results):
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


def test_train_cli_trains_xlstm_on_the_cpu(tmp_path, capsys):
    rep = train_cli.main(["--arch", ARCH, "--steps", "4", "--batch", "2", "--seq", "16",
                          "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert rep.final_step == 4 and rep.restarts == 0 and sorted(rep.losses) == [0, 1, 2, 3]
    assert all(np.isfinite(v) for v in rep.losses.values())
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert capsys.readouterr().out.startswith("finished 4 steps; loss ")


# ------------------------------------------------------------------ routing
def test_f32_head_dim_32_routes_to_the_f32_flash_kernels():
    assert ops.flash_kernel(torch.float32, 32, 16) == "flash_attention"
    assert ops.flash_kernel(torch.float32, 32, 4096) == "flash_attention"
    assert 32 in ops._FLASH_TAKES["flash_attention"][torch.float32]
    assert ops.bwd_kernel(torch.float32, 32) == "flash_attention_bwd_f32"
    assert ops.bwd_kernel(torch.bfloat16, 32) is None
    assert "flash_attention_bwd_f32" in ops.BWD_KERNELS and "flash_attention_bwd_f32" in ops.WRAPPERS
    assert "mamba_ssd_wide_bwd" in ops.WRAPPERS


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to follow
    ``gated_linear_scan``'s routing on the CPU without launching."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("shape,route", [
    ((1, 16, 2, 128, 2, 128, 128), "mamba_ssd_wide_autograd"),   # the mLSTM's value scan
    ((1, 16, 2, 1, 2, 128, 128), "mamba_ssd_wide_autograd"),     # its normaliser
    ((1, 16, 2, 16, 1, 16, 64), "mamba_ssd_autograd"),           # Zamba2's (reduced)
])
def test_gated_linear_scan_under_grad_takes_the_autograd_route_by_shape(monkeypatch, shape,
                                                                      route):
    b, s, h, p, g, n, chunk = shape
    calls = []

    def fake(name):
        def fn(*args, chunk):
            calls.append((name, tuple(args[3].shape)))
            return torch.zeros(args[0].shape)
        return fn

    for name in ("mamba_ssd_autograd", "mamba_ssd_wide_autograd", "mamba_ssd",
                 "mamba_ssd_wide"):
        monkeypatch.setattr(ops, name, fake(name))
    x = torch.Tensor._make_subclass(_OnCard, torch.randn(b, s, h, p), True)
    a, dt = torch.randn(b, s, h), torch.rand(b, s, h)
    Bm, Cm = torch.randn(b, s, g, n), torch.randn(b, s, g, n)
    tssm.gated_linear_scan(x, a, dt, Bm, Cm, chunk=chunk)
    with torch.no_grad():
        tssm.gated_linear_scan(x, a, dt, Bm, Cm, chunk=chunk)
    plain = route.replace("_autograd", "")
    want_b = (b, s, n) if plain == "mamba_ssd" else (b, s, g, n)
    assert calls == [(route, want_b), (plain, want_b)]


# D 32 (the reduced configs'): B, Sq, Skv, H, KV, causal, window, padded keys, kv_chunk
D32_CASES = {"causal_gqa": (2, 24, 40, 4, 2, True, 0, 0, 16),
             "window16_padded": (2, 20, 36, 4, 4, True, 16, 3, 2048)}


@pytest.mark.parametrize("case", sorted(D32_CASES))
def test_plain_f32_backward_at_d32_matches_jax_vjp(case):
    B_, Sq, Skv, H, KV, causal, window, pad, chunk = D32_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B_, Sq, H, 32), (B_, Skv, KV, 32), (B_, Skv, KV, 32)))
    do = rng.normal(size=(B_, Sq, H, 32)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B_, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B_, Skv)).copy()
    if pad:
        kp[:, -pad:] = ref.INT32_MAX
    t = [torch.from_numpy(x) for x in (q, k, v, do, qp, kp)]
    out, lse = ops.flash_attention(t[0], t[1], t[2], t[4], t[5], causal=causal, window=window,
                                   return_lse=True)
    got = ops.flash_attention_bwd(t[0], t[1], t[2], out, t[3], lse, t[4], t[5], causal=causal,
                                  window=window)

    @jax.jit
    def fwd_vjp(q_, k_, v_, do_):
        out_, vjp = jax.vjp(lambda *a: jattn.attention_chunked(
            *a, jnp.asarray(qp), jnp.asarray(kp), causal, window, kv_chunk=chunk), q_, k_, v_)
        return out_, vjp(do_)

    jout, jgrads = fwd_vjp(*(jnp.asarray(t) for t in (q, k, v, do)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for g, w in zip(got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
