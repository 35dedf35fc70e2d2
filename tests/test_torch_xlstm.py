"""The port's xLSTM family (xlstm-1.3b) against the JAX reference, on the CPU.

The reduced config (4 blocks, ``slstm_every`` 2: two groups of one mLSTM
and one sLSTM block; d 128, 2 heads, so the mLSTM's scans run at p = n =
128 with g = h = 2) runs in f32 with the reference's weights, carried over
by ``transformer.params_from_numpy``.  Inputs are made with numpy.  Stated
tolerance: hidden states, logits, caches, losses and scans 2e-4 + 2e-4
|ref| (f32, sums in another order), the other family tests' tolerance.
The reference holds no absolute prefill-vs-decode gap for xLSTM (its
prefill clips the input gate to +-10, its decode does not), so the port's
gap is held to the reference's own gap on the same inputs, within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.models import xlstm as jx
from repro.serving import serve_step as jserve
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models import xlstm as tx
from repro_torch.serving import serve_step as tserve

ARCH = "xlstm-1.3b"
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    of the reduced config, built once for the file."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    jm = jmodels.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = tconfigs.get_config(ARCH).reduced()
    tm = tmodels.build(cfg, device="cpu")
    tp = ttr.params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, jm, params, cfg, tm, tp


def _layer(jtree, ttree, *idx):
    return jax.tree.map(lambda a: a[idx], jtree), ttr._index(ttree, *idx)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **{**TOL, **kw})


def test_configs_equal():
    j, t = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.padded_vocab_size == b.padded_vocab_size
    assert (t.num_layers, t.slstm_every, t.d_model, t.num_heads) == (48, 8, 2048, 4)
    r = t.reduced()
    assert (r.num_layers, r.slstm_every, r.d_model, r.num_heads) == (4, 2, 128, 2)


def test_init_params_has_the_reference_tree(pair):
    """The port's own init: the reference's tree, leaf shapes and dtypes
    (the mLSTM stack ``(groups, 7)``-shaped at full depth, here ``(2, 1)``),
    and the sLSTM FFN's ``wi`` and ``wg`` equal, as the reference draws
    them from one key."""
    _, _, params, cfg, _, _ = pair
    mine = ttr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert sorted(got) == sorted(jax.tree_util.keystr(k) for k, _ in want)
    for k, v in want:
        t = got[jax.tree_util.keystr(k)]
        assert tuple(t.shape) == v.shape and str(t.dtype).split(".")[-1] == str(v.dtype), k
    assert tuple(mine["mlstm"]["q"]["w"].shape[:2]) == (2, 1)
    assert torch.equal(mine["slstm"]["ffn"]["wi"]["w"], mine["slstm"]["ffn"]["wg"]["w"])
    assert mine["slstm"]["ffn"]["wi"]["w"].data_ptr() != mine["slstm"]["ffn"]["wg"]["w"].data_ptr()


@pytest.mark.parametrize("chunk,S", [(128, 24), (16, 40)])
def test_mlstm_apply_matches_reference(pair, chunk, S):
    """One mLSTM block; chunk 16 at 40 tokens: three chunks, the last ragged."""
    jcfg, _, params, cfg, _, tp = pair
    jl, tl = _layer(params["mlstm"], tp["mlstm"], 1, 0)
    x = _x(cfg, 2, S, seed=1)
    want = jx.mlstm_apply(jl, jnp.asarray(x), cfg.num_heads, chunk=chunk)
    _close(tx.mlstm_apply(tl, torch.from_numpy(x), cfg.num_heads, chunk=chunk), want)


def test_mlstm_decode_matches_reference(pair):
    """Six steps of one mLSTM block from a zero cache: outputs every step,
    the cache (conv, C, n, m) at the end."""
    _, _, params, cfg, _, tp = pair
    jl, tl = _layer(params["mlstm"], tp["mlstm"], 0, 0)
    x = _x(cfg, 2, 6, seed=2)
    jc = jx.mlstm_init_cache(2, cfg.d_model, cfg.num_heads)
    tc = tx.mlstm_init_cache(2, cfg.d_model, cfg.num_heads)
    step = jax.jit(lambda p, xt, c: jx.mlstm_decode(p, xt, c, cfg.num_heads))
    for t in range(6):
        jo, jc = step(jl, jnp.asarray(x[:, t:t + 1]), jc)
        to, tc = tx.mlstm_decode(tl, torch.from_numpy(x[:, t:t + 1]), tc, cfg.num_heads)
        _close(to, jo, err_msg=f"step {t}")
    for k in ("conv", "C", "n", "m"):
        _close(tc[k], jc[k], err_msg=k)


def test_slstm_apply_matches_reference(pair):
    _, _, params, cfg, _, tp = pair
    jl, tl = _layer(params["slstm"], tp["slstm"], 1)
    x = _x(cfg, 2, 24, seed=3)
    want = jx.slstm_apply(jl, jnp.asarray(x), cfg.num_heads)
    _close(tx.slstm_apply(tl, torch.from_numpy(x), cfg.num_heads), want)


def test_slstm_decode_matches_reference(pair):
    _, _, params, cfg, _, tp = pair
    jl, tl = _layer(params["slstm"], tp["slstm"], 0)
    x = _x(cfg, 2, 6, seed=4)
    jc = jx.slstm_init_cache(2, cfg.d_model, cfg.num_heads)
    tc = tx.slstm_init_cache(2, cfg.d_model, cfg.num_heads)
    step = jax.jit(lambda p, xt, c: jx.slstm_decode(p, xt, c, cfg.num_heads))
    for t in range(6):
        jo, jc = step(jl, jnp.asarray(x[:, t:t + 1]), jc)
        to, tc = tx.slstm_decode(tl, torch.from_numpy(x[:, t:t + 1]), tc, cfg.num_heads)
        _close(to, jo, err_msg=f"step {t}")
    for k in ("c", "n", "m", "h"):
        _close(tc[k], jc[k], err_msg=k)


def test_forward_and_loss_match_reference(pair):
    jcfg, jm, params, cfg, tm, tp = pair
    tok = _tokens(cfg, 2, 21, seed=5)
    jb = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:])}
    tb = {"tokens": torch.from_numpy(tok[:, :-1]), "labels": torch.from_numpy(tok[:, 1:])}
    jh, jaux = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))(params, jb["tokens"])
    th, taux = tm.forward(tp, {"tokens": tb["tokens"]})
    _close(th, jh)
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(float(tm.loss(tp, tb)), float(jax.jit(jm.loss)(params, jb)),
                               **TOL)


def _stepped(decode, params, tok, cache, to_native):
    outs = []
    for t in range(tok.shape[1]):
        pos = np.full((tok.shape[0],), t, np.int32)
        lg, cache = decode(params, {"token": to_native(tok[:, t:t + 1]),
                                    "position": to_native(pos)}, cache)
        outs.append(np.asarray(lg.numpy() if isinstance(lg, torch.Tensor) else lg))
    return np.concatenate(outs, axis=1), cache


@pytest.fixture(scope="module")
def serve_runs(pair):
    """Both packages' prefill logits of every position (the forward's) and
    their stepped decode's logits on the same 12 tokens, from a zero
    cache; and the caches at the end."""
    jcfg, jm, params, cfg, tm, tp = pair
    tok = _tokens(cfg, 2, 12, seed=6)
    jfull = jax.jit(lambda p, t: jtr.logits_fn(p, jm.forward(p, {"tokens": t})[0], jcfg))(
        params, jnp.asarray(tok))
    tfull = ttr.logits_fn(tp, tm.forward(tp, {"tokens": torch.from_numpy(tok)})[0], cfg)
    jdec, jc = _stepped(jax.jit(jserve.make_decode_step(jm, jcfg)), params, tok,
                        jm.init_cache(2, 12), jnp.asarray)
    tdec, tc = _stepped(tserve.make_decode_step(tm, cfg), tp, tok, tm.init_cache(2, 12),
                        torch.from_numpy)
    return tok, np.asarray(jfull), tfull.numpy(), jdec, tdec, jc, tc


def test_prefill_and_decode_steps_match_reference(pair, serve_runs):
    """The prefill step's last-token logits, then 12 decode steps from a
    zero cache: logits at every step and every cache tensor at the end."""
    jcfg, jm, params, cfg, tm, tp = pair
    tok, _, _, jdec, tdec, jc, tc = serve_runs
    want = jax.jit(jserve.make_prefill_step(jm, jcfg))(params, {"tokens": jnp.asarray(tok)})
    got = tserve.make_prefill_step(tm, cfg)(tp, {"tokens": torch.from_numpy(tok)})
    assert tuple(got.shape) == (2, 1, cfg.padded_vocab_size)
    _close(got, want)
    np.testing.assert_allclose(tdec, jdec, **TOL)
    for fam in ("mlstm", "slstm"):
        for k in tc[fam]:
            assert tuple(tc[fam][k].shape) == jc[fam][k].shape, (fam, k)
            _close(tc[fam][k], jc[fam][k], err_msg=f"{fam}.{k}")


def test_prefill_vs_decode_gap_equals_the_references(serve_runs):
    """The port's prefill logits minus its stepped decode's, elementwise,
    against the reference's own difference on the same tokens (1e-4)."""
    _, jfull, tfull, jdec, tdec, _, _ = serve_runs
    np.testing.assert_allclose(tfull - tdec, jfull - jdec, rtol=0, atol=1e-4)
    assert abs(np.abs(tfull - tdec).max() - np.abs(jfull - jdec).max()) <= 1e-4


# ------------------------------------------------------------ the scan
SCAN_CASES = {
    # b, s, h, g, p, n, chunk
    "g_equals_h": (2, 40, 2, 2, 16, 16, 16),
    "g_below_h": (1, 48, 4, 2, 8, 16, 16),
    "p_one": (2, 33, 2, 2, 1, 32, 16),
    "ragged_s": (1, 37, 3, 1, 16, 16, 16),
    "reduced_mlstm": (1, 20, 2, 2, 128, 128, 128),
}


def _scan_inputs(b, s, h, g, p, n, seed, steep=False):
    """mLSTM-like inputs: log_decay = logsigmoid(f) with f around the
    forget-gate bias (3 ... 6), scale = exp(clip(i, -10, 10)), B scaled by
    1 / sqrt(n); ``steep`` decays (-2 ... -6 per token) reach the clip."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    f = rng.normal(size=(b, s, h)) + np.linspace(3.0, 6.0, h)
    a = -np.logaddexp(0.0, -f)
    if steep:
        a = -rng.uniform(2.0, 6.0, size=(b, s, h))
    dt = np.exp(np.clip(rng.normal(size=(b, s, h)), -10, 10))
    B = rng.normal(size=(b, s, g, n)) / np.sqrt(n)
    C = rng.normal(size=(b, s, g, n))
    return [v.astype(np.float32) for v in (x, a, dt, B, C)]


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_ssd_scan_matches_jax_gated_linear_scan(case, steep):
    b, s, h, g, p, n, chunk = SCAN_CASES[case]
    args = _scan_inputs(b, s, h, g, p, n, seed=s + h, steep=steep)
    want = jssm.gated_linear_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    got = ref.ssd_scan(*(torch.from_numpy(a) for a in args), chunk)
    _close(got, want)
    # the wrapper's plain route on CPU tensors, and the model's scan
    ops.reset_launch_counts()
    wide = ops.mamba_ssd_wide(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert torch.equal(wide, got) and ops.launch_counts()["mamba_ssd_wide"] == 0
    assert torch.equal(tssm.gated_linear_scan(*(torch.from_numpy(a) for a in args),
                                              chunk=chunk), got)


# the grouped scan kernel's arithmetic (ref.mamba_ssd_wide_tf32): b, s, h, g,
# p, n, chunk; n past one 128-row slice (the cluster's rank-order sum), past
# one cluster of 8 slices (1040: two clusters), p past one 128-column strip,
# and p <= 4 (the narrow path)
WIDE_TF32_CASES = {
    "g_equals_h": (1, 70, 2, 2, 24, 272, 32),
    "g_below_h_ragged": (1, 75, 4, 2, 16, 48, 16),
    "two_clusters_two_strips": (1, 40, 2, 1, 130, 1040, 16),
    "normaliser_p1": (2, 50, 2, 2, 1, 144, 32),
    "narrow_p3_two_clusters": (1, 40, 2, 1, 3, 1040, 16),
}
SSD_TOL = dict(rtol=5e-4, atol=5e-4)   # the reference's own SSD tolerance


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("case", sorted(WIDE_TF32_CASES))
def test_mamba_ssd_wide_tf32_matches_jax_scan(case, steep):
    """The kernel's passes and 3xTF32 splits (f32 FMA on the narrow path)
    within the reference's SSD tolerance of ``gated_linear_scan(
    factorized=True)``, steep decays (the clip) included; its states equal
    ``ref.ssd_scan``'s within the same tolerance."""
    b, s, h, g, p, n, chunk = WIDE_TF32_CASES[case]
    args = _scan_inputs(b, s, h, g, p, n, seed=s + n + steep, steep=steep)
    want = np.asarray(jssm.gated_linear_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                                             factorized=True))
    targs = [torch.from_numpy(a) for a in args]
    got, states = ref.mamba_ssd_wide_tf32(*targs, chunk=chunk, return_states=True)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SSD_TOL)
    _, plain_states = ref.ssd_scan(*targs, chunk, True, True)
    assert states.shape == plain_states.shape == (b, -(-s // chunk), h, n, p)
    np.testing.assert_allclose(states.numpy(), plain_states.numpy(), **SSD_TOL)
    assert torch.equal(ref.mamba_ssd_wide_tf32(*targs, chunk=chunk), got)


@pytest.mark.parametrize("case", ["g_equals_h", "two_clusters_two_strips"])
def test_one_tf32_pass_misses_the_scan_tolerance(case):
    """3xTF32 is needed: with one TF32 pass (hi . hi) the same passes fall
    outside the reference's SSD tolerance."""
    b, s, h, g, p, n, chunk = WIDE_TF32_CASES[case]
    args = [torch.from_numpy(a) for a in _scan_inputs(b, s, h, g, p, n, seed=s + n)]
    want = ref.ssd_scan(*(t.double() for t in args), chunk)
    one = ref.mamba_ssd_wide_tf32(*args, chunk=chunk, passes=1).double()
    three = ref.mamba_ssd_wide_tf32(*args, chunk=chunk).double()
    limit = SSD_TOL["atol"] + SSD_TOL["rtol"] * want.abs()
    assert float(((three - want).abs() / limit).max()) < 1.0
    assert float(((one - want).abs() / limit).max()) > 1.0


def test_ssd_kernel_routes_by_shape():
    """Zamba2's scans stay on mamba_ssd; the mLSTM's (groups, widths past
    128, p = 1) and everything else go to mamba_ssd_wide."""
    full = tconfigs.get_config(ARCH)
    dh = 2 * full.d_model // full.num_heads
    assert ops.ssd_kernel(1, 64, 64, 64) == "mamba_ssd"
    assert ops.ssd_kernel(1, 128, 128, 128) == "mamba_ssd"
    assert ops.ssd_kernel(full.num_heads, dh, dh, 128) == "mamba_ssd_wide"
    assert ops.ssd_kernel(full.num_heads, 1, dh, 128) == "mamba_ssd_wide"
    assert ops.ssd_kernel(1, 1, 64, 64) == "mamba_ssd_wide"
    assert ops.ssd_kernel(2, 64, 64, 64) == "mamba_ssd_wide"
    assert ops.ssd_kernel(1, 256, 64, 64) == "mamba_ssd_wide"


def test_cpu_xlstm_path_never_launches_a_kernel(pair):
    _, _, _, cfg, tm, tp = pair
    ops.reset_launch_counts()
    tok = torch.from_numpy(_tokens(cfg, 1, 10, seed=7))
    assert bool(torch.isfinite(tserve.make_prefill_step(tm, cfg)(tp, {"tokens": tok})).all())
    cache = tm.init_cache(1, 4)
    tm.decode(tp, tok[:, :1], cache, torch.zeros(1, dtype=torch.int32))
    assert set(ops.launch_counts().values()) == {0}
