"""The port's LM training path against the JAX reference, on the CPU.

granite-3-2b's ``reduced()`` config (f32, 2 layers, d_model 128, 4 / 4 x 32
heads, vocab 512) with the reference's weights, carried over by
``transformer.params_from_numpy``; tokens, labels, gradients and
attention inputs are made with numpy from seeds.  JAX results that several
tests share come from module-scoped fixtures.  Stated tolerances:

* the plain flash backward (``ref.flash_attention_bwd_ref``) against
  ``jax.vjp`` of ``attention_chunked`` and against ``torch.autograd`` of the
  port's plain forward: atol 1e-5, rtol 1e-4 (f32, sums in another order);
* the dense loss rtol 1e-5, each gradient leaf within 1e-5 + 1e-4 x its
  largest magnitude;
* AdamW and Adafactor on the same gradients: parameters and state within
  1e-6; the LR schedule at f32 precision;
* ``make_train_step``'s loss trajectory within 1e-4 relative;
* the data stream's tokens bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.configs.base import ParallelConfig as JParallel
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.optim import adafactor_init as j_adafactor_init
from repro.optim import adafactor_update as j_adafactor_update
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim.schedule import warmup_cosine as j_warmup_cosine
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import tree
from repro_torch.configs.base import ParallelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as ttr
from repro_torch.optim import adafactor_init, adafactor_update, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.loop import make_train_step

ARCH = "granite-3-2b"
BWD_TOL = dict(atol=1e-5, rtol=1e-4)
B, S = 2, 24


def test_configs_equal():
    j, t = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.padded_vocab_size == b.padded_vocab_size
    assert (t.head_dim, t.padded_vocab_size, t.dtype) == (64, 49408, "bfloat16")
    train_fields = dataclasses.asdict(ParallelConfig())
    assert train_fields == {k: dataclasses.asdict(JParallel())[k] for k in train_fields}


# ------------------------------------------------------- plain flash backward
BWD_CASES = {
    # B, Sq, Skv, H, KV, D, causal, window, padded keys, kv_chunk of the reference
    "causal_gqa_chunked": (2, 20, 40, 4, 2, 8, True, 0, 0, 16),
    "window_gqa_padded_keys": (2, 16, 30, 6, 2, 8, True, 5, 3, 2048),
    "unmasked_padded_one_kv_head": (1, 9, 17, 4, 1, 16, False, 0, 3, 8),
}

def _bwd_inputs(B, Sq, Skv, H, KV, D, pad, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    do = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    if pad:
        kp[:, -pad:] = ref.INT32_MAX
    return q, k, v, do, qp, kp


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_flash_backward_matches_jax_vjp_and_autograd(case):
    B_, Sq, Skv, H, KV, D, causal, window, pad, chunk = BWD_CASES[case]
    q, k, v, do, qp, kp = _bwd_inputs(B_, Sq, Skv, H, KV, D, pad, seed=len(case))
    tq, tk, tv, tdo, tqp, tkp = (torch.from_numpy(x) for x in (q, k, v, do, qp, kp))
    out = ref.flash_attention_ref(tq, tk, tv, tqp, tkp, causal, window)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, tqp, tkp, causal, window)

    def fwd(q_, k_, v_):
        return jattn.attention_chunked(q_, k_, v_, jnp.asarray(qp), jnp.asarray(kp), causal,
                                       window, kv_chunk=chunk)

    jout, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **BWD_TOL)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    plain = ref.flash_attention_ref(*leaves, tqp, tkp, causal, window)
    for g, w in zip(got, torch.autograd.grad(plain, leaves, tdo)):
        torch.testing.assert_close(g, w, **BWD_TOL)


def test_flash_autograd_function_on_the_cpu_is_the_plain_gradient():
    """``ops.flash_attention_autograd`` on CPU tensors: the forward is the
    plain flash function, the backward ``flash_attention_bwd``'s plain
    version; both equal autograd through the plain forward, rows that
    attend no key (zero gradients) and ``kv_len`` included.  The function
    saves the forward's log-sum-exp (``ref.flash_attention_lse_ref``, +inf
    on the rows with no key) for the backward kernels.  No kernel counter
    moves."""
    q, k, v, do, qp, kp = _bwd_inputs(2, 10, 14, 4, 2, 8, 0, seed=3)
    qp = qp - 6                                      # queries 0 .. 1 attend no key
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    lens = torch.tensor([14, 9])
    before = ops.launch_counts()
    out = ops.flash_attention_autograd(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp),
                                       causal=True, kv_len=lens)
    kp_eff = torch.where(torch.from_numpy(kp) < lens[:, None], torch.from_numpy(kp),
                         ref.INT32_MAX)
    saved_lse = out.grad_fn.saved_tensors[4]
    want_lse = ref.flash_attention_lse_ref(tq, tk, torch.from_numpy(qp), kp_eff, True, 0)
    assert torch.equal(saved_lse, want_lse) and bool(torch.isposinf(saved_lse[:, :, :2]).all())
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    want_out = ref.flash_attention_ref(tq, tk, tv, torch.from_numpy(qp), kp_eff, True, 0)
    want = torch.autograd.grad(want_out, (tq, tk, tv), torch.from_numpy(do))
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
    assert float(got[0][:, :2].abs().max()) == 0.0
    assert ops.launch_counts() == before


# ------------------------------------------------------------- dense model
@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    jm = jmodels.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = tconfigs.get_config(ARCH).reduced()
    tm = tmodels.build(cfg, device="cpu")
    return jcfg, jm, params, cfg, tm, _port_params(params, cfg)


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
def loss_and_grads(pair):
    jcfg, jm, params, cfg, tm, tp = pair
    jb, tb = _batch(cfg, 1)
    jloss, jgrads = jax.value_and_grad(jm.loss)(params, jb)
    return float(jloss), [np.asarray(g) for g in jax.tree.leaves(jgrads)], tb


@pytest.mark.parametrize("remat", [False, True])
def test_dense_loss_and_every_gradient_match_reference(pair, loss_and_grads, remat):
    jcfg, jm, params, cfg, tm, tp = pair
    jloss, jgrads, tb = loss_and_grads
    leaves, paths = tree.flatten(tp)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = tm.loss(tree.unflatten(tp, live), tb, remat=remat)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    assert paths == ["/".join(str(getattr(k, "key", k)) for k in kp)
                     for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert len(grads) == len(jgrads) == 12
    for path, g, w in zip(paths, grads, jgrads):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 + 1e-4 * np.abs(w).max(),
                                   err_msg=path)


def test_dense_forward_and_decode_match_reference(pair):
    jcfg, jm, params, cfg, tm, tp = pair
    jb, tb = _batch(cfg, 2)
    jh, _ = jm.forward(params, jb)
    th, aux = tm.forward(tp, tb)
    assert float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4, atol=2e-4)
    jcache, tcache = jm.init_cache(B, 8), tm.init_cache(B, 8)
    tok = np.array(jb["tokens"])
    for t in range(4):
        pos = np.full((B,), t, np.int32)
        jl, jcache = jm.decode(params, jnp.asarray(tok[:, t:t + 1]), jcache, jnp.asarray(pos))
        tl, tcache = tm.decode(tp, torch.from_numpy(tok[:, t:t + 1]), tcache,
                               torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=2e-4, atol=2e-4)


def test_cross_entropy_chunked_matches_reference_on_a_ragged_length(pair):
    """A sequence that is not a multiple of ``seq_chunk``: the padded end is
    ignored; the padded vocab columns are masked."""
    jcfg, jm, params, cfg, tm, tp = pair
    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab_size, size=(2, 21)).astype(np.int32)
    want = jtr.cross_entropy_chunked(params, jnp.asarray(hidden), jnp.asarray(labels), jcfg,
                                     seq_chunk=8)
    got = ttr.cross_entropy_chunked(tp, torch.from_numpy(hidden), torch.from_numpy(labels),
                                    cfg, seq_chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_unported_families_name_what_is_missing():
    """The audio family stays unported: its stack, its model and its config
    name the roadmap item.  The xLSTM (``ssm``) family, ported since, builds
    and initialises on the CPU."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), family="audio")
    with pytest.raises(NotImplementedError, match="dense, moe, vlm, hybrid, ssm.*audio.*item 12"):
        ttr.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="audio.*item 12"):
        tmodels.build(cfg, device="cpu")
    with pytest.raises(KeyError, match="item 12"):
        tconfigs.get_config("whisper-small")
    xcfg = tconfigs.get_config("xlstm-1.3b").reduced()
    params = ttr.init_params(xcfg, torch.Generator().manual_seed(0), device="cpu")
    assert sorted(params) == ["embed", "final_norm", "lm_head", "mlstm", "slstm"]
    model = tmodels.build(xcfg, device="cpu")
    hidden, _ = model.forward(params, {"tokens": torch.zeros((1, 5), dtype=torch.int64)})
    assert tuple(hidden.shape) == (1, 5, xcfg.d_model) and bool(torch.isfinite(hidden).all())


# ------------------------------------------------------------- optimizers
def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.normal(0, 0.05, size=p.shape).astype(np.float32), params)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_on_the_same_grads(pair, name):
    jcfg, jm, params, cfg, tm, tp = pair
    j_init, j_update = {"adamw": (j_adamw_init, j_adamw_update),
                        "adafactor": (j_adafactor_init, j_adafactor_update)}[name]
    t_init, t_update = {"adamw": (adamw_init, adamw_update),
                        "adafactor": (adafactor_init, adafactor_update)}[name]
    j_update = jax.jit(j_update)
    jp, js = params, j_init(params)
    tp, ts = _port_params(params, cfg), t_init(_port_params(params, cfg))
    for step in range(3):
        g = _grads_like(params, seed=10 + step)
        lr = 1e-2 * (step + 1)
        jp, js, jn = j_update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(lr))
        tp, ts, tn = t_update(ttr.params_from_numpy(g, cfg, "cpu"), ts, tp, lr)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    jl, jpaths = tree.flatten(jax.tree.map(np.asarray, (jp, js)))
    tl, tpaths = tree.flatten((tp, ts))
    assert tpaths == jpaths
    assert int(ts["step"]) == int(js["step"]) == 3 and ts["step"].dtype == torch.int32
    for path, t, j in zip(tpaths, tl, jl):
        assert tuple(t.shape) == j.shape, path
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6, err_msg=path)


def test_optimizer_states_mirror_the_reference():
    params = {"w": np.zeros((3, 4, 5), np.float32), "s": np.zeros((5,), np.float32),
              "c": np.zeros((4, 1), np.float32)}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for j_init, t_init in ((j_adamw_init, adamw_init), (j_adafactor_init, adafactor_init)):
        js = jax.tree.map(np.asarray, j_init(jax.tree.map(jnp.asarray, params)))
        ts = t_init(tparams)
        jl, jpaths = tree.flatten(js)
        tl, tpaths = tree.flatten(ts)
        assert tpaths == jpaths
        assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
        assert [str(t.dtype).split(".")[-1] for t in tl] == [str(j.dtype) for j in jl]


def test_schedule_matches_reference():
    for step in range(20):
        for kw in ({}, dict(warmup=5, total=12), dict(warmup=0, total=7, floor_frac=0.3)):
            np.testing.assert_allclose(warmup_cosine(step, 3e-4, **kw),
                                       float(j_warmup_cosine(jnp.int32(step), 3e-4, **kw)),
                                       rtol=1e-6)


# ------------------------------------------------------------- train step
TRAIN_VARIANTS = [(1, "none"), (2, "none"), (1, "full"), (2, "full")]


@pytest.fixture(scope="module")
def jax_trajectories(pair):
    jcfg, jm, params, cfg, tm, tp = pair
    out = {}
    for k, remat in TRAIN_VARIANTS:
        raw = j_make_train_step(jm, JParallel(remat=remat, microbatch=k), peak_lr=0.5,
                                total_steps=20)
        step = jax.jit(raw)
        p, o = params, raw.opt_init(params)
        losses = []
        for s in range(3):
            p, o, m = step(p, o, _batch(cfg, 20 + s, B_=4)[0], jnp.int32(s + 5))
            losses.append(float(m["loss"]))
        out[(k, remat)] = losses
    return out


@pytest.mark.parametrize("k,remat", TRAIN_VARIANTS)
def test_train_step_matches_reference(pair, jax_trajectories, k, remat):
    jcfg, jm, params, cfg, tm, _ = pair
    step_fn = make_train_step(tm, ParallelConfig(remat=remat, microbatch=k), peak_lr=0.5,
                              total_steps=20)
    p = _port_params(params, cfg)
    o = step_fn.opt_init(p)
    losses = []
    for s in range(3):
        p, o, m = step_fn(p, o, _batch(cfg, 20 + s, B_=4)[1], s + 5)
        losses.append(float(m["loss"]))
        assert not m["loss"].requires_grad and np.isfinite(float(m["grad_norm"]))
    assert not any(t.requires_grad for t in tree.flatten(p)[0])
    want = jax_trajectories[(k, remat)]
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_train_step_refuses_a_batch_the_microbatches_do_not_divide(pair):
    jcfg, jm, params, cfg, tm, tp = pair
    step_fn = make_train_step(tm, ParallelConfig(microbatch=3))
    with pytest.raises(ValueError, match="not divisible by microbatch 3"):
        step_fn(tp, step_fn.opt_init(tp), _batch(cfg, 1, B_=4)[1], 0)


# ------------------------------------------------------------- data stream
@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 1)])
def test_synthetic_stream_tokens_bit_equal(hosts, host):
    jcfg = jconfigs.get_config(ARCH)
    cfg = tconfigs.get_config(ARCH)
    j = JStream(jcfg, batch=4, seq_len=33, data_cfg=JDataConfig(seed=7), host_id=host,
                num_hosts=hosts)
    t = SyntheticLMStream(cfg, batch=4, seq_len=33, data_cfg=DataConfig(seed=7),
                          host_id=host, num_hosts=hosts, device="cpu")
    for step in (0, 5, 123):
        jb, tb = j.batch_at(step), t.batch_at(step)
        for name in ("tokens", "labels"):
            assert tb[name].dtype == torch.int32
            np.testing.assert_array_equal(tb[name].numpy(), np.asarray(jb[name]))
    assert int(t.batch_at(0)["tokens"].max()) < cfg.vocab_size

