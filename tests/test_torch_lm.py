"""The port's hybrid LM (Zamba2) against the JAX reference, on the CPU.

The reduced zamba2 config runs in f32 with the reference's weights,
carried over by ``transformer.params_from_numpy``, after LoRA ``b`` (zero
at init) is set to nonzero values from a seed so the per-invocation
adapters matter.  Tokens are made with numpy.  Stated tolerances:
hidden states, logits and caches 2e-4 + 2e-4 |ref| (f32, sums in another
order through 4 Mamba2 blocks and 2 attention invocations); the port's
own prefill against its stepped decode 3e-2, the reference test's
(``tests/test_models_smoke.py:132``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro.serving import serve_step as jserve
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.serving import serve_step as tserve

TOL = dict(rtol=2e-4, atol=2e-4)
CONSISTENCY_TOL = dict(rtol=3e-2, atol=3e-2)


def test_configs_equal():
    j, t = jconfigs.get_config("zamba2-2.7b"), tconfigs.get_config("zamba2-2.7b")
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.padded_vocab_size == b.padded_vocab_size
    assert t.head_dim == 80


@pytest.mark.parametrize("name", sorted(jconfigs.base.LM_SHAPES))
def test_lm_shapes_equal(name):
    j, t = jconfigs.get_shape(name), tconfigs.get_shape(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.is_decode == t.is_decode


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port model, port params)."""
    jcfg = jconfigs.get_config("zamba2-2.7b").reduced()
    jm = jmodels.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for nm in ("q", "k", "v"):
        b = params["lora"][nm]["b"]["w"]
        params["lora"][nm]["b"]["w"] = jnp.asarray(
            rng.normal(size=b.shape).astype(np.float32) * 0.05)
    cfg = tconfigs.get_config("zamba2-2.7b").reduced()
    tm = tmodels.build(cfg, device="cpu")
    tp = ttr.params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, jm, params, cfg, tm, tp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("B,S", [(2, 16), (1, 70)])
def test_forward_matches_reference(pair, B, S):
    jcfg, jm, params, cfg, tm, tp = pair
    tok = _tokens(cfg, B, S, seed=S)
    jh, _ = jm.forward(params, {"tokens": jnp.asarray(tok)})
    th, aux = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    assert th.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_prefill_step_matches_reference(pair):
    jcfg, jm, params, cfg, tm, tp = pair
    tok = _tokens(cfg, 2, 24, seed=1)
    want = np.asarray(jserve.make_prefill_step(jm, jcfg)(params, {"tokens": jnp.asarray(tok)}))
    got = tserve.make_prefill_step(tm, cfg)(tp, {"tokens": torch.from_numpy(tok).long()})
    assert tuple(got.shape) == (2, 1, cfg.padded_vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_steps_match_reference(pair):
    """8 decode steps from a zero cache, logits and every cache tensor."""
    jcfg, jm, params, cfg, tm, tp = pair
    B, max_len = 2, 12
    tok = _tokens(cfg, B, 8, seed=2)
    jdec, tdec = jserve.make_decode_step(jm, jcfg), tserve.make_decode_step(tm, cfg)
    jc, tc = jm.init_cache(B, max_len), tm.init_cache(B, max_len)
    assert jax.tree.map(lambda a: a.shape, jc) == ttr._map_tree(lambda t: tuple(t.shape), tc)
    for t in range(8):
        pos = np.full((B,), t, np.int32)
        jl_, jc = jdec(params, {"token": jnp.asarray(tok[:, t:t + 1]),
                                "position": jnp.asarray(pos)}, jc)
        tl_, tc = tdec(tp, {"token": torch.from_numpy(tok[:, t:t + 1]).long(),
                            "position": torch.from_numpy(pos)}, tc)
        assert tl_.dtype == torch.float32
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    for path, v in flat:
        node = tc
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(v), **TOL)


def test_prefill_agrees_with_stepped_decode(pair):
    """The port's own teacher-forced forward against its stepped decode."""
    _, _, _, cfg, tm, tp = pair
    tok = torch.from_numpy(_tokens(cfg, 1, 8, seed=3)).long()
    hidden, _ = tm.forward(tp, {"tokens": tok})
    full = ttr.logits_fn(tp, hidden, cfg)
    cache = tm.init_cache(1, 8)
    outs = []
    for t in range(8):
        lg, cache = tm.decode(tp, tok[:, t:t + 1], cache, torch.tensor([t]))
        outs.append(lg)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(), **CONSISTENCY_TOL)


def test_logits_mask_padded_vocab(pair):
    """A vocab that is not a multiple of 256 gets -1e30 in the padded
    columns, as the reference's ``logits_fn``."""
    jcfg, _, params, cfg, _, tp = pair
    jc2 = dataclasses.replace(jcfg, vocab_size=500)
    tc2 = dataclasses.replace(cfg, vocab_size=500)
    h = np.random.default_rng(0).normal(size=(1, 3, cfg.d_model)).astype(np.float32)
    want = np.asarray(jtr.logits_fn(params, jnp.asarray(h), jc2))
    got = ttr.logits_fn(tp, torch.from_numpy(h), tc2).numpy()
    assert (got[..., 500:] == -1e30).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window_branch", [False, True])
def test_gqa_and_decode_attention_match_reference(window_branch):
    rng = np.random.default_rng(11)
    d, H, KV, D, B, S = 64, 4, 2, 16, 2, 10
    p = jattn.gqa_init(jax.random.PRNGKey(1), d, H, KV, D, jnp.float32)
    tp = ttr._map_tree(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, p))
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = np.asarray(jattn.gqa_apply(p, jnp.asarray(x), jnp.asarray(pos), 1e4, H, KV, D))
    got = tattn.gqa_apply(tp, torch.from_numpy(x), torch.from_numpy(pos), 1e4, H, KV, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ck = rng.normal(size=(B, 16, KV, D)).astype(np.float32)
    cv = rng.normal(size=(B, 16, KV, D)).astype(np.float32)
    position = np.array([3, 9], np.int32)
    xt = x[:, :1]
    if window_branch:
        with pytest.raises(NotImplementedError, match="item 12"):
            tattn.decode_attention(tp, torch.from_numpy(xt), torch.from_numpy(ck),
                                   torch.from_numpy(cv), torch.from_numpy(position),
                                   1e4, H, KV, D, window=4)
        return
    jy, jk, jv = jattn.decode_attention(p, jnp.asarray(xt), jnp.asarray(ck), jnp.asarray(cv),
                                        jnp.asarray(position), 1e4, H, KV, D)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ty, tk2, tv2 = tattn.decode_attention(tp, torch.from_numpy(xt), tk, tv,
                                          torch.from_numpy(position), 1e4, H, KV, D)
    assert tk2 is tk and tv2 is tv                   # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("position", [(3, 16), (16, 20), (-1, 5), (-3, -20)])
def test_decode_attention_outside_the_cache_matches_reference(position):
    """A position at or past ``S_max`` (16 slots) or below 0: the
    reference's ``dynamic_update_slice`` counts a negative start from the
    end, clamps the write into the cache and keeps ``kv_len = position +
    1``; the port writes the same slot and attends the same keys.  Where the reference attends no key
    (kv_len <= 0) both give the same NaN or value, compared with
    ``equal_nan``."""
    rng = np.random.default_rng(13)
    d, H, KV, D, B, S_max = 64, 4, 2, 16, 2, 16
    p = jattn.gqa_init(jax.random.PRNGKey(2), d, H, KV, D, jnp.float32)
    tp = ttr._map_tree(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, p))
    xt = rng.normal(size=(B, 1, d)).astype(np.float32)
    ck = rng.normal(size=(B, S_max, KV, D)).astype(np.float32)
    cv = rng.normal(size=(B, S_max, KV, D)).astype(np.float32)
    pos = np.array(position, np.int32)
    jy, jk, jv = jattn.decode_attention(p, jnp.asarray(xt), jnp.asarray(ck), jnp.asarray(cv),
                                        jnp.asarray(pos), 1e4, H, KV, D)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ty, _, _ = tattn.decode_attention(tp, torch.from_numpy(xt), tk, tv, torch.from_numpy(pos),
                                      1e4, H, KV, D)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    changed = np.nonzero((np.asarray(jk) != ck).any(axis=(2, 3)))
    slots = np.clip(np.where(pos < 0, pos + S_max, pos), 0, S_max - 1)
    assert changed[1].tolist() == slots.tolist()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), equal_nan=True, **TOL)


def test_lm_layers_match_reference():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), **TOL)
    conv = {"w": rng.normal(size=(4, 12)).astype(np.float32),
            "b": rng.normal(size=(12,)).astype(np.float32)}
    tconv = {k: torch.from_numpy(v) for k, v in conv.items()}
    jconv = {k: jnp.asarray(v) for k, v in conv.items()}
    seq = rng.normal(size=(2, 9, 12)).astype(np.float32)
    np.testing.assert_allclose(tl.causal_conv1d(tconv, torch.from_numpy(seq)).numpy(),
                               np.asarray(jl.causal_conv1d(jconv, jnp.asarray(seq))), **TOL)
    state = rng.normal(size=(2, 3, 12)).astype(np.float32)
    ty, ts = tl.causal_conv1d_update(tconv, torch.from_numpy(seq[:, 0]), torch.from_numpy(state))
    jy, js = jl.causal_conv1d_update(jconv, jnp.asarray(seq[:, 0]), jnp.asarray(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    # unembed keeps f32 logits for bf16 inputs (no rounding to bf16)
    h = torch.from_numpy(rng.normal(size=(2, 3, 32)).astype(np.float32)).bfloat16()
    emb = torch.from_numpy(rng.normal(size=(50, 32)).astype(np.float32)).bfloat16()
    logits = tl.unembed(emb, h)
    assert logits.dtype == torch.float32
    want = np.asarray(jl.unembed({"emb": jnp.asarray(emb.float().numpy(), jnp.bfloat16)},
                                 jnp.asarray(h.float().numpy(), jnp.bfloat16)))
    assert want.dtype == np.float32
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-5)


def test_clip_regime_matches_reference(pair):
    """Steep decays (dt_bias 3, so dt ~ 3 and up to 48 nats a token) take
    |cum - centre| past the scan's +-60 clip.  There the reference's
    chunked prefill departs from its own recurrent decode; the port
    reproduces both sides of that gap (the reference's function), which
    is what the chip smoke's ``small_lm`` meets at full width with random
    weights (ROADMAP, reference caveats)."""
    jcfg, jm, params, cfg, tm, _ = pair
    steep = jax.tree.map(lambda a: a, params)
    steep["mamba"]["dt_bias"] = jnp.full_like(params["mamba"]["dt_bias"], 3.0)
    tp = ttr.params_from_numpy(jax.tree.map(np.asarray, steep), cfg, device="cpu")
    tok = _tokens(cfg, 1, 8, seed=6)
    jh, _ = jm.forward(steep, {"tokens": jnp.asarray(tok)})
    jfull = np.asarray(jtr.logits_fn(steep, jh, jcfg))
    th, _ = tm.forward(tp, {"tokens": torch.from_numpy(tok).long()})
    tfull = ttr.logits_fn(tp, th, cfg).numpy()
    np.testing.assert_allclose(tfull, jfull, **TOL)
    jc, tc, jout, tout = jm.init_cache(1, 8), tm.init_cache(1, 8), [], []
    for t in range(8):
        lg, jc = jm.decode(steep, jnp.asarray(tok[:, t:t + 1]), jc, jnp.array([t], jnp.int32))
        jout.append(np.asarray(lg))
        lg, tc = tm.decode(tp, torch.from_numpy(tok[:, t:t + 1]).long(), tc, torch.tensor([t]))
        tout.append(lg.numpy())
    jdec, tdec = np.concatenate(jout, 1), np.concatenate(tout, 1)
    np.testing.assert_allclose(tdec, jdec, **TOL)
    jgap, tgap = np.abs(jfull - jdec).max(), np.abs(tfull - tdec).max()
    assert jgap > CONSISTENCY_TOL["atol"] and abs(tgap - jgap) <= 1e-3 * jgap + 1e-4
