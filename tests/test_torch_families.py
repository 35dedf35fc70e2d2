"""The port's MoE, VLM and remaining dense LM configs against the JAX
reference, on the CPU.

Each of granite-moe-3b-a800m, llama4-maverick-400b-a17b, internvl2-26b,
h2o-danube-1.8b, minitron-4b and llama3-405b: the config equals the
reference's (full and reduced), and the reduced model, in f32 with the
reference's weights carried over by ``transformer.params_from_numpy``,
matches the reference's forward (with the MoE aux loss), ``Model.loss``,
prefill and decode steps.  Tokens and vision embeddings are made with
numpy.  h2o-danube's sliding-window decode runs past its window.  Stated
tolerances: hidden states, logits, caches and losses 2e-4 + 2e-4 |ref|
(f32, sums in another order); the aux loss 1e-6; the port's own prefill
against its stepped decode (danube and minitron; MoE prefill and decode
route different token sets by design) 3e-2, the reference test's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.models import transformer as jtr
from repro.serving import serve_step as jserve
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.models import frontends
from repro_torch.models import transformer as ttr
from repro_torch.serving import serve_step as tserve

TOL = dict(rtol=2e-4, atol=2e-4)
CONSISTENCY_TOL = dict(rtol=3e-2, atol=3e-2)
NEW = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "internvl2-26b",
       "h2o-danube-1.8b", "minitron-4b", "llama3-405b")
_PAIRS = {}


def _pair(arch):
    """(jax cfg, jax model, jax params, port cfg, port model, port params)
    of the reduced ``arch``, built once."""
    if arch not in _PAIRS:
        jcfg = jconfigs.get_config(arch).reduced()
        jm = jmodels.build(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        cfg = tconfigs.get_config(arch).reduced()
        tm = tmodels.build(cfg, device="cpu")
        tp = ttr.params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
        _PAIRS[arch] = (jcfg, jm, params, cfg, tm, tp)
    return _PAIRS[arch]


def _batch(cfg, B, S, seed):
    """Tokens, labels and (VLM) vision embeddings from numpy, as (jax, port) batches."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    arrays = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "vlm":
        arrays["vision_embeds"] = rng.normal(
            0, 0.02, size=(B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.padded_vocab_size == b.padded_vocab_size and a.head_dim == b.head_dim
        assert jtr._ep_padding(a) == ttr._ep_padding(b)
    if arch == "granite-moe-3b-a800m":
        assert ttr._ep_padding(t) == 8 and ttr._ep_padding(t.reduced()) == 8   # 40 -> 48, 8 -> 16


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-small"])
def test_unported_configs_name_their_roadmap_item(arch):
    jconfigs.get_config(arch)                      # the reference has it
    with pytest.raises(KeyError, match="not ported yet.*item 12"):
        tconfigs.get_config(arch)


@pytest.mark.parametrize("arch", NEW)
def test_forward_and_loss_match_reference(arch):
    jcfg, jm, params, cfg, tm, tp = _pair(arch)
    jb, tb = _batch(cfg, 2, 20, seed=1)
    jh, jaux = jm.forward(params, {k: v for k, v in jb.items() if k != "labels"})
    th, taux = tm.forward(tp, {k: v for k, v in tb.items() if k != "labels"})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    assert (float(taux) > 0) == cfg.is_moe
    np.testing.assert_allclose(float(tm.loss(tp, tb)), float(jm.loss(params, jb)), **TOL)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_steps_match_reference(arch):
    """The prefill step's logits, then 6 decode steps from a zero cache:
    logits at every step and every cache tensor at the end."""
    jcfg, jm, params, cfg, tm, tp = _pair(arch)
    jb, tb = _batch(cfg, 2, 16, seed=2)
    jb.pop("labels"), tb.pop("labels")
    want = np.asarray(jserve.make_prefill_step(jm, jcfg)(params, jb))
    got = tserve.make_prefill_step(tm, cfg)(tp, tb)
    assert tuple(got.shape) == (2, 1, cfg.padded_vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    tok = np.array(jb["tokens"])
    jdec, tdec = jax.jit(jserve.make_decode_step(jm, jcfg)), tserve.make_decode_step(tm, cfg)
    jc, tc = jm.init_cache(2, 10), tm.init_cache(2, 10)
    for t in range(6):
        pos = np.full((2,), t, np.int32)
        jl, jc = jdec(params, {"token": jnp.asarray(tok[:, t:t + 1]),
                               "position": jnp.asarray(pos)}, jc)
        tl, tc = tdec(tp, {"token": torch.from_numpy(tok[:, t:t + 1]),
                           "position": torch.from_numpy(pos)}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


def test_danube_window_decode_past_the_window_matches_reference():
    """h2o-danube (reduced: window 16) decodes 22 steps into a 24-slot
    cache: from step 16 on each query attends only the last 16 slots, the
    reference's sliding-window branch."""
    jcfg, jm, params, cfg, tm, tp = _pair("h2o-danube-1.8b")
    assert cfg.attn_type == "swa" and cfg.window == 16
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 22)).astype(np.int32)
    jc, tc = jm.init_cache(2, 24), tm.init_cache(2, 24)
    jdecode = jax.jit(jm.decode)
    for t in range(22):
        pos = np.array([t, t], np.int32)
        jl, jc = jdecode(params, jnp.asarray(tok[:, t:t + 1]), jc, jnp.asarray(pos))
        tl, tc = tm.decode(tp, torch.from_numpy(tok[:, t:t + 1]), tc, torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL, err_msg=f"step {t}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("arch,S", [("h2o-danube-1.8b", 22), ("minitron-4b", 12)])
def test_prefill_agrees_with_stepped_decode(arch, S):
    """The port's teacher-forced forward against its own stepped decode;
    danube's 22 tokens run past its window of 16."""
    _, _, _, cfg, tm, tp = _pair(arch)
    tok = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, size=(1, S)).astype(np.int64))
    hidden, _ = tm.forward(tp, {"tokens": tok})
    full = ttr.logits_fn(tp, hidden, cfg)
    cache, outs = tm.init_cache(1, S + 2), []
    for t in range(S):
        lg, cache = tm.decode(tp, tok[:, t:t + 1], cache, torch.tensor([t]))
        outs.append(lg)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, 1).numpy(), **CONSISTENCY_TOL)


@pytest.mark.parametrize("reduced", [True, False])
def test_vlm_batch_is_bit_equal_to_reference(reduced):
    """internvl2's ``SyntheticLMStream`` batches: tokens, labels and the
    bf16 (full) or f32 (reduced) vision embeddings drawn after them from
    the same generator, bit for bit."""
    cfg = tconfigs.get_config("internvl2-26b")
    jcfg = jconfigs.get_config("internvl2-26b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    js, ts = JStream(jcfg, batch=2, seq_len=8), SyntheticLMStream(cfg, 2, 8, device="cpu")
    for step in (0, 5):
        jb, tb = js.batch_at(step), ts.batch_at(step)
        assert sorted(jb) == sorted(tb) == ["labels", "tokens", "vision_embeds"]
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        jv, tv = np.asarray(jb["vision_embeds"]), tb["vision_embeds"]
        assert tuple(tv.shape) == (2, cfg.num_vision_tokens, cfg.d_model)
        if reduced:
            np.testing.assert_array_equal(tv.numpy(), jv)
        else:
            assert tv.dtype == torch.bfloat16
            np.testing.assert_array_equal(tv.view(torch.int16).numpy(), jv.view(np.int16))


def test_vision_patches_and_forward_need_vision_embeds():
    cfg = tconfigs.get_config("internvl2-26b").reduced()
    v = frontends.vision_patches(torch.Generator().manual_seed(0), 3, cfg, "cpu")
    assert tuple(v.shape) == (3, cfg.num_vision_tokens, cfg.d_model) and v.dtype == torch.float32
    assert 0.015 < float(v.std()) < 0.025
    _, _, _, _, tm, tp = _pair("internvl2-26b")
    with pytest.raises(ValueError, match="needs vision_embeds"):
        tm.forward(tp, {"tokens": torch.zeros((1, 12), dtype=torch.int64)})
    with pytest.raises(ValueError, match="takes no vision_embeds"):
        _pair("minitron-4b")[4].forward(_pair("minitron-4b")[5],
                                        {"tokens": torch.zeros((1, 12), dtype=torch.int64),
                                         "vision_embeds": v})
