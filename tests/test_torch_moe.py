"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
reference (``repro/models/moe.py``), on the CPU in f32.

Inputs and router noise are drawn with numpy from fixed seeds; the
weights are the reference's, carried over as they are.  Routing is held
exactly: each token's chosen experts and the kept / dropped pairs must be
equal.  ``jax.lax.top_k`` and ``torch.topk`` may order an exact tie
differently, so each case asserts that no token's k-th and (k+1)-th router
probabilities are within 1e-6 of each other: the seeds were picked only so
that none is.  Stated tolerances: outputs and gradients 2e-4 + 2e-4 |ref|
(f32, the same products summed in another order), the auxiliary loss
1e-6.  Two backward passes must be bit-equal.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

TOL = dict(rtol=2e-4, atol=2e-4)
D_MODEL, D_FF = 32, 16

# (name, batch, seq, real experts, padding experts, top_k, router noise, seed)
CASES = [
    ("no_drops", 4, 256, 8, 0, 2, False, 0),         # C = 320: 256 pairs an expert on average
    ("decode_drops", 4, 1, 40, 8, 8, True, 0),       # T = B = 4: C = 1, shared experts drop
    ("padded_noise", 2, 40, 8, 8, 2, True, 1),       # granite-moe's 8 -> 16 padding
    ("top1_drops", 1, 48, 8, 8, 1, False, 2),        # llama4's top-1, C = 8
]
IDS = [c[0] for c in CASES]


@functools.lru_cache(maxsize=None)
def _case(name, B, S, E, pad, k, noise, seed):
    """The case's reference weights, the same as tensors (callers clone
    before they write), its input and router noise; built once."""
    params = jmoe.moe_init(jax.random.PRNGKey(seed), D_MODEL, D_FF, E, jnp.float32,
                           num_padding_experts=pad)
    rng = np.random.default_rng(seed + 10)
    x = rng.normal(size=(B, S, D_MODEL)).astype(np.float32)
    nz = rng.normal(size=(B * S, E + pad)).astype(np.float32) if noise else None
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return params, tp, x, nz


@jax.jit
def _reference_routing_arrays(router_w, xt, noise, num_real, k):
    """The reference's routing, step by step as ``repro/models/moe.py:
    moe_apply`` computes it (``num_real`` and ``k`` as zero arrays of that
    length, so their sizes stay static): the router probabilities, each
    token's top-k experts, and the sorted pairs with their kept flags."""
    E, k = num_real.shape[0], k.shape[0]
    T, E_total = xt.shape[0], router_w.shape[1]
    logits = jnp.einsum("td,de->te", xt, router_w)
    logits = jnp.where((jnp.arange(E_total) >= E)[None, :], -1e30, logits) + noise
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    C = int(math.ceil(T * k / E * 1.25))
    flat_e = top_e.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(T), k)
    order = jnp.argsort(flat_e)
    e_sorted, t_sorted = flat_e[order], flat_t[order]
    counts = jnp.zeros(E_total, jnp.int32).at[e_sorted].add(1)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]])
    return probs, top_e, e_sorted, t_sorted, jnp.arange(T * k) - offsets[e_sorted] < C


def _reference_routing(params, x, E, k, nz):
    """Each token's top-k experts (sorted) and the set of kept (token,
    expert) pairs, by the reference's routing."""
    xt = x.reshape(x.shape[0] * x.shape[1], -1)
    noise = np.zeros((xt.shape[0], params["router"]["w"].shape[1]), np.float32) \
        if nz is None else nz
    probs, top_e, e_sorted, t_sorted, keep = (np.asarray(a) for a in _reference_routing_arrays(
        params["router"]["w"], jnp.asarray(xt), jnp.asarray(noise), jnp.zeros(E), jnp.zeros(k)))
    kept = {(int(t), int(e)) for t, e, ok in zip(t_sorted, e_sorted, keep) if ok}
    return probs, np.sort(top_e, axis=1), kept


def _port_routing(tp, x, E, k, nz):
    T = x.shape[0] * x.shape[1]
    E_total = tp["wi"]["w"].shape[0]
    probs = tmoe.router_probs(tp, torch.from_numpy(x.reshape(T, -1)), E,
                              None if nz is None else torch.from_numpy(nz))
    _, top_e = torch.topk(probs, k, dim=-1)
    C = tmoe.capacity(T, E, k, 1.25)
    perm, pair_row, keep, row_pair, filled = tmoe.route(top_e, E_total, C)
    experts = top_e.gather(1, perm)
    kept = {(t, int(experts[t, j])) for t in range(T) for j in range(k) if keep[t * k + j]}
    # the two index maps are each other's inverse on the kept pairs
    assert int(filled.sum()) == int(keep.sum()) == len(kept)
    assert torch.equal(row_pair[pair_row[keep]], torch.nonzero(keep)[:, 0])
    return experts.numpy(), kept


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_moe_routing_is_exactly_the_reference(case):
    name, B, S, E, pad, k, noise, seed = case
    params, tp, x, nz = _case(*case)
    probs, j_experts, j_kept = _reference_routing(params, x, E, k, nz)
    srt = np.sort(probs, axis=1)[:, ::-1]
    if k < probs.shape[1]:       # no near-tie at the cut (see the module docstring)
        assert (srt[:, k - 1] - srt[:, k]).min() > 1e-6, name
    t_experts, t_kept = _port_routing(tp, x, E, k, nz)
    np.testing.assert_array_equal(t_experts, j_experts)
    assert t_kept == j_kept
    assert all(e < E for _, e in t_kept)                   # padding experts never chosen
    T = B * S
    dropped = T * k - len(t_kept)
    assert (dropped == 0) == (name == "no_drops"), dropped
    if name == "decode_drops":                             # C = 1: one pair an expert
        assert tmoe.capacity(T, E, k, 1.25) == 1
        assert len({e for _, e in t_kept}) == len(t_kept)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_moe_apply_matches_reference(case):
    name, B, S, E, pad, k, noise, seed = case
    params, tp, x, nz = _case(*case)
    jy, jaux = jax.jit(jmoe.moe_apply, static_argnums=(2, 3, 4))(
        params, jnp.asarray(x), E, k, 1.25, None if nz is None else jnp.asarray(nz))
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), E, k, 1.25,
                              None if nz is None else torch.from_numpy(nz))
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)


def _port_grads(tp, x, r, E, k):
    leaves = {n: tp[n]["w"].clone().requires_grad_() for n in ("router", "wi", "wg", "wo")}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply({n: {"w": w} for n, w in leaves.items()}, xt, E, k, 1.25)
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    return {"x": xt.grad, **{n: w.grad for n, w in leaves.items()}}


@pytest.mark.parametrize("case", [CASES[0], CASES[2]], ids=[IDS[0], IDS[2]])
def test_moe_gradients_match_reference_and_repeat_bit_equal(case):
    """d(sum(y * r) + aux) for the input and every leaf against
    ``jax.grad``; a second backward pass gives the same bits."""
    name, B, S, E, pad, k, noise, seed = case
    params, tp, x, _ = _case(*case)
    r = np.random.default_rng(seed + 20).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, E, k, 1.25)
        return (y * jnp.asarray(r)).sum() + aux

    jp, jx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    got = _port_grads(tp, x, r, E, k)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(jx), **TOL)
    for n in ("router", "wi", "wg", "wo"):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(jp[n]["w"]), **TOL, err_msg=n)
    again = _port_grads(tp, x, r, E, k)
    assert all(torch.equal(got[n], again[n]) for n in got)


def test_moe_init_shapes_and_scale():
    """The reference's tree and distributions: the f32 router (d, E), the
    expert stacks (E, d, f) / (E, f, d) drawn an expert at a time, each at
    the fan-in scale of its input width."""
    g = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(64, 48, 6, g, torch.float32, num_padding_experts=2)
    assert p["router"]["w"].shape == (64, 8) and p["router"]["w"].dtype == torch.float32
    assert p["wi"]["w"].shape == p["wg"]["w"].shape == (8, 64, 48)
    assert p["wo"]["w"].shape == (8, 48, 64)
    for name, fan_in in (("wi", 64), ("wo", 48)):
        w = p[name]["w"]
        assert abs(float(w.std()) * math.sqrt(fan_in) - 1.0) < 0.05, name
        assert float(w.abs().max()) <= 2.0 / math.sqrt(fan_in) / 0.87962566 + 1e-6
        assert not torch.equal(w[0], w[1])
    jp = jmoe.moe_init(jax.random.PRNGKey(0), 64, 48, 6, jnp.float32, num_padding_experts=2)
    assert {n: tuple(v["w"].shape) for n, v in jp.items()} == \
        {n: tuple(v["w"].shape) for n, v in p.items()}
