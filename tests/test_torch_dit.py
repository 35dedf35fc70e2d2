"""The port's DiT against the JAX reference on the CPU, in f32.

Weights come from ``repro.models.dit.init_params`` and cross over with
``params_from_numpy``; inputs are numpy arrays fed to both packages.
The reduced config runs in f32, so outputs agree to f32 rounding
(stated tolerance 1e-4 absolute on outputs of magnitude ~3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import dit as jdit
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.models import dit as tdit
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-4, atol=1e-4)


def _tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port model): self-attention q/k weights are
    scaled up so attention is peaked and RoPE ``origin`` matters."""
    jcfg = jget_config("wan21-dit-1.3b").reduced()
    params = jdit.init_params(jax.random.PRNGKey(0), jcfg)
    for name in ("q", "k"):
        w = params["blocks"]["self_attn"][name]["w"]
        params["blocks"]["self_attn"][name]["w"] = w * 8.0
    model = tdit.params_from_numpy(_tree(params), get_config("wan21-dit-1.3b").reduced(),
                                   device="cpu")
    return jcfg, params, model


def _inputs(seed=0, shape=(2, 4, 8, 12, 4)):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape).astype(np.float32)
    t = np.array([900.0, 250.0][: shape[0]], np.float32)
    c = (rng.normal(size=(shape[0], 16, 128)) * 0.02).astype(np.float32)
    return z, t, c


@pytest.mark.parametrize("origin", [(0, 0, 0), (2, 3, 1)])
def test_forward_matches_reference(pair, origin):
    jcfg, params, model = pair
    z, t, c = _inputs()
    a = np.asarray(jdit.forward(params, jnp.asarray(z), jnp.asarray(t), jnp.asarray(c),
                                jcfg, origin=origin))
    b = model(torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(c),
              origin=origin).numpy()
    assert b.shape == z.shape and b.dtype == np.float32
    np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("origin", [(0, 0, 0), (2, 3, 1), (7, 0, 12)])
def test_axial_rope_matches_reference(origin):
    """3D RoPE with global coordinates: equal to the reference (1e-5), and
    a nonzero origin really moves the code (the LP case is not vacuous)."""
    grid, D = (4, 4, 6), 32
    q = np.random.default_rng(2).normal(size=(2, 96, 4, D)).astype(np.float32)
    a = np.asarray(jdit._axial_rope(jnp.asarray(q), grid, origin, D))
    rope = tdit._axial_rope_tables(grid, origin, D, "cpu")
    b = tdit._apply_rope(torch.from_numpy(q), rope).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if origin != (0, 0, 0):
        base = tdit._apply_rope(torch.from_numpy(q), tdit._axial_rope_tables(grid, (0, 0, 0), D, "cpu"))
        assert float((base - torch.from_numpy(b)).abs().max()) > 0.1


@pytest.mark.parametrize("shape", [(1, 2, 4, 6, 4), (2, 4, 8, 12, 4)])
def test_patchify_roundtrip_matches_reference(shape):
    cfg = get_config("wan21-dit-1.3b").reduced()
    z = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ja, jgrid = jdit._patchify(jnp.asarray(z), cfg)
    ta, tgrid = tdit._patchify(torch.from_numpy(z), cfg)
    assert tuple(jgrid) == tuple(tgrid) and np.array_equal(np.asarray(ja), ta.numpy())
    back = tdit._unpatchify(ta, tgrid, cfg, z.shape)
    assert np.array_equal(back.numpy(), z)


def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(np.asarray(jl.rmsnorm({"scale": jnp.ones(64)}, jnp.asarray(x))),
                               tl.rmsnorm(xt).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jl.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                jnp.asarray(x))),
        tl.layernorm(xt, torch.from_numpy(scale), torch.from_numpy(bias)).numpy(),
        rtol=1e-5, atol=1e-5)
    w = {n: (rng.normal(size=s) * 0.1).astype(np.float32)
         for n, s in (("wi", (64, 96)), ("wg", (64, 96)), ("wo", (96, 64)))}
    a = np.asarray(jl.mlp({n: {"w": jnp.asarray(v)} for n, v in w.items()}, jnp.asarray(x)))
    b = tl.mlp(*(torch.from_numpy(w[n]) for n in ("wi", "wg", "wo")), xt).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # cos/sin of arguments up to ~1000 rad: XLA and PyTorch reduce the
    # argument differently, ~3e-5 apart in f32
    t = np.array([0.0, 17.5, 999.0], np.float32)
    np.testing.assert_allclose(np.asarray(jl.sinusoidal_embedding(jnp.asarray(t), 256)),
                               tl.sinusoidal_embedding(torch.from_numpy(t), 256).numpy(),
                               rtol=0, atol=1e-4)
    assert np.array_equal(jl.rope_frequencies(42, 1e4), tl.rope_frequencies(42, 1e4))


def test_params_from_numpy_carries_bf16_exactly():
    """A bf16 JAX tree crosses bit for bit, blocks split per layer, no
    transposes: every dense weight keeps its (in, out) shape."""
    jcfg = dataclasses.replace(jget_config("wan21-dit-1.3b").reduced(), dtype="bfloat16")
    params = jdit.init_params(jax.random.PRNGKey(1), jcfg)
    tcfg = dataclasses.replace(get_config("wan21-dit-1.3b").reduced(), dtype="bfloat16")
    model = tdit.params_from_numpy(_tree(params), tcfg, device="cpu")
    assert len(model.blocks) == tcfg.num_layers
    for i, blk in enumerate(model.blocks):
        jw = np.asarray(params["blocks"]["mlp"]["wi"]["w"][i]).astype(np.float32)
        assert blk.mlp_wi.dtype == torch.bfloat16
        assert np.array_equal(blk.mlp_wi.float().numpy(), jw)
        assert np.array_equal(blk.ada_b.numpy(), np.asarray(params["blocks"]["ada_b"][i]))
    assert tuple(model.head.shape) == params["head"]["w"].shape
    assert np.array_equal(model.time_w1.numpy(), np.asarray(params["time_mlp"]["w1"]["w"]))


def test_init_params_draws_reference_distributions():
    cfg = dataclasses.replace(get_config("wan21-dit-1.3b").reduced(), d_ff=1024)
    model = tdit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jdit.init_params(jax.random.PRNGKey(0),
                           dataclasses.replace(jget_config("wan21-dit-1.3b").reduced(),
                                               d_ff=1024))
    # same shapes and dtypes as the reference tree, layer by layer
    assert tuple(model.text_proj.shape) == ref["text_proj"]["w"].shape
    assert tuple(model.blocks[0].mlp_wo.shape) == ref["blocks"]["mlp"]["wo"]["w"].shape[1:]
    w = model.blocks[0].mlp_wo.float()                  # (1024, 128): fan-in 1024
    std = (1.0 / 1024) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.03       # flax-corrected truncated normal
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566 + 1e-6
    blk = model.blocks[1]
    assert float(blk.ada.abs().max()) == 0.0
    expect_b = np.zeros((6, cfg.d_model), np.float32)
    expect_b[2] = expect_b[5] = 1.0
    assert np.array_equal(blk.ada_b.numpy(), expect_b)
    assert np.array_equal(blk.ada_b.numpy(), np.asarray(ref["blocks"]["ada_b"][1]))
    assert not any(p.requires_grad for p in model.parameters())
