"""Decoder-LM stack of the port: the hybrid family (Zamba2) only.

A port of the hybrid branches of ``repro/models/transformer.py``: groups
of ``attn_every`` Mamba2 blocks, each group followed by one *shared*
attention + MLP block whose q/k/v projections are adapted per invocation
with LoRA.  Parameters are the reference's tree as nested dicts of
tensors, stacked layers included (``mamba`` leaves lead with
``(groups, attn_every)``, ``lora`` leaves with ``(groups,)``); the
reference's ``scan`` over stacked layers is a loop that indexes them, so
``params_from_numpy`` carries a reference tree over as it is.  The other
families (dense, MoE, VLM, xLSTM) raise ``NotImplementedError``
(ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, generator as make_generator, resolve_device
from .attention import decode_attention, gqa_apply, gqa_init
from .dit import _map_tree, _to_tensor, model_dtype
from .layers import dense_init, embed, embedding_init, mlp, rmsnorm, unembed
from .ssm import mamba2_apply, mamba2_decode, mamba2_init, mamba2_init_cache


def _require_hybrid(cfg: ArchConfig, what: str) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported; the port's LM stack is the "
            "hybrid (zamba2) family only (ROADMAP Queue 1 item 12)")


def _zamba_groups(cfg: ArchConfig) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not group by "
                         f"attn_every {cfg.attn_every}")
    return cfg.num_layers // cfg.attn_every


def _stack(trees):
    """Stack a list of equal trees leaf by leaf on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, *idx):
    return _map_tree(lambda t: t[idx], tree)


def zamba_shared_init(cfg: ArchConfig, generator: torch.Generator, device=None):
    dt = model_dtype(cfg)
    return {
        "attn_norm": {"scale": torch.ones((cfg.d_model,), device=device)},
        "attn": gqa_init(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         generator, dt, device=device),
        "mlp_norm": {"scale": torch.ones((cfg.d_model,), device=device)},
        "mlp": {nm: {"w": dense_init(i, o, generator, dt, device=device)}
                for nm, (i, o) in (("wi", (cfg.d_model, cfg.d_ff)),
                                   ("wg", (cfg.d_model, cfg.d_ff)),
                                   ("wo", (cfg.d_ff, cfg.d_model)))},
    }


def zamba_lora_init(cfg: ArchConfig, generator: torch.Generator, device=None):
    """Per-invocation LoRA on the shared block's q/k/v projections
    (``b`` starts at zero, as in the reference)."""
    dt = model_dtype(cfg)
    out = {}
    for nm in ("q", "k", "v"):
        heads = cfg.num_heads if nm == "q" else cfg.num_kv_heads
        out[nm] = {
            "a": {"w": dense_init(cfg.d_model, cfg.lora_rank, generator, dt, device=device)},
            "b": {"w": torch.zeros((cfg.lora_rank, heads * cfg.head_dim), dtype=dt,
                                   device=device)},
        }
    return out


def _lora_adapted_attn(shared_attn, lora):
    """Shared projections plus the low-rank per-invocation deltas, added to
    the weights (``a @ b`` in the weight dtype), once per group call."""
    adapted = dict(shared_attn)
    for nm in ("q", "k", "v"):
        w = shared_attn[nm]["w"]
        adapted[nm] = {"w": w + torch.matmul(lora[nm]["a"]["w"], lora[nm]["b"]["w"]).to(w.dtype)}
    return adapted


def _shared_mlp(cfg: ArchConfig, shared, x: torch.Tensor) -> torch.Tensor:
    m = shared["mlp"]
    return mlp(m["wi"]["w"], m["wg"]["w"], m["wo"]["w"],
               rmsnorm(x, cfg.norm_eps, shared["mlp_norm"]["scale"]))


def zamba_group_apply(cfg: ArchConfig, mamba_stack, shared, lora_g, x: torch.Tensor,
                      positions: torch.Tensor, kv_chunk: int) -> torch.Tensor:
    """``attn_every`` Mamba2 blocks (residual inside the loop, as the
    reference's scan carries ``h + mamba2_apply(h)``) + one shared-attention
    invocation."""
    for li in range(cfg.attn_every):
        x = x + mamba2_apply(_index(mamba_stack, li), x, cfg)
    attn = _lora_adapted_attn(shared["attn"], lora_g)
    h = gqa_apply(attn, rmsnorm(x, cfg.norm_eps, shared["attn_norm"]["scale"]), positions,
                  cfg.rope_theta, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                  causal=True, kv_chunk=kv_chunk)
    x = x + h
    return x + _shared_mlp(cfg, shared, x)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights from the reference's distributions
    (``repro/models/transformer.py:init_params``, hybrid family).
    ``generator`` must live on ``device``; by default one seeded with 0."""
    _require_hybrid(cfg, "init_params")
    device = resolve_device(device)
    if generator is None:
        generator = make_generator(0, device)
    dt = model_dtype(cfg)
    groups = _zamba_groups(cfg)
    params: Dict[str, Any] = {
        "embed": {"emb": embedding_init(cfg.padded_vocab_size, cfg.d_model, generator, dt,
                                        device)},
        "final_norm": {"scale": torch.ones((cfg.d_model,), device=device)},
    }
    layers = [mamba2_init(cfg.d_model, cfg.ssm_state, cfg.ssm_headdim, generator,
                          cfg.ssm_expand, cfg.ssm_conv, cfg.ssm_groups, dt, device)
              for _ in range(groups * cfg.attn_every)]
    params["mamba"] = _stack([_stack(layers[g * cfg.attn_every:(g + 1) * cfg.attn_every])
                              for g in range(groups)])
    del layers
    params["shared"] = zamba_shared_init(cfg, generator, device)
    params["lora"] = _stack([zamba_lora_init(cfg, generator, device) for _ in range(groups)])
    if not cfg.tie_embeddings:
        params["lm_head"] = {"emb": embedding_init(cfg.padded_vocab_size, cfg.d_model,
                                                   generator, dt, device)}
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's hybrid parameter tree (nested dicts of numpy
    arrays, stacked ``mamba`` and ``lora`` leaves included) as tensors on
    ``device``, layout unchanged."""
    _require_hybrid(cfg, "params_from_numpy")
    device = resolve_device(device)
    return _map_tree(lambda a: _to_tensor(np.asarray(a), device), tree)


def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            vision_embeds: Optional[torch.Tensor] = None, kv_chunk: int = 2048,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (final hidden ``(B, S, d)``, aux loss 0).
    ``remat`` (the reference's gradient checkpointing) changes nothing
    here: the port computes no gradients."""
    _require_hybrid(cfg, "forward")
    if vision_embeds is not None:
        raise ValueError("forward: the hybrid family takes no vision_embeds")
    B, S = tokens.shape
    # the reference's actctx.shard_* calls (here and in the blocks) are
    # identities off a mesh; the port leaves them out
    x = embed(params["embed"]["emb"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    for gi in range(_zamba_groups(cfg)):
        x = zamba_group_apply(cfg, _index(params["mamba"], gi), params["shared"],
                              _index(params["lora"], gi), x, positions, kv_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(x, cfg.norm_eps, params["final_norm"]["scale"]), aux


def logits_fn(params, hidden: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """f32 logits over the padded vocab; padded columns are -1e30."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = unembed(table["emb"], hidden)
    if cfg.padded_vocab_size != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab_size, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    return logits


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zeroed decode cache: per Mamba2 block its conv and SSM states (f32),
    per group the shared attention's k/v ``(batch, max_len, KV, D)``."""
    _require_hybrid(cfg, "init_cache")
    device = resolve_device(device)
    dt = model_dtype(cfg)
    g = _zamba_groups(cfg)
    kv_shape = (g, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    m = mamba2_init_cache(batch, cfg, device=device)
    return {
        "mamba": {k: v[None, None].repeat(g, cfg.attn_every, *([1] * v.ndim))
                  for k, v in m.items()},
        "k": torch.zeros(kv_shape, dtype=dt, device=device),
        "v": torch.zeros(kv_shape, dtype=dt, device=device),
    }


def decode_step(params, token: torch.Tensor, cache: Dict[str, Any], position: torch.Tensor,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step -> (logits ``(B, 1, V)`` f32, cache).  The cache is
    updated in place and returned (the reference returns new arrays):
    each block's conv/SSM state is overwritten with its new value and
    the group's k/v are written at ``position``."""
    _require_hybrid(cfg, "decode_step")
    x = embed(params["embed"]["emb"], token)
    shared = params["shared"]
    for gi in range(_zamba_groups(cfg)):
        for li in range(cfg.attn_every):
            mc = _index(cache["mamba"], gi, li)
            out, new = mamba2_decode(_index(params["mamba"], gi, li), x, mc, cfg)
            for k in mc:
                mc[k].copy_(new[k])
            x = x + out
        attn = _lora_adapted_attn(shared["attn"], _index(params["lora"], gi))
        a, _, _ = decode_attention(
            attn, rmsnorm(x, cfg.norm_eps, shared["attn_norm"]["scale"]),
            cache["k"][gi], cache["v"][gi], position, cfg.rope_theta, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim)
        x = x + a
        x = x + _shared_mlp(cfg, shared, x)
    h = rmsnorm(x, cfg.norm_eps, params["final_norm"]["scale"])
    return logits_fn(params, h, cfg), cache
