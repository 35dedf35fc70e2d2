"""Decoder-LM stacks of the port: the dense, MoE and VLM families (granite,
h2o-danube, minitron, llama3; granite-moe, llama4; internvl2) and the
hybrid family (Zamba2).

A port of the dense, MoE, VLM and hybrid branches of
``repro/models/transformer.py``.  Dense: ``num_layers`` pre-norm blocks of
GQA attention (full or sliding window) and a SwiGLU MLP.  MoE: the same
blocks with a top-k mixture of SwiGLU experts (``models/moe.py``) in place
of the MLP, the experts padded up to a multiple of 16 (``_ep_padding``);
``forward`` returns the Switch auxiliary loss summed over the layers.
VLM: a dense stack whose first ``num_vision_tokens`` positions take
projected patch embeddings (``_merge_vision``).  Hybrid: groups of
``attn_every`` Mamba2 blocks,
each group followed by one *shared* attention + MLP block whose q/k/v
projections are adapted per invocation with LoRA.  Parameters are the
reference's tree as nested dicts of tensors, stacked layers included
(dense ``layers`` leaves lead with ``(num_layers,)``, ``mamba`` leaves
with ``(groups, attn_every)``, ``lora`` leaves with ``(groups,)``), so
``params_from_numpy`` carries a reference tree over as it is; the
reference's ``scan`` over stacked layers is a loop over the leaves
unbound once a forward.  ``forward(remat=True)`` checkpoints each scan
body as the reference's ``jax.checkpoint`` does; ``cross_entropy_chunked``
is the training loss.  The xLSTM (``ssm``) family raises
``NotImplementedError`` (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, generator as make_generator, resolve_device
from .attention import decode_attention, gqa_apply, gqa_init
from .dit import _map_tree, _to_tensor, model_dtype
from .layers import (dense, dense_init, embed, embedding_init, mlp, mlp_init, rmsnorm,
                     rmsnorm_init, unembed)
from .moe import moe_apply, moe_init
from .ssm import mamba2_apply, mamba2_decode, mamba2_init, mamba2_init_cache


_PORTED = ("dense", "moe", "vlm", "hybrid")
_BLOCK_FAMILIES = ("dense", "moe", "vlm")     # stacks of lm_block_* layers


def _require_ported(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported; the port's LM stacks are the "
            f"{', '.join(_PORTED)} families (xLSTM and audio: ROADMAP Queue 1 item 12)")


def _unbind(tree):
    """Per-layer trees of a stacked tree (leaves split on their leading
    axis, as views).  Under autograd each leaf's backward stacks the
    per-layer gradients once, where indexing a layer at a time would
    scatter every layer's gradient into a zeroed copy of the whole stack."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _layer_loop(fn, carry, layer_trees, remat: bool):
    """``carry = fn(carry, layer)`` over the layers, each call under
    activation checkpointing when ``remat`` (the reference's
    ``jax.checkpoint`` of the scan body: the layer's activations are
    recomputed in the backward pass)."""
    for layer in layer_trees:
        if remat:
            carry = torch.utils.checkpoint.checkpoint(fn, carry, layer, use_reentrant=False)
        else:
            carry = fn(carry, layer)
    return carry


# ======================================================= dense / moe / vlm
def _ep_padding(cfg: ArchConfig, ep_degree: int = 16) -> int:
    """Padding experts that round the expert count up to a multiple of the
    reference's expert-parallel axis (granite-moe's 40 -> 48)."""
    if cfg.num_experts % ep_degree == 0:
        return 0
    return ep_degree - cfg.num_experts % ep_degree


def lm_block_init(cfg: ArchConfig, generator: torch.Generator, device=None):
    """One block (``repro/models/transformer.py:lm_block_init``): norms,
    GQA projections, then the SwiGLU MLP or, MoE, the router and experts,
    drawn in that order."""
    dt = model_dtype(cfg)
    p = {
        "attn_norm": rmsnorm_init(cfg.d_model, device=device),
        "attn": gqa_init(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         generator, dt, device=device),
        "mlp_norm": rmsnorm_init(cfg.d_model, device=device),
    }
    if cfg.is_moe:
        p["moe"] = moe_init(cfg.d_model, cfg.d_ff_expert, cfg.num_experts, generator, dt,
                            num_padding_experts=_ep_padding(cfg), device=device)
    else:
        p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, generator, dt, device=device)
    return p


def _mlp(cfg: ArchConfig, block, x: torch.Tensor) -> torch.Tensor:
    m = block["mlp"]
    return mlp(m["wi"]["w"], m["wg"]["w"], m["wo"]["w"],
               rmsnorm(x, cfg.norm_eps, block["mlp_norm"]["scale"]))


def _ffn(cfg: ArchConfig, block, x: torch.Tensor):
    """The block's feed-forward half on ``x`` (before its residual) ->
    (output, aux loss): the MoE layer, or the MLP with aux None."""
    if not cfg.is_moe:
        return _mlp(cfg, block, x), None
    return moe_apply(block["moe"], rmsnorm(x, cfg.norm_eps, block["mlp_norm"]["scale"]),
                     cfg.num_experts, cfg.experts_top_k, cfg.capacity_factor)


def _window(cfg: ArchConfig) -> int:
    return cfg.window if cfg.attn_type == "swa" else 0


def lm_block_apply(cfg: ArchConfig, params, x: torch.Tensor, positions: torch.Tensor,
                   kv_chunk: int = 2048):
    """Pre-norm attention and MLP (or MoE) with residuals -> (x, aux: the
    MoE layer's, 0 for an MLP)."""
    h = gqa_apply(params["attn"], rmsnorm(x, cfg.norm_eps, params["attn_norm"]["scale"]),
                  positions, cfg.rope_theta, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                  causal=True, window=_window(cfg), kv_chunk=kv_chunk)
    x = x + h
    y, aux = _ffn(cfg, params, x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def lm_block_decode(cfg: ArchConfig, params, x_t: torch.Tensor, cache, position: torch.Tensor):
    """One decode token through a block; ``cache`` ``{"k", "v"}`` of this
    layer, written in place at ``position`` and returned.  A MoE block
    routes the step's B tokens alone (capacity from T = B, as in the
    reference), and its aux loss is dropped."""
    h, ck, cv = decode_attention(
        params["attn"], rmsnorm(x_t, cfg.norm_eps, params["attn_norm"]["scale"]),
        cache["k"], cache["v"], position, cfg.rope_theta, cfg.num_heads, cfg.num_kv_heads,
        cfg.head_dim, window=_window(cfg))
    x_t = x_t + h
    return x_t + _ffn(cfg, params, x_t)[0], {"k": ck, "v": cv}


# ============================================================ hybrid
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


def _stack_layers(n: int, make):
    """``n`` trees from ``make()``, stacked leaf by leaf on a new leading
    axis as ``_stack`` does, but filled a tree at a time into the stack
    (one layer of a 26 B model's weights in memory beside its stack, not
    all of them twice); one tree is a view with the new axis."""
    first = make()
    if n == 1:
        return _map_tree(lambda t: t.unsqueeze(0), first)
    out = _map_tree(lambda t: t.new_empty((n, *t.shape)), first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


def _index(tree, *idx):
    return _map_tree(lambda t: t[idx], tree)


def zamba_shared_init(cfg: ArchConfig, generator: torch.Generator, device=None):
    dt = model_dtype(cfg)
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, device=device),
        "attn": gqa_init(cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         generator, dt, device=device),
        "mlp_norm": rmsnorm_init(cfg.d_model, device=device),
        "mlp": mlp_init(cfg.d_model, cfg.d_ff, generator, dt, device=device),
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


def zamba_group_apply(cfg: ArchConfig, mamba_stack, shared, lora_g, x: torch.Tensor,
                      positions: torch.Tensor, kv_chunk: int) -> torch.Tensor:
    """``attn_every`` Mamba2 blocks (residual inside the loop, as the
    reference's scan carries ``h + mamba2_apply(h)``) + one shared-attention
    invocation."""
    for layer in _unbind(mamba_stack):
        x = x + mamba2_apply(layer, x, cfg)
    attn = _lora_adapted_attn(shared["attn"], lora_g)
    h = gqa_apply(attn, rmsnorm(x, cfg.norm_eps, shared["attn_norm"]["scale"]), positions,
                  cfg.rope_theta, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                  causal=True, kv_chunk=kv_chunk)
    x = x + h
    return x + _mlp(cfg, shared, x)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights from the reference's distributions
    (``repro/models/transformer.py:init_params``, dense, MoE, VLM and
    hybrid families): the embedding, the layers (a VLM's ``vision_proj``
    after them), the output table.  ``generator`` must live on ``device``;
    by default one seeded with 0."""
    _require_ported(cfg, "init_params")
    device = resolve_device(device)
    if generator is None:
        generator = make_generator(0, device)
    dt = model_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": {"emb": embedding_init(cfg.padded_vocab_size, cfg.d_model, generator, dt,
                                        device)},
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
    }
    if cfg.family in _BLOCK_FAMILIES:
        params["layers"] = _stack_layers(cfg.num_layers,
                                         lambda: lm_block_init(cfg, generator, device))
        if cfg.family == "vlm":
            params["vision_proj"] = {"w": dense_init(cfg.d_model, cfg.d_model, generator, dt,
                                                     device=device)}
    else:
        groups = _zamba_groups(cfg)
        layers = [mamba2_init(cfg.d_model, cfg.ssm_state, cfg.ssm_headdim, generator,
                              cfg.ssm_expand, cfg.ssm_conv, cfg.ssm_groups, dt, device)
                  for _ in range(groups * cfg.attn_every)]
        params["mamba"] = _stack([_stack(layers[g * cfg.attn_every:(g + 1) * cfg.attn_every])
                                  for g in range(groups)])
        del layers
        params["shared"] = zamba_shared_init(cfg, generator, device)
        params["lora"] = _stack([zamba_lora_init(cfg, generator, device)
                                 for _ in range(groups)])
    if not cfg.tie_embeddings:
        params["lm_head"] = {"emb": embedding_init(cfg.padded_vocab_size, cfg.d_model,
                                                   generator, dt, device)}
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter tree (nested dicts of numpy arrays,
    stacked leaves included) as tensors on ``device``, layout unchanged."""
    _require_ported(cfg, "params_from_numpy")
    device = resolve_device(device)
    return _map_tree(lambda a: _to_tensor(np.asarray(a), device), tree)


def _merge_vision(params, x: torch.Tensor, vision_embeds: torch.Tensor) -> torch.Tensor:
    """The VLM's stub frontend: projected patch embeddings ``(B, N_vis, d)``
    replace the first ``N_vis`` positions of the token stream."""
    v = dense(params["vision_proj"]["w"], vision_embeds).to(x.dtype)
    return torch.cat([v, x[:, v.shape[1]:, :]], dim=1)


def forward(params, tokens: torch.Tensor, cfg: ArchConfig,
            vision_embeds: Optional[torch.Tensor] = None, kv_chunk: int = 2048,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (final hidden ``(B, S, d)``, aux loss: the
    MoE layers' summed, else 0).  A VLM needs ``vision_embeds``; the other
    families take none.  ``remat``: each layer (dense, MoE, VLM) or group
    (hybrid) under activation checkpointing, recomputed in the backward
    pass."""
    _require_ported(cfg, "forward")
    if cfg.family == "vlm" and vision_embeds is None:
        raise ValueError("forward: the vlm family needs vision_embeds")
    if cfg.family != "vlm" and vision_embeds is not None:
        raise ValueError(f"forward: the {cfg.family} family takes no vision_embeds")
    B, S = tokens.shape
    # the reference's actctx.shard_* calls (here and in the blocks) are
    # identities off a mesh; the port leaves them out
    x = embed(params["embed"]["emb"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    if cfg.family == "vlm":
        x = _merge_vision(params, x, vision_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_moe:
        def body(carry, layer):
            h, a = lm_block_apply(cfg, layer, carry[0], positions, kv_chunk)
            return h, carry[1] + a

        x, aux = _layer_loop(body, (x, aux), _unbind(params["layers"]), remat)
    elif cfg.family in _BLOCK_FAMILIES:
        def body(h, layer):
            return lm_block_apply(cfg, layer, h, positions, kv_chunk)[0]

        x = _layer_loop(body, x, _unbind(params["layers"]), remat)
    else:
        def body(h, group):
            return zamba_group_apply(cfg, group[0], params["shared"], group[1], h,
                                     positions, kv_chunk)

        x = _layer_loop(body, x, zip(_unbind(params["mamba"]), _unbind(params["lora"])),
                        remat)
    return rmsnorm(x, cfg.norm_eps, params["final_norm"]["scale"]), aux


def _mask_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.padded_vocab_size == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab_size, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


def _head(params, cfg: ArchConfig) -> torch.Tensor:
    return (params["embed"] if cfg.tie_embeddings else params["lm_head"])["emb"]


def logits_fn(params, hidden: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """f32 logits over the padded vocab; padded columns are -1e30."""
    return _mask_vocab(unembed(_head(params, cfg), hidden), cfg)


def cross_entropy_chunked(params, hidden: torch.Tensor, labels: torch.Tensor,
                          cfg: ArchConfig, seq_chunk: int = 512) -> torch.Tensor:
    """Mean token NLL over labels ``>= 0`` without materializing ``(B, S,
    V)`` logits: ``seq_chunk`` positions at a time, f32 logits as
    ``logits_fn`` (the padded vocab masked), a ragged end padded with label
    -1.  The f32 copy of the output table is made once, not per chunk."""
    B, S, _ = hidden.shape
    n = -(-S // seq_chunk)
    pad = n * seq_chunk - S
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    table = _head(params, cfg).float()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        h = hidden[:, i * seq_chunk:(i + 1) * seq_chunk]
        lab = labels[:, i * seq_chunk:(i + 1) * seq_chunk]
        logits = _mask_vocab(torch.matmul(h.float(), table.t()), cfg)      # (B, c, V) f32
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lab.clamp_min(0).long()[..., None])[..., 0]
        valid = (lab >= 0).float()
        tot = tot + ((logz - gold) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / cnt.clamp_min(1.0)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zeroed decode cache: the attention k/v ``(batch, max_len, KV, D)``
    of every dense, MoE or VLM layer, or, hybrid, per Mamba2 block its conv and SSM
    states (f32) and per group the shared attention's k/v."""
    _require_ported(cfg, "init_cache")
    device = resolve_device(device)
    dt = model_dtype(cfg)
    kv = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.family in _BLOCK_FAMILIES:
        return {"k": torch.zeros((cfg.num_layers, *kv), dtype=dt, device=device),
                "v": torch.zeros((cfg.num_layers, *kv), dtype=dt, device=device)}
    g = _zamba_groups(cfg)
    m = mamba2_init_cache(batch, cfg, device=device)
    return {
        "mamba": {k: v[None, None].repeat(g, cfg.attn_every, *([1] * v.ndim))
                  for k, v in m.items()},
        "k": torch.zeros((g, *kv), dtype=dt, device=device),
        "v": torch.zeros((g, *kv), dtype=dt, device=device),
    }


def decode_step(params, token: torch.Tensor, cache: Dict[str, Any], position: torch.Tensor,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step -> (logits ``(B, 1, V)`` f32, cache).  The cache is
    updated in place and returned (the reference returns new arrays): each
    layer's (dense, MoE, VLM) or group's (hybrid) k/v are written at
    ``position``,
    each Mamba2 block's conv/SSM state overwritten with its new value."""
    _require_ported(cfg, "decode_step")
    x = embed(params["embed"]["emb"], token)
    if cfg.family in _BLOCK_FAMILIES:
        for li, layer in enumerate(_unbind(params["layers"])):
            x, _ = lm_block_decode(cfg, layer, x, {"k": cache["k"][li], "v": cache["v"][li]},
                                   position)
    else:
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
            x = x + _mlp(cfg, shared, x)
    h = rmsnorm(x, cfg.norm_eps, params["final_norm"]["scale"])
    return logits_fn(params, h, cfg), cache
