"""Serve-step factories of the LM: prefill (full-sequence forward ->
last-token logits) and decode (one token against the KV/state cache).
A port of the LM branch of ``repro/serving/serve_step.py`` for the dense,
MoE, VLM (the prefill batch carries ``vision_embeds``), hybrid and ssm
(xLSTM) families; the audio (encoder-decoder) branch is not ported
(ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import logits_fn


def _require_lm(cfg: ArchConfig) -> None:
    if cfg.family == "audio":
        raise NotImplementedError(
            "serve_step: the audio (encoder-decoder) family is not ported "
            "(ROADMAP Queue 1 item 12)")


def make_prefill_step(model, cfg: ArchConfig) -> Callable:
    """``prefill(params, {"tokens": (B, S)[, "vision_embeds": (B, N_vis,
    d)]}) -> logits (B, 1, V)`` in f32 (a VLM needs ``vision_embeds``)."""
    _require_lm(cfg)

    def prefill(params, batch):
        hidden, _ = model.forward(params, batch)
        return logits_fn(params, hidden[:, -1:, :], cfg)

    return prefill


def make_decode_step(model, cfg: ArchConfig) -> Callable:
    """``decode(params, {"token": (B, 1), "position": (B,)}, cache) ->
    (logits (B, 1, V) f32, cache)``."""
    _require_lm(cfg)

    def decode(params, batch, cache):
        return model.decode(params, batch["token"], cache, batch["position"])

    return decode
