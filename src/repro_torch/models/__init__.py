"""Models of the port: the video DiT and the dense, MoE, VLM and hybrid LMs.

``build(cfg, device=None)`` returns a ``Model`` with the reference's API
(``repro/models/__init__.py``), bound to one device (``None`` means
``cuda``, and raises without a card):

  init(key)                          -> params   (key: an int seed or a
                                                  torch.Generator on the device)
  forward(params, batch, **kw)       -> (hidden or noise-pred, aux)
  loss(params, batch, remat, kv_chunk) -> scalar NLL + 0.01 aux (LM; aux is
                                          the MoE layers' Switch loss, else 0)
  init_cache(batch, max_len)         -> decode cache (LM)
  decode(params, token, cache, pos)  -> (logits, cache) (LM)

Families: ``dense`` (granite, h2o-danube, minitron, llama3), ``moe``
(granite-moe, llama4), ``vlm`` (internvl2: a batch carries
``vision_embeds``) and ``hybrid`` (Zamba2), all ``transformer``, and
``vdm`` (``dit``, whose params are the ``DiT`` module).  The xLSTM
(``ssm``) and audio families are not ported (ROADMAP Queue 1 item 12).
On the card the LM losses differentiate through hand-written kernels:
attention through ``kernels.ops.FlashAttention``, the hybrid family's SSD
scan through ``kernels.ops.MambaSSD`` (``mamba_ssd_bwd``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, generator as make_generator, resolve_device
from . import attention, dit, frontends, layers, moe, ssm, transformer  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable
    forward: Callable
    loss: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    decode: Optional[Callable] = None


def _generator(key: Union[int, torch.Generator], device: torch.device) -> torch.Generator:
    return key if isinstance(key, torch.Generator) else make_generator(int(key), device)


def build(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    device = resolve_device(device)
    fam = cfg.family
    if fam in transformer._PORTED:
        def loss_fn(params, batch, remat=False, kv_chunk=2048):
            hidden, aux = transformer.forward(
                params, batch["tokens"], cfg, vision_embeds=batch.get("vision_embeds"),
                kv_chunk=kv_chunk, remat=remat)
            nll = transformer.cross_entropy_chunked(params, hidden, batch["labels"], cfg)
            return nll + 0.01 * aux

        return Model(
            cfg=cfg, device=device,
            init=lambda key: transformer.init_params(cfg, _generator(key, device), device),
            forward=lambda p, batch, **kw: transformer.forward(
                p, batch["tokens"], cfg, vision_embeds=batch.get("vision_embeds"), **kw),
            loss=loss_fn,
            init_cache=lambda b, m: transformer.init_cache(cfg, b, m, device),
            decode=lambda p, tok, cache, pos: transformer.decode_step(p, tok, cache, pos, cfg),
        )
    if fam == "vdm":
        return Model(
            cfg=cfg, device=device,
            init=lambda key: dit.init_params(cfg, _generator(key, device), device),
            forward=lambda p, batch, **kw: (
                p(batch["latent"], batch["t"], batch["context"], **kw),
                torch.zeros((), dtype=torch.float32, device=device)),
        )
    raise NotImplementedError(
        f"build: family {fam!r} is not ported (xLSTM and audio: ROADMAP Queue 1 item 12)")
