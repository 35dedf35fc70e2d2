"""Deterministic synthetic data, sharded per host (a copy of
``repro/data/pipeline.py``'s LM stream).

Each host draws only its shard of the global batch, seeded by
``(seed, step, host_id)``, so a restart replays the same batches and the
tokens equal the reference's bit for bit.  Token streams follow a
Zipf(1.2) unigram draw.  Not copied: the reference's extra draws for the
VLM and audio families (vision embeddings, audio frames), which go with
those families, and ``latent_noise`` (``jax.random`` noise for video
generation), which nothing on the training path calls (ROADMAP Queue 1
item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLMStream:
    """Infinite deterministic (tokens, labels) stream for one host, as
    int32 tensors on ``device`` (``None`` means ``cuda``)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 data_cfg: DataConfig = DataConfig(), host_id: int = 0, num_hosts: int = 1,
                 device: DeviceLike = None):
        if batch % num_hosts != 0:
            raise ValueError(f"global batch {batch} % hosts {num_hosts} != 0")
        self.cfg = cfg
        self.local_batch = batch // num_hosts
        self.seq_len = seq_len
        self.data_cfg = data_cfg
        self.host_id = host_id
        self.device = resolve_device(device)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.data_cfg.seed, step, self.host_id))

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def batch_at(self, step: int) -> Dict[str, Any]:
        """Batch for a given step: random access enables exact restart."""
        rng = self._rng(step)
        V = max(self.cfg.vocab_size, 2)
        toks = rng.zipf(self.data_cfg.zipf_a, size=(self.local_batch, self.seq_len + 1))
        toks = np.minimum(toks - 1, V - 1).astype(np.int32)
        return {"tokens": self._put(toks[:, :-1]), "labels": self._put(toks[:, 1:])}

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
