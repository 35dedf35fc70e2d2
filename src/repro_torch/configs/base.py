"""Architecture and shape configs (a copy of ``repro.configs.base``).

The port keeps its own copy so that it runs without the JAX package;
``tests/test_torch_geometry.py`` and ``tests/test_torch_lm.py`` hold the
two copies equal.  Kept: ``ArchConfig`` with ``reduced()`` and
``padded_vocab_size``, ``ShapeConfig``, ``LM_SHAPES``, ``VDM_SHAPES`` and
the train step's three fields of ``ParallelConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture.  Unused family fields stay at their defaults."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | vdm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention
    attn_type: str = "full"          # full | swa
    window: int = 4096               # SWA window
    rope_theta: float = 10_000.0

    # mixture of experts
    num_experts: int = 0
    experts_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (zamba2)
    attn_every: int = 0
    lora_rank: int = 0

    # xLSTM
    slstm_every: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # VLM frontend stub
    num_vision_tokens: int = 0

    # VDM / DiT
    latent_channels: int = 0
    patch_sizes: Tuple[int, int, int] = (1, 2, 2)
    context_len: int = 512           # encoded text prompt length
    context_dim: int = 0             # cross-attention context width
    time_embed_dim: int = 256

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: num_heads {self.num_heads} not divisible by "
                f"kv heads {self.num_kv_heads}"
            )

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference pads so the
        tables shard evenly; padded logit columns are masked to -1e30 in
        ``logits_fn``)."""
        return -(-self.vocab_size // 256) * 256

    def reduced(self) -> "ArchConfig":
        """Same-family config small enough for a CPU test (f32)."""
        changes = dict(
            dtype="float32",
            num_layers=min(self.num_layers, 4 if self.attn_every else 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads < self.num_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 16),
            context_len=min(self.context_len, 16),
        )
        if self.is_moe:
            changes.update(
                num_experts=min(self.num_experts, 8),
                experts_top_k=min(self.experts_top_k, 2),
                d_ff_expert=64,
            )
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_headdim=16)
        if self.attn_every:
            changes.update(attn_every=2, lora_rank=4, num_layers=4)
        if self.slstm_every:
            changes.update(slstm_every=2, num_layers=4, num_heads=2,
                           num_kv_heads=2, head_dim=64)
        if self.is_encoder_decoder:
            changes.update(encoder_layers=2, encoder_seq=32)
        if self.num_vision_tokens:
            changes.update(num_vision_tokens=8)
        if self.family == "vdm":
            changes.update(
                latent_channels=4,
                context_dim=128,
                time_embed_dim=32,
                num_layers=2,
            )
        return dataclasses.replace(self, name=self.name + "-reduced", **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    kind: str          # train | prefill | decode | vdm_generate
    seq_len: int = 0
    global_batch: int = 0
    num_frames: int = 0
    height: int = 480
    width: int = 832
    num_steps: int = 60

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four LM shapes of the reference (identical across its LM archs).
LM_SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k": ShapeConfig("decode_32k", "decode", seq_len=32768, global_batch=128),
    "long_500k": ShapeConfig("long_500k", "decode", seq_len=524288, global_batch=1),
}

# The paper's own workload shapes (WAN2.1 @ 480p).
VDM_SHAPES = {
    "vdm_3s": ShapeConfig("vdm_3s", "vdm_generate", num_frames=49, global_batch=1),
    "vdm_5s": ShapeConfig("vdm_5s", "vdm_generate", num_frames=81, global_batch=1),
    "vdm_10s": ShapeConfig("vdm_10s", "vdm_generate", num_frames=161, global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The train step's settings: the reference's ``ParallelConfig``
    without its mesh axes, which name nothing on one device."""

    remat: str = "none"                          # none | full | dots
    microbatch: int = 1                          # gradient-accumulation steps
    optimizer: str = "adamw"                     # adamw | adafactor
