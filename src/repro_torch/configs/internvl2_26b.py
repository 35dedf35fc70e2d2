"""internvl2-26b [vlm]: InternLM2-20B backbone; InternViT frontend is a
stub providing precomputed patch embeddings (arXiv:2404.16821)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    num_vision_tokens=256,
)
