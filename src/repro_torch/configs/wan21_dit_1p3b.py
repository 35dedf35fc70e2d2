"""wan21-dit-1.3b [vdm]: the paper's own model (WAN2.1-1.3B, arXiv:2503.20314):
30 DiT blocks, d 1536, 12 heads, ffn 8960, patchify (1,2,2), latent C=16,
VAE stride (4,8,8), T5 text context (stubbed as precomputed embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="wan21-dit-1.3b",
    family="vdm",
    num_layers=30,
    d_model=1536,
    num_heads=12,
    num_kv_heads=12,
    d_ff=8960,
    vocab_size=0,
    head_dim=128,
    latent_channels=16,
    patch_sizes=(1, 2, 2),
    context_len=512,
    context_dim=4096,      # umT5-xxl width
    time_embed_dim=1536,
)
