"""llama4-maverick-400b-a17b [moe]: 128 experts top-1, early fusion
(hf:meta-llama/Llama-4-Scout-17B-16E).  Spec implemented verbatim; note
48L x 128e x d_ff 8192 gives ~776B total params."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=0,
    d_ff_expert=8192,
    vocab_size=202048,
    head_dim=128,
    num_experts=128,
    experts_top_k=1,
)
