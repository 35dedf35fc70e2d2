"""granite-moe-3b-a800m [moe]: 40 experts top-8, d_ff 512/expert
(hf:ibm-granite/granite-3.0-1b-a400m-base).  The assignment's structured
field says 40 experts (trailing comment says 32); the reference implements 40,
padded to 48 for 16-way expert parallelism (``models/transformer._ep_padding``)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=0,
    d_ff_expert=512,
    vocab_size=49155,
    num_experts=40,
    experts_top_k=8,
)
