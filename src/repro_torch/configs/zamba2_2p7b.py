"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks + shared attention block invoked
every 6 blocks through per-invocation LoRA (Zyphra's Zamba2-2.7B,
arXiv:2411.15242)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,       # MHA in the shared block
    d_ff=10240,            # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    attn_every=6,          # 9 shared-attn invocations
    lora_rank=128,
)
