"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention
(arXiv:2401.16818).  SWA => sub-quadratic => long_500k runs."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attn_type="swa",
    window=4096,
)
