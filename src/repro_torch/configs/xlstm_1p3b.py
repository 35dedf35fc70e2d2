"""xlstm-1.3b [ssm]: 48 blocks, 7:1 mLSTM:sLSTM (arXiv:2405.04517)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                # xLSTM blocks carry their own projections
    vocab_size=50304,
    head_dim=512,
    slstm_every=8,         # 6 groups of (7 mLSTM + 1 sLSTM)
)
