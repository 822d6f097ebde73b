"""xlstm-1.3b [ssm] — 48L d2048 4H d_ff=0 v50304 — sLSTM + mLSTM blocks.

Period-8 stacks: 7 mLSTM (matrix memory, chunkwise-parallel) + 1 sLSTM
(scalar memory, sequential scan). d_ff=0: blocks carry their own up/down
projections. O(1) state per token -> runs long_500k. [arXiv:2405.04517]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=512, slstm_period=8,
)
