"""dbrx-132b [moe] — 40L d6144 48H (GQA kv=8) ff10752 v100352, 16e top-4.

Fine-grained MoE in every layer. [hf:databricks/dbrx-base; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, head_dim=128, rope_theta=500000.0,
    n_experts=16, top_k=4, expert_d_ff=10752, moe_period=1,
)
