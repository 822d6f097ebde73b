"""qwen2-moe-a2.7b [moe] — 24L d2048 16H (kv=16) expert-ff1408 v151936.

4 shared + 60 routed experts, top-4, every layer. QKV bias (Qwen1.5 family).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=151936, head_dim=128, qkv_bias=True, rope_theta=1e6,
    n_experts=60, top_k=4, n_shared_experts=4, expert_d_ff=1408,
    moe_period=1,
)
