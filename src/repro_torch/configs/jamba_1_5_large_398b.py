"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) ff24576 v65536.

Mamba + attention at 1:7 interleave (attn every 8th layer), MoE 16e top-2 on
every other layer. Sub-quadratic -> runs long_500k (9 attn layers hold the
KV, sharded over the model axis). [arXiv:2403.19887; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    n_experts=16, top_k=2, expert_d_ff=24576, moe_period=2,
    attn_period=8, ssm_state=16, ssm_conv=4, ssm_expand=2,
)
