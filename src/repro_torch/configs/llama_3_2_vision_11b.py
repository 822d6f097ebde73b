"""llama-3.2-vision-11b [vlm] — 40L d4096 32H (GQA kv=8) ff14336 v128256.

Cross-attention image layers every 5th layer; the vision frontend is a STUB:
the caller supplies precomputed patch embeddings (``vision_embeds``).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=500000.0,
    cross_attn_period=5, n_vision_tokens=1601,
)
