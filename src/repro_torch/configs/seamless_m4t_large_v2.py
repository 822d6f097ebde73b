"""seamless-m4t-large-v2 [audio] — enc-dec 24L d1024 16H ff8192 v256206.

Encoder-decoder; the audio frontend is a STUB (the caller supplies
precomputed frame embeddings, ``audio_embeds``). 24 encoder + 24 decoder
layers; vocab padded 256206 -> 256256 for TP divisibility. [arXiv:2308.11596; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, head_dim=64, enc_layers=24, norm="layernorm",
)
