"""minicpm3-4b [dense] — 62L d2560 40H (kv=40) ff6400 v73448 — MLA.

Multi-head latent attention: KV compressed to a 256-d latent + 32 shared
rope dims; decode uses the absorbed-matmul form (see models/mla.py).
[hf:openbmb/MiniCPM3-4B; hf]
"""
from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, head_dim=64, attn_type="mla",
    mla=MLAConfig(q_lora=768, kv_lora=256, nope_dim=64, rope_dim=32,
                  v_dim=64),
)
