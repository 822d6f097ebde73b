"""Architecture configs (``get(name)``): the port's copies of the JAX
package's ten, an unknown name raises ``KeyError``.

The dense GQA decoders ``qwen2.5-3b``, ``yi-6b`` and ``yi-34b``; the MoE
decoders ``qwen2-moe-a2.7b`` and ``dbrx-132b``; ``minicpm3-4b`` (MLA); the
VLM ``llama-3.2-vision-11b`` (cross-attention to precomputed patch
embeddings); the encoder-decoder ``seamless-m4t-large-v2``; the xLSTM
``xlstm-1.3b``; and the hybrid ``jamba-1.5-large-398b`` (Mamba + MoE +
GQA).
"""
from . import base
from .base import (ALL_SHAPES, SHAPES, InputShape, MLAConfig, ModelConfig,
                   shape_supported, smoke_shape)
from .dbrx_132b import CONFIG as DBRX_132B
from .jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from .llama_3_2_vision_11b import CONFIG as LLAMA_32_VISION_11B
from .minicpm3_4b import CONFIG as MINICPM3_4B
from .qwen2_5_3b import CONFIG as QWEN25_3B
from .qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A27B
from .seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T_LARGE_V2
from .xlstm_1_3b import CONFIG as XLSTM_1_3B
from .yi_34b import CONFIG as YI_34B
from .yi_6b import CONFIG as YI_6B

ARCHS = {c.name: c for c in [
    LLAMA_32_VISION_11B, DBRX_132B, QWEN2_MOE_A27B, YI_34B, QWEN25_3B,
    YI_6B, MINICPM3_4B, XLSTM_1_3B, JAMBA_1_5_LARGE, SEAMLESS_M4T_LARGE_V2,
]}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ALL_SHAPES", "ARCHS", "InputShape", "MLAConfig", "ModelConfig",
           "SHAPES", "base", "get", "shape_supported", "smoke_shape"]
