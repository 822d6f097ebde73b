"""Architecture configs the port can build (``get(name)``).

``ARCHS`` holds only the configurations the port serves: the dense GQA
decoder ``qwen2.5-3b``, the xLSTM ``xlstm-1.3b`` and the hybrid
``jamba-1.5-large-398b`` (Mamba + MoE + GQA). The JAX package's
other architectures raise ``NotImplementedError`` naming the ROADMAP item
that ports them; an unknown name raises ``KeyError``.
"""
from . import base
from .base import (ALL_SHAPES, SHAPES, InputShape, MLAConfig, ModelConfig,
                   shape_supported, smoke_shape)
from .jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from .qwen2_5_3b import CONFIG as QWEN25_3B
from .xlstm_1_3b import CONFIG as XLSTM_1_3B

ARCHS = {c.name: c for c in [QWEN25_3B, XLSTM_1_3B, JAMBA_1_5_LARGE]}

# Architectures of the JAX package the port cannot build yet, with the
# ROADMAP item (queue 1 item 10 and the kernel slices) that ports them.
NOT_PORTED = {
    "yi-6b": "dense GQA, not served yet: ROADMAP queue 1 item 10d",
    "yi-34b": "dense GQA, not served yet: ROADMAP queue 1 item 10d",
    "llama-3.2-vision-11b": "VLM cross-attention: ROADMAP queue 1 item 10",
    "dbrx-132b": "MoE serving (its layout, not the MoE layer): ROADMAP "
                 "queue 1 item 10d",
    "qwen2-moe-a2.7b": "MoE serving (its layout and shared experts): "
                       "ROADMAP queue 1 item 10d",
    "minicpm3-4b": "MLA: ROADMAP queue 1 item 10",
    "seamless-m4t-large-v2": "encoder-decoder: ROADMAP queue 1 item 10",
}


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet: "
                                  f"{NOT_PORTED[name]}")
    raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")


__all__ = ["ALL_SHAPES", "ARCHS", "InputShape", "MLAConfig", "ModelConfig",
           "SHAPES", "base", "get", "shape_supported", "smoke_shape"]
