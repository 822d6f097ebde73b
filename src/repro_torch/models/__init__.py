"""The port's LMs: every architecture of the JAX package's model zoo (dense
and MoE GQA decoders, MLA, the VLM, the encoder-decoder, the xLSTM and the
hybrid).

``build(cfg, impl=...)`` returns a :class:`registry.TransformerLM` or, for
the encoder-decoder, a :class:`registry.EncDecLM`;
``common.init_params`` materialises its templates on a device and
``convert.params_from_numpy`` carries a JAX parameter tree over.
"""
from . import (attention, common, convert, layers, mla, moe, registry, ssm,
               transformer, xlstm)
from .registry import EncDecLM, TransformerLM, build

__all__ = ["EncDecLM", "TransformerLM", "attention", "build", "common",
           "convert", "layers", "mla", "moe", "registry", "ssm",
           "transformer", "xlstm"]
