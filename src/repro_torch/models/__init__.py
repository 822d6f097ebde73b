"""The port's LM: the dense GQA decoder, the xLSTM and the hybrid (jamba)
of the JAX package's model zoo.

``build(cfg, impl=...)`` returns a :class:`registry.TransformerLM`;
``common.init_params`` materialises its templates on a device and
``convert.params_from_numpy`` carries a JAX parameter tree over.
"""
from . import (attention, common, convert, layers, moe, registry, ssm,
               transformer, xlstm)
from .registry import TransformerLM, build

__all__ = ["TransformerLM", "attention", "build", "common", "convert",
           "layers", "moe", "registry", "ssm", "transformer", "xlstm"]
