"""The decoder-only LM (dense GQA, xLSTM or the hybrid) and ``build``.

``TransformerLM`` keeps the JAX package's surface: parameters are a tree
passed to every call, not module state.

    template() / cache_template()      -> P-trees (see models.common)
    forward(params, batch)             -> (logits, aux)
    prefill(params, batch, cache)      -> (last_logits [b, 1, V], cache)
    decode_step(params, tokens, cache) -> (logits [b, V], cache)

Dtypes follow the JAX package: the embedding is cast to ``cfg.dtype``, so
with f32 parameters and ``dtype="bfloat16"`` only the embedding and the
first norm's output are rounded to bf16, and the first product with an
f32 weight promotes the stream back to f32. Logits cover the padded
vocabulary (``cfg.padded_vocab`` columns), as the reference's do.

The model has no ``vocab`` attribute: the engine plane reads
``getattr(model, "vocab", 32)`` for its frame tokens, and the reference
model has none either.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.attention_common import check_impl
from .common import P, count_params, stack_template
from .layers import (einsum, embed, embedding_template, rmsnorm,
                     rmsnorm_template, unembed, unembed_template)
from .transformer import (block_cache_template, block_template, layout,
                          not_ported, stack_apply, stack_decode)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TransformerLM(nn.Module):
    """Decoder-only LM: a dense GQA decoder (qwen2.5-style), the xLSTM
    (periods of mLSTM layers and one sLSTM layer) or the hybrid (jamba:
    periods of one attention and Mamba layers, MoE FFNs on every other
    layer). The port runs on one card, so experts are padded as the
    reference pads them for an expert-parallel degree of 1."""

    def __init__(self, cfg: ModelConfig, impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.impl = impl
        self.period, self.n_periods = layout(cfg)
        self.dtype = DTYPES[cfg.dtype]
        self.ep_pad = cfg.padded_experts(1) or None

    def template(self):
        cfg = self.cfg
        per = {f"p{i}": block_template(cfg, spec, self.ep_pad)
               for i, spec in enumerate(self.period)}
        t = {"embed": embedding_template(cfg.padded_vocab, cfg.d_model),
             "blocks": stack_template(per, self.n_periods),
             "final_norm": rmsnorm_template(cfg.d_model)}
        if not cfg.tie_embeddings:
            t["unembed"] = unembed_template(cfg.d_model, cfg.padded_vocab)
        return t

    def cache_template(self, batch: int, max_len: int, dtype=None):
        per = {f"p{i}": block_cache_template(self.cfg, spec, batch, max_len,
                                             dtype)
               for i, spec in enumerate(self.period)}
        return {"blocks": stack_template(per, self.n_periods),
                "len": P((batch,), ("batch",), init="zeros",
                         dtype=torch.int32)}

    def param_count(self) -> int:
        return count_params(self.template())

    def _logits(self, params, x):
        x = rmsnorm(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return einsum("...d,vd->...v", x, params["embed"]["table"])
        return unembed(params["unembed"], x)

    def forward(self, params, batch):
        if "vision_embeds" in batch:
            raise not_ported("cross")
        x = embed(params["embed"], batch["tokens"]).to(self.dtype)
        x, _, aux = stack_apply(params["blocks"], x, self.cfg, self.period,
                                impl=self.impl)
        return self._logits(params, x), aux

    def prefill(self, params, batch, cache):
        """Prefill ``batch["tokens"]`` [b, s] into ``cache`` (written in
        place at offset 0); returns the last position's logits."""
        tokens = batch["tokens"]
        x = embed(params["embed"], tokens).to(self.dtype)
        x, blocks, _ = stack_apply(params["blocks"], x, self.cfg,
                                   self.period, impl=self.impl,
                                   caches=cache["blocks"])
        new_cache = {"blocks": blocks,
                     "len": torch.full_like(cache["len"], tokens.shape[1])}
        return self._logits(params, x[:, -1:]), new_cache

    def decode_step(self, params, tokens, cache):
        """tokens: [b] -> (logits [b, V], cache); the cache is written in
        place and its ``len`` advanced by one."""
        x = embed(params["embed"], tokens[:, None]).to(self.dtype)
        lens = cache["len"]
        x, blocks = stack_decode(params["blocks"], x, self.cfg, self.period,
                                 cache["blocks"], lens, impl=self.impl)
        new_cache = {"blocks": blocks, "len": lens + 1}
        return self._logits(params, x)[:, 0], new_cache


def build(cfg: ModelConfig, impl: str = "auto") -> TransformerLM:
    """The model of ``cfg``. ``impl`` picks the path of the kernels
    (attention, the mLSTM's prefill and the Mamba layers' selective scan):
    ``auto`` (the CUDA kernels on CUDA tensors, the plain versions on CPU
    ones) or ``torch`` (the plain versions on any device)."""
    check_impl(impl)
    if cfg.enc_layers:
        raise not_ported("cross")
    return TransformerLM(cfg, impl=impl)
