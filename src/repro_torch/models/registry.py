"""The decoder-only LM, the encoder-decoder and ``build``.

``TransformerLM`` covers the dense, MoE, MLA, VLM, xLSTM and hybrid
decoders (any period layout); ``EncDecLM`` covers seamless-m4t (a stub
audio encoder input, a non-causal encoder and a causal decoder with
cross-attention). Both keep the JAX package's surface: parameters are a
tree passed to every call, not module state.

    template() / cache_template()      -> P-trees (see models.common)
    forward(params, batch)             -> (logits, aux)
    loss(params, batch)                -> scalar (cross-entropy + 0.01 aux)
    prefill(params, batch, cache)      -> (last_logits [b, 1, V], cache)
    decode_step(params, tokens, cache) -> (logits [b, V], cache)

``batch`` holds ``tokens`` and, for the stub modalities, precomputed
frontend outputs: ``vision_embeds`` [b, n_vision_tokens, d] (the VLM) or
``audio_embeds`` [b, frames, d] (the encoder-decoder).

Dtypes follow the JAX package: the embedding is cast to ``cfg.dtype``, so
with f32 parameters and ``dtype="bfloat16"`` only the embedding and the
first norm's output are rounded to bf16, and the first product with an
f32 weight promotes the stream back to f32. Logits cover the padded
vocabulary (``cfg.padded_vocab`` columns), as the reference's do.

The models have no ``vocab`` attribute: the engine plane reads
``getattr(model, "vocab", 32)`` for its frame tokens, and the reference
models have none either.

Under a mesh (``sharding.ctx.activation_rules`` with a mesh, as
``launch.specs.plan_cell`` runs them) every call takes this rank's slices
of the parameters (the FSDP dims gathered: ``sharding.rules.gathered``),
batch and cache, and returns its slice of the logits (the local vocab
columns). Every family runs there: the decode cache's rows split over an
axis where the rules put ``cache_seq`` (``models.attention``,
``models.mla``), a cross layer's source rows where that axis divides
them. A division the rules cannot resolve raises. ``forward``,
``prefill`` and ``encode`` run their stacks under
``sharding.ctx.sequence_parallel``: with ``{"act_seq": AXIS}`` in the
rules the residual stream between sublayers is the rank's block of the
sequence (the embedding's output reduce-scattered onto it, the stream
gathered again for the unembedding, the prefill's last token and the
encoder's output); the outputs are the unsharded model's.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.attention_common import check_impl
from ..sharding import ctx as shard_ctx
from .attention import cache_rows_axis
from .common import VOCAB, P, count_params, stack_template
from .layers import (einsum, embed, embedding_template, softmax_xent,
                     unembed, unembed_template)
from . import ssm
from .mla import cache_rows_axis as mla_cache_rows_axis
from .transformer import (block_cache_template, block_template, layout,
                          norm, norm_template, stack_apply, stack_decode)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The mLSTM prefill mixer's plain forms (the JAX package's ``mlstm_impl``
# values that run no kernel): "ref", the parallel form (or, under
# impl="auto" on the card, the kernel of the same function), and
# "chunkwise", ``mlstm_chunkwise_xla``.
MLSTM_IMPLS = ("ref", "chunkwise")
# The Mamba layers' full-sequence scan (the JAX package's ``ssm_impl``
# values that run no kernel): "ref", the ``selective_scan`` wrapper, and
# "chunked", ``selective_scan_chunked`` (``models.ssm``).
SSM_IMPLS = ssm.SSM_IMPLS


def _check_mlstm_impl(mlstm_impl: str) -> None:
    if mlstm_impl not in MLSTM_IMPLS:
        raise ValueError(f"mlstm_impl={mlstm_impl!r} not in {MLSTM_IMPLS}")


def _stacked_block_template(cfg, period, n_periods, ep_pad):
    per = {f"p{i}": block_template(cfg, spec, ep_pad)
           for i, spec in enumerate(period)}
    return stack_template(per, n_periods)


def _stacked_cache_template(cfg, period, n_periods, batch, max_len,
                            kv_source_len, dtype=None):
    per = {f"p{i}": block_cache_template(cfg, spec, batch, max_len,
                                         kv_source_len, dtype)
           for i, spec in enumerate(period)}
    return stack_template(per, n_periods)


def _len_template(batch: int):
    return P((batch,), ("batch",), init="zeros", dtype=torch.int32)


class TransformerLM(nn.Module):
    """Decoder-only LM: a dense or MoE GQA decoder, MLA, the VLM (periods
    of self-attention layers and one cross-attention layer to the vision
    embeddings), the xLSTM (periods of mLSTM layers and one sLSTM layer)
    or the hybrid (jamba: periods of one attention and Mamba layers, MoE
    FFNs on every other layer). Experts are padded to a multiple of the
    expert-parallel degree ``ep_degree``, as the reference pads them."""

    def __init__(self, cfg: ModelConfig, impl: str = "auto",
                 ssm_impl: str = "ref", mlstm_impl: str = "ref",
                 ep_degree: int = 1):
        super().__init__()
        _check_mlstm_impl(mlstm_impl)
        ssm.check_ssm_impl(ssm_impl)
        self.cfg = cfg
        self.impl = impl
        self.ssm_impl = ssm_impl
        self.mlstm_impl = mlstm_impl
        self.period, self.n_periods = layout(cfg)
        self.dtype = DTYPES[cfg.dtype]
        self.ep_pad = cfg.padded_experts(ep_degree) or None

    def template(self):
        cfg = self.cfg
        t = {"embed": embedding_template(cfg.padded_vocab, cfg.d_model),
             "blocks": _stacked_block_template(cfg, self.period,
                                               self.n_periods, self.ep_pad),
             "final_norm": norm_template(cfg)}
        if not cfg.tie_embeddings:
            t["unembed"] = unembed_template(cfg.d_model, cfg.padded_vocab)
        return t

    def cache_template(self, batch: int, max_len: int, dtype=None):
        cfg = self.cfg
        kv_src = cfg.n_vision_tokens if cfg.family == "vlm" else max_len
        return {"blocks": _stacked_cache_template(cfg, self.period,
                                                  self.n_periods, batch,
                                                  max_len, kv_src, dtype),
                "len": _len_template(batch)}

    def param_count(self) -> int:
        return count_params(self.template())

    def cache_rows_axis(self, rules: dict):
        """The mesh axis the self-attention caches' rows split over under
        ``rules`` (the GQA cache's or MLA's latent cache's placement), or
        None, also where no layer has one (the xLSTM)."""
        mixers = {spec.mixer for spec in self.period}
        if "mla" in mixers:
            return mla_cache_rows_axis(rules)
        if "attn" in mixers:
            return cache_rows_axis(self.cfg.n_kv_heads, rules)
        return None

    def _logits(self, params, x):
        cfg = self.cfg
        x = norm(cfg, params["final_norm"], x)
        if cfg.tie_embeddings:
            table = params["embed"]["table"]
            axis, _ = shard_ctx.split(VOCAB, table.shape[0],
                                      cfg.padded_vocab)
            x = shard_ctx.enter_stream(x, axis)
            return einsum("...d,vd->...v", x, table)
        return unembed(params["unembed"], x, vocab=cfg.padded_vocab)

    def _embed(self, params, tokens):
        return embed(params["embed"], tokens,
                     vocab=self.cfg.padded_vocab).to(self.dtype)

    def _vision(self, batch):
        kv = batch.get("vision_embeds")
        return None if kv is None else kv.to(self.dtype)

    def forward(self, params, batch):
        with shard_ctx.sequence_parallel(batch["tokens"].shape[1]):
            x = self._embed(params, batch["tokens"])
            x, _, aux = stack_apply(params["blocks"], x, self.cfg,
                                    self.period,
                                    kv_embeds=self._vision(batch),
                                    impl=self.impl,
                                    mlstm_impl=self.mlstm_impl,
                                    ssm_impl=self.ssm_impl)
            return self._logits(params, x), aux

    def loss(self, params, batch):
        """Cross-entropy over the real vocabulary (``batch["labels"]``)
        plus 0.01 times the MoE layers' load-balancing loss."""
        logits, aux = self.forward(params, batch)
        return softmax_xent(logits, batch["labels"], self.cfg.vocab,
                            vocab=self.cfg.padded_vocab) + 0.01 * aux

    def prefill(self, params, batch, cache):
        """Prefill ``batch["tokens"]`` [b, s] into ``cache`` (written in
        place at offset 0; a cross layer's cache takes the vision
        embeddings' keys and values); returns the last position's
        logits."""
        tokens = batch["tokens"]
        with shard_ctx.sequence_parallel(tokens.shape[1]):
            x = self._embed(params, tokens)
            x, blocks, _ = stack_apply(params["blocks"], x, self.cfg,
                                       self.period,
                                       kv_embeds=self._vision(batch),
                                       impl=self.impl,
                                       mlstm_impl=self.mlstm_impl,
                                       ssm_impl=self.ssm_impl,
                                       caches=cache["blocks"])
            x = shard_ctx.stream_gather(x)
        new_cache = {"blocks": blocks,
                     "len": torch.full_like(cache["len"], tokens.shape[1])}
        return self._logits(params, x[:, -1:]), new_cache

    def decode_step(self, params, tokens, cache):
        """tokens: [b] -> (logits [b, V], cache); the cache is written in
        place and its ``len`` advanced by one."""
        x = self._embed(params, tokens[:, None])
        lens = cache["len"]
        x, blocks = stack_decode(params["blocks"], x, self.cfg, self.period,
                                 cache["blocks"], lens,
                                 src_len=self.cfg.n_vision_tokens,
                                 impl=self.impl)
        new_cache = {"blocks": blocks, "len": lens + 1}
        return self._logits(params, x)[:, 0], new_cache


class EncDecLM(nn.Module):
    """Encoder-decoder (seamless-m4t): a projection of precomputed audio
    frame embeddings, a non-causal encoder stack and its norm, then a
    causal text decoder whose every layer cross-attends to the encoder's
    output. The decoder's caches hold the encoder's keys and values
    (``enc_len`` rows, the encoder's frames)."""

    def __init__(self, cfg: ModelConfig, impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.impl = impl
        self.enc_period, self.enc_n = layout(cfg, role="encoder")
        self.dec_period, self.dec_n = layout(cfg, role="decoder")
        self.dtype = DTYPES[cfg.dtype]

    def template(self):
        cfg = self.cfg
        return {
            "enc_in": {"w": P((cfg.d_model, cfg.d_model),
                              ("embed", "embed"))},
            "enc_blocks": _stacked_block_template(cfg, self.enc_period,
                                                  self.enc_n, None),
            "enc_norm": norm_template(cfg),
            "embed": embedding_template(cfg.padded_vocab, cfg.d_model),
            "dec_blocks": _stacked_block_template(cfg, self.dec_period,
                                                  self.dec_n, None),
            "final_norm": norm_template(cfg),
            "unembed": unembed_template(cfg.d_model, cfg.padded_vocab),
        }

    def cache_template(self, batch: int, max_len: int, dtype=None,
                       enc_len: int | None = None):
        enc_len = enc_len or max_len
        return {"blocks": _stacked_cache_template(self.cfg, self.dec_period,
                                                  self.dec_n, batch, max_len,
                                                  enc_len, dtype),
                "len": _len_template(batch)}

    def param_count(self) -> int:
        return count_params(self.template())

    def cache_rows_axis(self, rules: dict):
        """The mesh axis the decoder's self-attention caches' rows split
        over under ``rules``, or None."""
        return cache_rows_axis(self.cfg.n_kv_heads, rules)

    def encode(self, params, audio_embeds):
        """audio_embeds [b, frames, d] -> the encoder's output [b, frames,
        d]: self-attention over all frames (non-causal)."""
        x = einsum("bsd,de->bse", audio_embeds.to(self.dtype),
                   params["enc_in"]["w"])
        with shard_ctx.sequence_parallel(x.shape[1]):
            x = shard_ctx.stream_split(x)
            x, _, _ = stack_apply(params["enc_blocks"], x, self.cfg,
                                  self.enc_period, causal=False,
                                  impl=self.impl)
            x = shard_ctx.stream_gather(x)
        return norm(self.cfg, params["enc_norm"], x)

    def _logits(self, params, x):
        x = norm(self.cfg, params["final_norm"], x)
        return unembed(params["unembed"], x, vocab=self.cfg.padded_vocab)

    def _embed(self, params, tokens):
        return embed(params["embed"], tokens,
                     vocab=self.cfg.padded_vocab).to(self.dtype)

    def forward(self, params, batch):
        enc = self.encode(params, batch["audio_embeds"])
        with shard_ctx.sequence_parallel(batch["tokens"].shape[1]):
            x = self._embed(params, batch["tokens"])
            x, _, aux = stack_apply(params["dec_blocks"], x, self.cfg,
                                    self.dec_period, kv_embeds=enc,
                                    impl=self.impl)
            return self._logits(params, x), aux

    def loss(self, params, batch):
        """Cross-entropy over the real vocabulary (``batch["labels"]``)
        plus 0.01 times the aux loss (0: the encoder-decoder has no
        MoE)."""
        logits, aux = self.forward(params, batch)
        return softmax_xent(logits, batch["labels"], self.cfg.vocab,
                            vocab=self.cfg.padded_vocab) + 0.01 * aux

    def prefill(self, params, batch, cache):
        """Encode ``batch["audio_embeds"]``, then prefill ``batch["tokens"]``
        [b, s] into ``cache`` (in place: the self-attention caches at
        offset 0, every layer's encoder cache whole); returns the last
        position's logits."""
        enc = self.encode(params, batch["audio_embeds"])
        tokens = batch["tokens"]
        with shard_ctx.sequence_parallel(tokens.shape[1]):
            x = self._embed(params, tokens)
            x, blocks, _ = stack_apply(params["dec_blocks"], x, self.cfg,
                                       self.dec_period, kv_embeds=enc,
                                       impl=self.impl, caches=cache["blocks"])
            x = shard_ctx.stream_gather(x)
        new_cache = {"blocks": blocks,
                     "len": torch.full_like(cache["len"], tokens.shape[1])}
        return self._logits(params, x[:, -1:]), new_cache

    def decode_step(self, params, tokens, cache, enc_len=None):
        """tokens: [b] -> (logits [b, V], cache); the cache is written in
        place and its ``len`` advanced by one. ``enc_len``: the encoder's
        frames the cache holds (its ``cache_template``'s) over all ranks,
        needed under a mesh, where a rank's cross caches may hold only its
        block of them (``plan_cell``'s decode step passes its own)."""
        x = self._embed(params, tokens[:, None])
        lens = cache["len"]
        x, blocks = stack_decode(params["dec_blocks"], x, self.cfg,
                                 self.dec_period, cache["blocks"], lens,
                                 src_len=enc_len, impl=self.impl)
        new_cache = {"blocks": blocks, "len": lens + 1}
        return self._logits(params, x)[:, 0], new_cache


def build(cfg: ModelConfig, impl: str = "auto", ssm_impl: str = "ref",
          mlstm_impl: str = "ref", ep_degree: int = 1):
    """The model of ``cfg``: an ``EncDecLM`` when it has encoder layers,
    else a ``TransformerLM``. ``impl`` picks the path of the kernels
    (attention, the mLSTM's prefill and, under ``ssm_impl="ref"``, the
    Mamba layers' selective scan): ``auto`` (the CUDA kernels on CUDA
    tensors, the plain versions on CPU ones) or ``torch`` (the plain
    versions on any device). The kernels have no backward pass: train with
    ``impl="torch"``. ``ssm_impl`` (``SSM_IMPLS``) is the JAX package's
    argument of that name: ``"ref"`` runs the Mamba scan through
    ``selective_scan`` (the kernel, or the per-token plain loop, as
    ``impl`` picks), ``"chunked"`` as ``selective_scan_chunked`` whatever
    ``impl`` is. Its default is "ref", where the JAX package's is
    "chunked": a default of "chunked" would take the kernel off every
    Mamba prefill on the card. The trainer, ``plan_cell``'s train plans
    and the dry run pass "chunked", as the JAX package's do by default.
    ``mlstm_impl`` (``MLSTM_IMPLS``) is the JAX package's argument of that
    name: ``"chunkwise"`` runs the mLSTM prefill as
    ``mlstm_chunkwise_xla`` whatever ``impl`` is. ``ep_degree``: the
    expert-parallel degree the experts are padded for
    (``cfg.padded_experts``; the mesh's data extent under a plan)."""
    check_impl(impl)
    ssm.check_ssm_impl(ssm_impl)
    _check_mlstm_impl(mlstm_impl)
    if cfg.enc_layers:
        return EncDecLM(cfg, impl=impl)
    return TransformerLM(cfg, impl=impl, ssm_impl=ssm_impl,
                         mlstm_impl=mlstm_impl, ep_degree=ep_degree)
