"""Blocks and the layer stack of every architecture: dense and MoE GQA
decoders, MLA, the VLM's cross-attention layers, the encoder-decoder's
encoder and decoder (LayerNorm, GELU MLP, a cross-attention sublayer),
the xLSTM and the hybrid (jamba: attention, Mamba and MoE).

Every architecture of the JAX package is a *period* of layer specs
repeated n_periods times; its parameters and caches are stacked along a
leading LAYERS dim. The JAX package drives the stack with ``lax.scan`` (or
unrolls it at <= 2 periods); here it is a Python loop over the periods,
which computes the same thing. Caches are written in place.

Under autograd each period body is rematerialised as the config's
``remat`` says (``_remat``), as the JAX package wraps its scan body in
``jax.checkpoint``.

On the sequence-parallel path (``sharding.ctx.sequence_parallel``, which
the models' full-sequence calls open) the stream ``x`` that the blocks
take and return is this rank's block of the sequence: the norms and the
residual adds run on its tokens, and each sublayer gathers its input and
scatters its output (``ctx.enter_stream``, ``ctx.exit_stream``). Decode
never takes it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..sharding import ctx as shard_ctx
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .common import tree_leaves
from .layers import (gelu_mlp, gelu_mlp_template, layernorm,
                     layernorm_template, rmsnorm, rmsnorm_template, swiglu,
                     swiglu_template)

REMATS = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                  # attn | mla | cross | mamba | mlstm | slstm
    ffn: str                    # dense | moe | none
    cross_sub: bool = False     # extra cross-attn sublayer (enc-dec decoder)


def layout(cfg: ModelConfig, role: str = "decoder"):
    """Return (period: list[LayerSpec], n_periods) for an arch config;
    ``role="encoder"`` gives the encoder-decoder's encoder stack."""
    if role == "encoder":
        if not cfg.enc_layers:
            raise ValueError(f"{cfg.name} has no encoder")
        return [LayerSpec("attn", "dense")], cfg.enc_layers
    if cfg.enc_layers:                                     # enc-dec decoder
        return [LayerSpec("attn", "dense", cross_sub=True)], cfg.n_layers

    if cfg.family == "hybrid":                             # jamba
        period = []
        for i in range(cfg.attn_period):
            mixer = "attn" if i == 0 else "mamba"
            ffn = "moe" if (i % cfg.moe_period == 1 or cfg.moe_period == 1) \
                else "dense"
            period.append(LayerSpec(mixer, ffn))
        assert cfg.n_layers % cfg.attn_period == 0
        return period, cfg.n_layers // cfg.attn_period

    if cfg.family == "ssm":                                # xlstm
        sp = cfg.slstm_period
        period = [LayerSpec("mlstm", "none") for _ in range(sp - 1)]
        period.append(LayerSpec("slstm", "none"))
        assert cfg.n_layers % sp == 0
        return period, cfg.n_layers // sp

    if cfg.family == "vlm":                                # llama-vision
        cp = cfg.cross_attn_period
        period = [LayerSpec("attn", "dense") for _ in range(cp)]
        period[cp - 2] = LayerSpec("cross", "dense")
        assert cfg.n_layers % cp == 0
        return period, cfg.n_layers // cp

    mixer = "mla" if cfg.attn_type == "mla" else "attn"
    ffn = "moe" if (cfg.is_moe and cfg.moe_period == 1) else "dense"
    if cfg.is_moe and cfg.moe_period > 1:
        period = [LayerSpec(mixer, "moe" if i % cfg.moe_period == 1
                            else "dense")
                  for i in range(cfg.moe_period)]
        return period, cfg.n_layers // cfg.moe_period
    return [LayerSpec(mixer, ffn)], cfg.n_layers


def norm_template(cfg):
    return (layernorm_template if cfg.norm == "layernorm"
            else rmsnorm_template)(cfg.d_model)


def norm(cfg, params, x):
    """The config's norm: LayerNorm (the audio family) or RMS norm. Its
    parameters read the stream's tokens (``ctx.stream_param``)."""
    params = {k: shard_ctx.stream_param(v) for k, v in params.items()}
    return (layernorm if cfg.norm == "layernorm" else rmsnorm)(params, x)


def block_template(cfg: ModelConfig, spec: LayerSpec,
                   n_experts_padded: int | None = None):
    mixer = {"attn": attn_mod.gqa_template,
             "cross": attn_mod.gqa_template,
             "mla": mla_mod.mla_template,
             "mamba": ssm_mod.mamba_template,
             "mlstm": xlstm_mod.mlstm_template,
             "slstm": xlstm_mod.slstm_template}[spec.mixer]
    t = {"norm1": norm_template(cfg), "mixer": mixer(cfg)}
    if spec.cross_sub:
        t["norm_x"] = norm_template(cfg)
        t["cross"] = attn_mod.gqa_template(cfg)
    if spec.ffn != "none":
        t["norm2"] = norm_template(cfg)
        if spec.ffn == "moe":
            t["ffn"] = moe_mod.moe_template(cfg, n_experts_padded)
        elif cfg.family == "audio":
            t["ffn"] = gelu_mlp_template(cfg.d_model, cfg.d_ff)
        else:
            t["ffn"] = swiglu_template(cfg.d_model, cfg.d_ff)
    return t


def block_cache_template(cfg, spec: LayerSpec, batch: int, max_len: int,
                         kv_source_len: int, dtype=None):
    """Per-layer decode cache matching block_template's spec: the KV cache
    of an attention layer, the latent of an MLA layer, the encoder's (or
    the vision embeddings') keys and values of a cross layer or sublayer
    (``kv_source_len`` rows), the recurrent state of a Mamba or xLSTM
    layer."""
    c = {}
    if spec.mixer == "attn":
        c["self"] = attn_mod.cache_template(cfg, batch, max_len, dtype)
    elif spec.mixer == "mla":
        c["self"] = mla_mod.mla_cache_template(cfg, batch, max_len, dtype)
    elif spec.mixer == "cross":
        c["enc"] = attn_mod.cache_template(cfg, batch, kv_source_len, dtype)
    else:
        state = {"mamba": ssm_mod.mamba_state_template,
                 "mlstm": xlstm_mod.mlstm_state_template,
                 "slstm": xlstm_mod.slstm_state_template}[spec.mixer]
        c["state"] = state(cfg, batch, dtype)
    if spec.cross_sub:
        c["enc"] = attn_mod.cache_template(cfg, batch, kv_source_len, dtype)
    return c


def _write_enc(cache, params, cfg, kv_embeds) -> None:
    """Write the cross-attention keys and values of ``kv_embeds`` into the
    layer's ``enc`` cache in place (``attention.write_source``: under a
    mesh, this rank's placement of them). The JAX package replaces the
    cache entry whatever its length; in place, the cache must have been
    made with one row per source position (``kv_source_len``)."""
    if kv_embeds is None:
        raise ValueError("a cross-attention cache needs the source "
                         "embeddings (vision_embeds or the encoder's output)")
    attn_mod.write_source(cache["enc"], params, cfg, kv_embeds)


def _ffn(params, x, cfg, spec: LayerSpec, *, decode: bool = False):
    """The FFN sublayer and its residual add: (x, the MoE's aux loss or
    None for other FFNs). At decode the MoE's capacity is dropless
    (``n_experts / top_k``)."""
    if spec.ffn == "none":
        return x, None
    h = norm(cfg, params["norm2"], x)
    if spec.ffn == "dense":
        mlp = gelu_mlp if cfg.family == "audio" else swiglu
        return x + mlp(params["ffn"], h, width=cfg.d_ff), None
    out, aux = moe_mod.moe_apply(
        params["ffn"], h, cfg,
        capacity_factor=cfg.n_experts / max(cfg.top_k, 1) if decode else None)
    return x + out, aux


def block_apply(params, x, cfg, spec: LayerSpec, *, causal: bool = True,
                kv_embeds=None, impl: str = "auto", mlstm_impl: str = "ref",
                ssm_impl: str = "ref", cache=None):
    """Full-sequence block (training, or prefill when ``cache`` is given;
    the prefill writes the cache in place). ``causal=False`` is the
    encoder's self-attention; ``kv_embeds`` [b, t, d] is the source of the
    cross-attention layers and sublayers.

    Residual adds promote as ``jnp`` does (a bf16 stream plus an f32
    sublayer output is f32). Returns (x, cache, aux): aux is the MoE's
    load-balancing loss (0 for other FFNs). ``ssm_impl`` is the Mamba
    scan's form (``ssm.SSM_IMPLS``)."""
    ssm_mod.check_ssm_impl(ssm_impl)
    h = norm(cfg, params["norm1"], x)
    if spec.mixer == "attn":
        out = attn_mod.gqa_apply(
            params["mixer"], h, cfg, causal=causal, impl=impl,
            cache=None if cache is None else cache["self"])
    elif spec.mixer == "mla":
        out = mla_mod.mla_apply(
            params["mixer"], h, cfg, causal=causal,
            cache=None if cache is None else cache["self"])
    elif spec.mixer == "cross":
        out = attn_mod.gqa_apply(params["mixer"], h, cfg, kv_x=kv_embeds,
                                 impl=impl)
        if cache is not None:
            _write_enc(cache, params["mixer"], cfg, kv_embeds)
    elif spec.mixer == "mamba":
        out = ssm_mod.mamba_apply(
            params["mixer"], h, cfg, impl=impl, ssm_impl=ssm_impl,
            state=None if cache is None else cache["state"])
    elif spec.mixer == "mlstm":
        out = xlstm_mod.mlstm_apply(
            params["mixer"], h, cfg, impl=impl, mlstm_impl=mlstm_impl,
            state=None if cache is None else cache["state"])
    else:
        out = xlstm_mod.slstm_apply(
            params["mixer"], h, cfg,
            state=None if cache is None else cache["state"])
    if cache is not None and spec.mixer != "cross":
        out = out[0]
    x = x + out
    if spec.cross_sub:
        h = norm(cfg, params["norm_x"], x)
        x = x + attn_mod.gqa_apply(params["cross"], h, cfg, kv_x=kv_embeds,
                                   impl=impl)
        if cache is not None:
            _write_enc(cache, params["cross"], cfg, kv_embeds)
    x, aux = _ffn(params, x, cfg, spec)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, cache, aux


def block_decode(params, x, cfg, spec: LayerSpec, cache, lens, *,
                 src_len=None, impl: str = "auto"):
    """Single-token decode through one block. x: [b, 1, d]; the cache is
    updated in place (a cross layer's encoder cache is only read).
    ``src_len``: the cross layers' source rows over all ranks (needed
    under a mesh: ``attention.cross_decode``)."""
    h = norm(cfg, params["norm1"], x)
    if spec.mixer == "attn":
        out, _ = attn_mod.gqa_decode(params["mixer"], h, cfg, cache["self"],
                                     lens, impl=impl)
    elif spec.mixer == "mla":
        out, _ = mla_mod.mla_decode(params["mixer"], h, cfg, cache["self"],
                                    lens)
    elif spec.mixer == "cross":
        out = attn_mod.cross_decode(params["mixer"], h, cfg,
                                    cache["enc"]["k"], cache["enc"]["v"],
                                    src_len=src_len, impl=impl)
    elif spec.mixer == "mamba":
        out, _ = ssm_mod.mamba_decode(params["mixer"], h, cfg,
                                      cache["state"])
    elif spec.mixer == "mlstm":
        out, _ = xlstm_mod.mlstm_decode(params["mixer"], h, cfg,
                                        cache["state"])
    else:
        out, _ = xlstm_mod.slstm_decode(params["mixer"], h, cfg,
                                        cache["state"])
    x = x + out
    if spec.cross_sub:
        h = norm(cfg, params["norm_x"], x)
        x = x + attn_mod.cross_decode(params["cross"], h, cfg,
                                      cache["enc"]["k"], cache["enc"]["v"],
                                      src_len=src_len, impl=impl)
    return _ffn(params, x, cfg, spec, decode=True)[0], cache


def _period(tree, li: int):
    """Period ``li`` of a stacked cache: a view of every leaf's row li
    (written in place; a view of ``_periods`` may not be, under
    autograd)."""
    if isinstance(tree, dict):
        return {k: _period(v, li) for k, v in tree.items()}
    return tree[li]


def _periods(tree) -> list:
    """Every period of a stacked parameter tree, each leaf unbound along
    its leading dim once. Under autograd one unbind per leaf gathers the
    periods' gradients with a single stack, where indexing each period
    apart (``_period``) would add a zero-filled gradient of the whole
    stacked leaf per period."""
    if isinstance(tree, dict):
        parts = {k: _periods(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[li] for k, v in parts.items()} for li in range(n)]
    return list(torch.unbind(tree, 0))


# The matrix products that the "dots" policy may keep. torch.einsum and
# torch.matmul are composite ops: below autograd, where the policy sees
# them, they arrive as these.
_PRODUCTS = frozenset(getattr(torch.ops.aten, name).default for name in
                      ("mm", "bmm", "addmm", "baddbmm", "mv", "dot"))


def _dots_policy(weights: frozenset, ctx, op, *args, **kwargs):
    """Keep a product's output when one of its operands is a weight;
    recompute everything else in the backward pass.

    The counterpart of ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``. The op's name cannot tell the two
    kinds of product apart here: the port's ``einsum`` reaches ``bmm`` for
    a weight product (``bsd,df->bsf``) as for attention's scores
    (``bthd,bshd->btsh``). So an operand counts as a weight when its
    storage is the storage of a parameter leaf of the stack (``weights``:
    the identities of the parameters' storage objects, which a view
    shares and which live as long as the storage; a fake tensor has no
    address to key by): einsum hands a weight to the product as a view or
    reshape of the parameter, never as a copy, where the parameter already
    has the product's dtype. Products of two
    activations (attention's scores and values, the mLSTM's) are
    recomputed. Unlike JAX's policy, a weight product with a batch dim
    (the MoE's per-expert and the mLSTM's per-head projections) is kept
    too."""
    if op in _PRODUCTS and any(
            isinstance(a, torch.Tensor)
            and id(a.untyped_storage()) in weights for a in args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg, stacked):
    """``fn`` (one period's body) under the config's rematerialisation
    policy: ``"none"`` keeps every activation for the backward pass,
    ``"full"`` keeps only the period's inputs and recomputes the body,
    ``"dots"`` keeps the outputs of weight products as well
    (``_dots_policy``). Gradients are the same under all three. Nothing
    in the forward pass draws random numbers, so no RNG state is kept.

    The body runs under the sharding rules current when it is wrapped
    (the stream's sequence-parallel axis among them): the backward pass
    recomputes it where they are not set (on the card, in autograd's own
    thread), and without them a sharded body would skip its
    collectives."""
    if cfg.remat not in REMATS:
        raise ValueError(f"remat={cfg.remat!r} not in {REMATS}")
    if cfg.remat == "none":
        return fn
    rules = shard_ctx.current()
    if rules is not None:
        body = fn

        def fn(*args):
            with shard_ctx.activation_rules(rules):
                return body(*args)
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat == "dots":
        weights = frozenset(id(t.untyped_storage())
                            for t in tree_leaves(stacked))
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_dots_policy, weights))
    return functools.partial(checkpoint, fn, **kw)


def stack_apply(stacked, x, cfg, period, *, causal: bool = True,
                kv_embeds=None, impl: str = "auto", mlstm_impl: str = "ref",
                ssm_impl: str = "ref", caches=None):
    """Run the period stack. ``stacked``/``caches``: {"p{i}": tree} with a
    leading n_periods dim on every leaf; caches are written in place.
    Returns (x, caches, aux), aux the sum of the periods' MoE losses.

    Under autograd and without caches (training), each period body runs
    under ``_remat``. A prefill (caches given) is not rematerialised: a
    recomputed body would write its cache a second time, from a state the
    first pass has already overwritten."""

    def body(layer, layer_cache, x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, spec in enumerate(period):
            x, _, a = block_apply(
                layer[f"p{i}"], x, cfg, spec, causal=causal,
                kv_embeds=kv_embeds, impl=impl, mlstm_impl=mlstm_impl,
                ssm_impl=ssm_impl,
                cache=None if layer_cache is None else layer_cache[f"p{i}"])
            aux = aux + a
        return x, aux

    if caches is None and torch.is_grad_enabled():
        body = _remat(body, cfg, stacked)
    auxs = []
    for li, layer in enumerate(_periods(stacked)):
        x, a = body(layer, None if caches is None else _period(caches, li),
                    x)
        auxs.append(a)
    return x, caches, torch.sum(torch.stack(auxs))


def stack_decode(stacked, x, cfg, period, caches, lens, *, src_len=None,
                 impl: str = "auto"):
    for li, layer in enumerate(_periods(stacked)):
        layer_cache = _period(caches, li)
        for i, spec in enumerate(period):
            x, _ = block_decode(layer[f"p{i}"], x, cfg, spec,
                                layer_cache[f"p{i}"], lens, src_len=src_len,
                                impl=impl)
    return x, caches
