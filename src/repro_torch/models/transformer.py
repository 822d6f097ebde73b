"""Decoder blocks and the layer stack: the dense GQA decoder, the xLSTM
and the hybrid (jamba: attention, Mamba and MoE).

Every architecture of the JAX package is a *period* of layer specs
repeated n_periods times; its parameters and caches are stacked along a
leading LAYERS dim. The JAX package drives the stack with ``lax.scan`` (or
unrolls it at <= 2 periods); here it is a Python loop over the periods,
which computes the same thing. The ported layer kinds are the mixers
``attn``, ``mamba``, ``mlstm`` and ``slstm`` and the FFNs ``dense``,
``moe`` and ``none``; the others raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import rmsnorm, rmsnorm_template, swiglu, swiglu_template

_NOT_PORTED = {
    "mla": "MLA attention (minicpm3): ROADMAP queue 1 item 10",
    "moe": "MoE serving outside the hybrid layout (dbrx, qwen2-moe): "
           "ROADMAP queue 1 item 10d",
    "cross": "cross-attention (VLM, encoder-decoder): ROADMAP queue 1 item "
             "10",
    "layernorm": "LayerNorm blocks (audio family): ROADMAP queue 1 item 10",
    "remat": "rematerialisation for training (run under torch.no_grad() "
             "to serve): ROADMAP queue 1 item 10",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: "
                               f"{_NOT_PORTED[what]}")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                  # attn | mamba | mlstm | slstm (mla | cross)
    ffn: str                    # dense | moe | none
    cross_sub: bool = False     # extra cross-attn sublayer (enc-dec)


def layout(cfg: ModelConfig):
    """Return (period: list[LayerSpec], n_periods) for a dense GQA decoder,
    the xLSTM or the hybrid; other families raise ``NotImplementedError``."""
    if cfg.enc_layers:
        raise not_ported("cross")
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
    if cfg.family == "vlm":
        raise not_ported("cross")
    if cfg.attn_type == "mla":
        raise not_ported("mla")
    if cfg.is_moe:
        raise not_ported("moe")
    return [LayerSpec("attn", "dense")], cfg.n_layers


def _check(cfg: ModelConfig, spec: LayerSpec) -> None:
    if spec.mixer not in ("attn", "mamba", "mlstm", "slstm"):
        raise not_ported(spec.mixer)
    if spec.ffn not in ("dense", "moe", "none"):
        raise not_ported(spec.ffn)
    if spec.cross_sub:
        raise not_ported("cross")
    if cfg.norm != "rmsnorm" or cfg.family == "audio":
        raise not_ported("layernorm")


def block_template(cfg: ModelConfig, spec: LayerSpec,
                   n_experts_padded: int | None = None):
    _check(cfg, spec)
    mixer = {"attn": attn_mod.gqa_template,
             "mamba": ssm_mod.mamba_template,
             "mlstm": xlstm_mod.mlstm_template,
             "slstm": xlstm_mod.slstm_template}[spec.mixer]
    t = {"norm1": rmsnorm_template(cfg.d_model), "mixer": mixer(cfg)}
    if spec.ffn != "none":
        t["norm2"] = rmsnorm_template(cfg.d_model)
        t["ffn"] = (moe_mod.moe_template(cfg, n_experts_padded)
                    if spec.ffn == "moe"
                    else swiglu_template(cfg.d_model, cfg.d_ff))
    return t


def block_cache_template(cfg, spec: LayerSpec, batch: int, max_len: int,
                         dtype=None):
    """Per-layer decode cache matching block_template's spec: the KV cache
    of an attention layer, the recurrent state of a Mamba or xLSTM
    layer."""
    _check(cfg, spec)
    if spec.mixer == "attn":
        return {"self": attn_mod.cache_template(cfg, batch, max_len, dtype)}
    state = {"mamba": ssm_mod.mamba_state_template,
             "mlstm": xlstm_mod.mlstm_state_template,
             "slstm": xlstm_mod.slstm_state_template}[spec.mixer]
    return {"state": state(cfg, batch, dtype)}


def _ffn(params, x, cfg, spec: LayerSpec, *, decode: bool = False):
    """The FFN sublayer and its residual add: (x, the MoE's aux loss or
    None for other FFNs). At decode the MoE's capacity is dropless
    (``n_experts / top_k``)."""
    if spec.ffn == "none":
        return x, None
    h = rmsnorm(params["norm2"], x)
    if spec.ffn == "dense":
        return x + swiglu(params["ffn"], h), None
    out, aux = moe_mod.moe_apply(
        params["ffn"], h, cfg,
        capacity_factor=cfg.n_experts / max(cfg.top_k, 1) if decode else None)
    return x + out, aux


def block_apply(params, x, cfg, spec: LayerSpec, *, impl: str = "auto",
                cache=None):
    """Causal full-sequence block (training, or prefill when ``cache`` is
    given; the prefill writes the cache in place).

    Residual adds promote as ``jnp`` does (a bf16 stream plus an f32
    sublayer output is f32). Returns (x, cache, aux): aux is the MoE's
    load-balancing loss (0 for other FFNs)."""
    _check(cfg, spec)
    h = rmsnorm(params["norm1"], x)
    if spec.mixer == "attn":
        out = attn_mod.gqa_apply(
            params["mixer"], h, cfg, impl=impl,
            cache=None if cache is None else cache["self"])
    elif spec.mixer == "mamba":
        out = ssm_mod.mamba_apply(
            params["mixer"], h, cfg, impl=impl,
            state=None if cache is None else cache["state"])
    elif spec.mixer == "mlstm":
        out = xlstm_mod.mlstm_apply(
            params["mixer"], h, cfg, impl=impl,
            state=None if cache is None else cache["state"])
    else:
        out = xlstm_mod.slstm_apply(
            params["mixer"], h, cfg,
            state=None if cache is None else cache["state"])
    if cache is not None:
        out = out[0]
    x, aux = _ffn(params, x + out, cfg, spec)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, cache, aux


def block_decode(params, x, cfg, spec: LayerSpec, cache, lens, *,
                 impl: str = "auto"):
    """Single-token decode through one block. x: [b, 1, d]; the cache is
    updated in place."""
    _check(cfg, spec)
    h = rmsnorm(params["norm1"], x)
    if spec.mixer == "attn":
        out, _ = attn_mod.gqa_decode(params["mixer"], h, cfg, cache["self"],
                                     lens, impl=impl)
    elif spec.mixer == "mamba":
        out, _ = ssm_mod.mamba_decode(params["mixer"], h, cfg,
                                      cache["state"])
    elif spec.mixer == "mlstm":
        out, _ = xlstm_mod.mlstm_decode(params["mixer"], h, cfg,
                                        cache["state"])
    else:
        out, _ = xlstm_mod.slstm_decode(params["mixer"], h, cfg,
                                        cache["state"])
    return _ffn(params, x + out, cfg, spec, decode=True)[0], cache


def _period(tree, li: int):
    """Period ``li`` of a stacked tree: a view of every leaf's row li."""
    if isinstance(tree, dict):
        return {k: _period(v, li) for k, v in tree.items()}
    return tree[li]


def _n_periods(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def stack_apply(stacked, x, cfg, period, *, impl: str = "auto",
                caches=None):
    """Run the period stack. ``stacked``/``caches``: {"p{i}": tree} with a
    leading n_periods dim on every leaf; caches are written in place.
    Returns (x, caches, aux), aux the sum of the MoE layers' losses."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        # Rematerialisation only changes what a backward pass keeps; an
        # inference run (no autograd) computes the same without it.
        raise not_ported("remat")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(_n_periods(stacked)):
        layer = _period(stacked, li)
        layer_cache = None if caches is None else _period(caches, li)
        for i, spec in enumerate(period):
            x, _, a = block_apply(
                layer[f"p{i}"], x, cfg, spec, impl=impl,
                cache=None if layer_cache is None else layer_cache[f"p{i}"])
            aux = aux + a
    return x, caches, aux


def stack_decode(stacked, x, cfg, period, caches, lens, *,
                 impl: str = "auto"):
    for li in range(_n_periods(stacked)):
        layer, layer_cache = _period(stacked, li), _period(caches, li)
        for i, spec in enumerate(period):
            x, _ = block_decode(layer[f"p{i}"], x, cfg, spec,
                                layer_cache[f"p{i}"], lens, impl=impl)
    return x, caches
