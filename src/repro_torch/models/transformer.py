"""Decoder blocks and the layer stack: the dense GQA decoder and the
xLSTM.

Every architecture of the JAX package is a *period* of layer specs
repeated n_periods times; its parameters and caches are stacked along a
leading LAYERS dim. The JAX package drives the stack with ``lax.scan`` (or
unrolls it at <= 2 periods); here it is a Python loop over the periods,
which computes the same thing. The ported layer kinds are ``mixer="attn"``
with ``ffn="dense"`` and the xLSTM's ``mlstm`` and ``slstm`` with
``ffn="none"``; the others raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import xlstm as xlstm_mod
from .layers import rmsnorm, rmsnorm_template, swiglu, swiglu_template

_NOT_PORTED = {
    "mla": "MLA attention (minicpm3): ROADMAP queue 1 item 10",
    "moe": "mixture-of-experts FFN: ROADMAP queue 1 item 10",
    "mamba": "Mamba layers and the selective_scan kernel: ROADMAP queue 1 "
             "item 10, queue 2 row 8",
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
    mixer: str                  # attn | mlstm | slstm (mla | cross | mamba)
    ffn: str                    # dense | none (moe)
    cross_sub: bool = False     # extra cross-attn sublayer (enc-dec)


def layout(cfg: ModelConfig):
    """Return (period: list[LayerSpec], n_periods) for a dense GQA decoder
    or the xLSTM; other families raise ``NotImplementedError``."""
    if cfg.enc_layers:
        raise not_ported("cross")
    if cfg.family == "hybrid":
        raise not_ported("mamba")
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
    if spec.mixer not in ("attn", "mlstm", "slstm"):
        raise not_ported(spec.mixer)
    if spec.ffn not in ("dense", "none"):
        raise not_ported(spec.ffn)
    if spec.cross_sub:
        raise not_ported("cross")
    if cfg.norm != "rmsnorm" or cfg.family == "audio":
        raise not_ported("layernorm")


def block_template(cfg: ModelConfig, spec: LayerSpec):
    _check(cfg, spec)
    mixer = {"attn": attn_mod.gqa_template,
             "mlstm": xlstm_mod.mlstm_template,
             "slstm": xlstm_mod.slstm_template}[spec.mixer]
    t = {"norm1": rmsnorm_template(cfg.d_model), "mixer": mixer(cfg)}
    if spec.ffn == "dense":
        t["norm2"] = rmsnorm_template(cfg.d_model)
        t["ffn"] = swiglu_template(cfg.d_model, cfg.d_ff)
    return t


def block_cache_template(cfg, spec: LayerSpec, batch: int, max_len: int,
                         dtype=None):
    """Per-layer decode cache matching block_template's spec: the KV cache
    of an attention layer, the recurrent state of an xLSTM layer."""
    _check(cfg, spec)
    if spec.mixer == "attn":
        return {"self": attn_mod.cache_template(cfg, batch, max_len, dtype)}
    state = {"mlstm": xlstm_mod.mlstm_state_template,
             "slstm": xlstm_mod.slstm_state_template}[spec.mixer]
    return {"state": state(cfg, batch, dtype)}


def _ffn(params, x, spec: LayerSpec):
    if spec.ffn == "none":
        return x
    return x + swiglu(params["ffn"], rmsnorm(params["norm2"], x))


def block_apply(params, x, cfg, spec: LayerSpec, *, impl: str = "auto",
                cache=None):
    """Causal full-sequence block (training, or prefill when ``cache`` is
    given; the prefill writes the cache in place).

    Residual adds promote as ``jnp`` does (a bf16 stream plus an f32
    sublayer output is f32). Returns (x, cache, aux)."""
    _check(cfg, spec)
    h = rmsnorm(params["norm1"], x)
    if spec.mixer == "attn":
        out = attn_mod.gqa_apply(
            params["mixer"], h, cfg, impl=impl,
            cache=None if cache is None else cache["self"])
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
    x = _ffn(params, x + out, spec)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def block_decode(params, x, cfg, spec: LayerSpec, cache, lens, *,
                 impl: str = "auto"):
    """Single-token decode through one block. x: [b, 1, d]; the cache is
    updated in place."""
    _check(cfg, spec)
    h = rmsnorm(params["norm1"], x)
    if spec.mixer == "attn":
        out, _ = attn_mod.gqa_decode(params["mixer"], h, cfg, cache["self"],
                                     lens, impl=impl)
    elif spec.mixer == "mlstm":
        out, _ = xlstm_mod.mlstm_decode(params["mixer"], h, cfg,
                                        cache["state"])
    else:
        out, _ = xlstm_mod.slstm_decode(params["mixer"], h, cfg,
                                        cache["state"])
    return _ffn(params, x + out, spec), cache


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
    Returns (x, caches, aux)."""
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
