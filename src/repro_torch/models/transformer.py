"""Decoder blocks and the layer stack, for the dense GQA decoder.

Every architecture of the JAX package is a *period* of layer specs
repeated n_periods times; its parameters and caches are stacked along a
leading LAYERS dim. The JAX package drives the stack with ``lax.scan`` (or
unrolls it at <= 2 periods); here it is a Python loop over the periods,
which computes the same thing. Only ``mixer="attn"`` with ``ffn="dense"``
is ported: the other layer kinds raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from . import attention as attn_mod
from .layers import rmsnorm, rmsnorm_template, swiglu, swiglu_template

_NOT_PORTED = {
    "mla": "MLA attention (minicpm3): ROADMAP queue 1 item 10",
    "moe": "mixture-of-experts FFN: ROADMAP queue 1 item 10",
    "mamba": "Mamba layers and the selective_scan kernel: ROADMAP queue 1 "
             "item 10, queue 2 row 8",
    "mlstm": "mLSTM layers and the mlstm_chunkwise kernel: ROADMAP queue 1 "
             "item 10, queue 2 row 9",
    "slstm": "sLSTM layers: ROADMAP queue 1 item 10",
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
    mixer: str                  # attn (mla | cross | mamba | mlstm | slstm)
    ffn: str                    # dense (moe | none)
    cross_sub: bool = False     # extra cross-attn sublayer (enc-dec)


def layout(cfg: ModelConfig):
    """Return (period: list[LayerSpec], n_periods) for a dense GQA
    decoder; other families raise ``NotImplementedError``."""
    if cfg.enc_layers:
        raise not_ported("cross")
    if cfg.family == "hybrid":
        raise not_ported("mamba")
    if cfg.family == "ssm":
        raise not_ported("mlstm")
    if cfg.family == "vlm":
        raise not_ported("cross")
    if cfg.attn_type == "mla":
        raise not_ported("mla")
    if cfg.is_moe:
        raise not_ported("moe")
    return [LayerSpec("attn", "dense")], cfg.n_layers


def _check(cfg: ModelConfig, spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise not_ported(spec.mixer)
    if spec.ffn != "dense":
        raise not_ported(spec.ffn)
    if spec.cross_sub:
        raise not_ported("cross")
    if cfg.norm != "rmsnorm" or cfg.family == "audio":
        raise not_ported("layernorm")


def block_template(cfg: ModelConfig, spec: LayerSpec):
    _check(cfg, spec)
    return {"norm1": rmsnorm_template(cfg.d_model),
            "mixer": attn_mod.gqa_template(cfg),
            "norm2": rmsnorm_template(cfg.d_model),
            "ffn": swiglu_template(cfg.d_model, cfg.d_ff)}


def block_cache_template(cfg, spec: LayerSpec, batch: int, max_len: int,
                         dtype=None):
    """Per-layer decode cache matching block_template's spec."""
    _check(cfg, spec)
    return {"self": attn_mod.cache_template(cfg, batch, max_len, dtype)}


def block_apply(params, x, cfg, spec: LayerSpec, *, impl: str = "auto",
                cache=None):
    """Causal full-sequence block (training, or prefill when ``cache`` is
    given).

    Residual adds promote as ``jnp`` does (a bf16 stream plus an f32
    sublayer output is f32). Returns (x, cache, aux)."""
    _check(cfg, spec)
    h = rmsnorm(params["norm1"], x)
    out = attn_mod.gqa_apply(params["mixer"], h, cfg, impl=impl,
                             cache=None if cache is None else cache["self"])
    if cache is not None:
        out = out[0]
    x = x + out
    x = x + swiglu(params["ffn"], rmsnorm(params["norm2"], x))
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def block_decode(params, x, cfg, spec: LayerSpec, cache, lens, *,
                 impl: str = "auto"):
    """Single-token decode through one block. x: [b, 1, d]."""
    _check(cfg, spec)
    h = rmsnorm(params["norm1"], x)
    out, _ = attn_mod.gqa_decode(params["mixer"], h, cfg, cache["self"],
                                 lens, impl=impl)
    x = x + out
    x = x + swiglu(params["ffn"], rmsnorm(params["norm2"], x))
    return x, cache


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
