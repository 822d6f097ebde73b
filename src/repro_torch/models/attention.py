"""GQA self-attention and cross-attention blocks: templates, prefill and
single-token decode.

The KV cache is updated in place (the JAX package returns a new cache
tree): the prefill writes the new keys and values at offset 0 of the cache
it is given, and a decode step writes one row per sequence. Each function
still returns the cache, so callers read as in the JAX package.
"""
from __future__ import annotations

import torch

from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import attention as attn_op
from .common import CACHE_SEQ, EMBED, HEAD_DIM, HEADS, KV_HEADS, P
from .layers import apply_rope, einsum


def gqa_template(cfg):
    d, h, kvh = cfg.d_model, cfg.padded_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    t = {
        "wq": P((d, h, hd), (EMBED, HEADS, HEAD_DIM)),
        "wk": P((d, kvh, hd), (EMBED, KV_HEADS, HEAD_DIM)),
        "wv": P((d, kvh, hd), (EMBED, KV_HEADS, HEAD_DIM)),
        "wo": P((h, hd, d), (HEADS, HEAD_DIM, EMBED)),
    }
    if cfg.qkv_bias:
        t["bq"] = P((h, hd), (HEADS, HEAD_DIM), init="zeros")
        t["bk"] = P((kvh, hd), (KV_HEADS, HEAD_DIM), init="zeros")
        t["bv"] = P((kvh, hd), (KV_HEADS, HEAD_DIM), init="zeros")
    return t


def cache_template(cfg, batch: int, max_len: int, dtype=None):
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    axes = ("batch", CACHE_SEQ, KV_HEADS, HEAD_DIM)
    return {"k": P((batch, max_len, kvh, hd), axes, init="zeros",
                   dtype=dtype),
            "v": P((batch, max_len, kvh, hd), axes, init="zeros",
                   dtype=dtype)}


def _qkv(params, x, kv_x, cfg):
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    return (q,) + encode_kv(params, cfg, kv_x)


def _out(params, ctx):
    return einsum("bshk,hkd->bsd", ctx, params["wo"])


def gqa_apply(params, x, cfg, *, causal: bool = True, kv_x=None,
              impl: str = "auto", cache=None):
    """Full-sequence attention (training / prefill) over the s tokens of
    ``x`` [b, s, d] at positions 0..s-1: query offset 0 against the s new
    keys, causal unless ``causal=False`` (the encoder).

    ``kv_x``: the cross-attention source [b, t, d] (vision or encoder
    embeddings): keys and values come from it, with no rope, and every
    query sees every key.
    ``cache``: when given (prefill), the keys and values are written at
    offset 0 in place and ``(y, cache)`` is returned.
    """
    s = x.shape[1]
    cross = kv_x is not None
    q, k, v = _qkv(params, x, kv_x if cross else x, cfg)
    if not cross:
        positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attn_op(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal and not cross, impl=impl)
    y = _out(params, out)
    if cache is None:
        return y
    if s > cache["k"].shape[1]:
        raise ValueError(f"prefill of {s} tokens exceeds the cache's "
                         f"{cache['k'].shape[1]} positions")
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return y, cache


def scatter_kv(cache_arr: torch.Tensor, new: torch.Tensor,
               lens: torch.Tensor) -> None:
    """Write ``new`` [b, ...] at per-sequence positions ``lens`` [b] of
    ``cache_arr`` [b, t, ...] in place. A sequence whose position is
    outside [0, t) writes nothing and raises nothing (the JAX package's
    ``mode="drop"``); nothing is read back to the host."""
    b, t = cache_arr.shape[:2]
    rows = torch.arange(b, device=cache_arr.device)
    lens = lens.long()
    inside = (lens >= 0) & (lens < t)
    pos = lens.clamp(0, t - 1)
    keep = cache_arr[rows, pos]
    mask = inside.reshape((b,) + (1,) * (new.dim() - 1))
    cache_arr[rows, pos] = torch.where(mask, new.to(cache_arr.dtype), keep)


def gqa_decode(params, x, cfg, cache, lens, *, impl: str = "auto"):
    """Single-token decode. x: [b, 1, d]; lens: int32 [b] cache fill.

    Writes the new key and value at ``lens`` in place and attends over the
    ``lens + 1`` first cache rows. Returns (y [b, 1, d], cache)."""
    q, k, v = _qkv(params, x, x, cfg)
    pos = lens[:, None]                                   # [b, 1]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    scatter_kv(cache["k"], k[:, 0], lens)
    scatter_kv(cache["v"], v[:, 0], lens)
    out = decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                           (lens + 1).to(torch.int32), impl=impl)
    return _out(params, out[:, None]), cache


def cross_decode(params, x, cfg, enc_k, enc_v, *, impl: str = "auto"):
    """Cross-attention during decode: x [b, 1, d] against all t rows of
    the static encoder keys and values [b, t, kvh, hd]; nothing is
    written."""
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    lens = torch.full((x.shape[0],), enc_k.shape[1], dtype=torch.int32,
                      device=x.device)
    out = decode_attention(q[:, 0].contiguous(), enc_k, enc_v, lens,
                           impl=impl)
    return _out(params, out[:, None])


def encode_kv(params, cfg, kv_x):
    """The cross-attention keys and values of ``kv_x`` [b, t, d] (encoder
    output or vision embeddings): ([b, t, kvh, hd], [b, t, kvh, hd])."""
    k = einsum("btd,dhk->bthk", kv_x, params["wk"])
    v = einsum("btd,dhk->bthk", kv_x, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    return k, v
