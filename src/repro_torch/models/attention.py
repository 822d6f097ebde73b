"""GQA self-attention and cross-attention blocks: templates, prefill and
single-token decode.

The KV cache is updated in place (the JAX package returns a new cache
tree): the prefill writes the new keys and values at offset 0 of the cache
it is given, and a decode step writes one row per sequence. Each function
still returns the cache, so callers read as in the JAX package.

Under a mesh (``sharding.ctx``) each rank computes its local heads: the
query heads split over the heads' mesh axis, the kv heads too when they
divide it. Otherwise the kv projections are replicated and each rank keeps
the kv heads its query heads read (whole groups, or one kv head shared
with other ranks). The cache holds the rank's kv heads, the attention
kernels run on the local heads, and the output product's partial sum is
all-reduced over the axis. On the sequence-parallel path the input is
the stream's block of tokens, gathered on entry, and the output is
reduce-scattered onto it (``ctx.enter_stream``, ``ctx.exit_stream``):
the positions, the kernels and a prefill's cache see the whole
sequence.

Where the rules split the cache's rows (``cache_seq`` on a mesh axis, of
extent 1 too: ``_cache_split``), each rank holds rows [off, off + t_loc)
of every sequence for every kv head, and the decode is split-KV across
ranks: the query heads are gathered, each rank runs the split pass of
``flash_decode`` over its rows, the ranks exchange the partials so that
each holds every rank's partials of its own query heads, and the combine
pass merges them. The prefill writes the prompt's rows that fall in the
rank's block and attends over the prompt locally, as without the split.

A cross layer's cache (the encoder's or the vision embeddings' keys and
values, ``t`` source rows) takes the same template: its rows split where
the rules' ``cache_seq`` axis divides ``t`` (``_cache_split``), else each
rank holds them whole, as ``spec.spec_dims`` falls back. The prefill
attends over the whole source on the rank's heads and writes its
placement (``write_source``); the decode runs the split path above over
a split source with every row valid.
"""
from __future__ import annotations

import torch

from ..kernels.decode_attention import (decode_attention, decode_combine,
                                        decode_split)
from ..kernels.flash_attention import attention as attn_op
from ..sharding import ctx as shard_ctx
from ..sharding.spec import mesh_dims
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


def _heads(cfg):
    """Under a mesh: (the mesh axis the query heads are split over, or
    None, and the (first, count) of the kv heads this rank's query heads
    read when the kv heads are replicated, else None). Outside a mesh:
    (None, None)."""
    h, kvh = cfg.padded_heads, cfg.n_kv_heads
    axis = shard_ctx.axis_for(HEADS, h)
    if axis is None or shard_ctx.axis_for(KV_HEADS, kvh) is not None:
        return axis, None
    m = shard_ctx.mesh()
    hl, group = h // m.extent(axis), h // kvh
    first = m.coord(axis) * hl
    if hl % group == 0:
        return axis, (first // group, hl // group)
    if group % hl == 0:
        return axis, (first // group, 1)
    raise NotImplementedError(
        f"{h} query heads over {m.extent(axis)} ranks split the groups of "
        f"{kvh} replicated kv heads unevenly")


def _qkv(params, x, kv_x, cfg):
    """q, k, v of the rank's heads (all kv heads when they are
    replicated: the cache keeps them all)."""
    axis, kv_part = _heads(cfg)
    x = shard_ctx.enter_stream(x, axis)
    if axis is not None:
        kv_x = x if kv_x is None else shard_ctx.enter(kv_x, axis)
    elif kv_x is not None:
        # A source every cross layer reads (the encoder's output) takes
        # each layer's gradient summed first, as ``enter`` sums it under a
        # mesh: one order of the sum, with and without one.
        kv_x = kv_x.view_as(kv_x)
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    shard_ctx.constrain(q, ("batch", None, HEADS, HEAD_DIM),
                        (None, None, cfg.padded_heads, q.shape[-1]))
    kv_params = params
    if kv_part is not None:
        # Each rank's query heads read a part of the replicated kv heads:
        # the weights' gradients are partial sums over the heads' axis.
        kv_params = {key: shard_ctx.enter(params[key], axis)
                     for key in ("wk", "wv", "bk", "bv") if key in params}
    return (q,) + encode_kv(kv_params, cfg, x if kv_x is None else kv_x)


def cache_rows_axis(n_kv_heads: int, rules: dict, t: int = 1 << 30):
    """The mesh axis the rows of a cache of ``t`` rows split over under
    ``rules``, or None: a self-attention cache's (any length: the plan
    refuses one the axis does not divide) or a cross layer's (its source
    rows, whole where the axis does not divide them). The cache's own
    placement decides (``mesh_dims`` over its dims, the first dim winning
    a mesh axis), not the kv heads' rule: with ``kv_heads`` and
    ``cache_seq`` both on one axis the rows take it."""
    _, axis, kv_axis, _ = mesh_dims((1 << 30, t, n_kv_heads, 1),
                                    ("batch", CACHE_SEQ, KV_HEADS, HEAD_DIM),
                                    rules)
    if axis is not None and kv_axis is not None:
        raise NotImplementedError(
            f"the cache's rows over {axis!r} and its kv heads over "
            f"{kv_axis!r}: a rank holds every kv head of its rows")
    return axis


def _cache_split(cfg, t: int = 1 << 30):
    """(mesh axis, extent, this rank's index) of the split of a cache of
    ``t`` rows under the current rules (``cache_rows_axis``), or None."""
    if shard_ctx.mesh() is None:
        return None
    return shard_ctx.split_of(cache_rows_axis(cfg.n_kv_heads,
                                              shard_ctx.current(), t))


def _all_kv_heads(cfg, k, v):
    """k, v of every kv head (gathered where the kv projections are split:
    a rank of a split cache holds all kv heads of its rows)."""
    axis = shard_ctx.axis_for(KV_HEADS, cfg.n_kv_heads)
    if axis is None:
        return k, v
    return (shard_ctx.all_gather(k, axis, dim=2, partial_grad=False),
            shard_ctx.all_gather(v, axis, dim=2, partial_grad=False))


def _kv_heads(cfg, k, v):
    """The kv heads this rank's query heads read, contiguous."""
    _, kv_part = _heads(cfg)
    if kv_part is None:
        return k, v
    lo, n = kv_part
    return (k[:, :, lo:lo + n].contiguous(),
            v[:, :, lo:lo + n].contiguous())


def _out(params, ctx, cfg=None):
    y = einsum("bshk,hkd->bsd", ctx, params["wo"])
    axis = None if cfg is None else _heads(cfg)[0]
    return shard_ctx.exit_stream(y, axis)


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
    cross = kv_x is not None
    q, k, v = _qkv(params, x, kv_x, cfg)
    s = q.shape[1]
    if not cross:
        positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    ka, va = _kv_heads(cfg, k, v)
    out = attn_op(q.contiguous(), ka.contiguous(), va.contiguous(),
                  causal=causal and not cross, impl=impl)
    y = _out(params, out, cfg)
    if cache is None:
        return y
    t_loc = cache["k"].shape[1]
    split = _cache_split(cfg)
    if split is None:
        lo, hi = 0, s
        if s > t_loc:
            raise ValueError(f"prefill of {s} tokens exceeds the cache's "
                             f"{t_loc} positions")
    else:
        # This rank's block: rows [off, off + t_loc) of t_loc * extent.
        _, extent, rank = split
        if s > t_loc * extent:
            raise ValueError(f"prefill of {s} tokens exceeds the cache's "
                             f"{t_loc * extent} positions ({extent} "
                             f"blocks of {t_loc})")
        k, v = _all_kv_heads(cfg, k, v)
        lo = rank * t_loc
        hi = min(lo + t_loc, s)
    if hi > lo:
        cache["k"][:, :hi - lo] = k[:, lo:hi].to(cache["k"].dtype)
        cache["v"][:, :hi - lo] = v[:, lo:hi].to(cache["v"].dtype)
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
    q, k, v = _qkv(params, x, None, cfg)
    pos = lens[:, None]                                   # [b, 1]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    split = _cache_split(cfg)
    if split is not None:
        return _split_decode(params, q, k, v, cfg, cache, lens, split,
                             impl), cache
    scatter_kv(cache["k"], k[:, 0], lens)
    scatter_kv(cache["v"], v[:, 0], lens)
    ck, cv = _kv_heads(cfg, cache["k"], cache["v"])
    out = decode_attention(q[:, 0].contiguous(), ck, cv,
                           (lens + 1).to(torch.int32), impl=impl)
    return _out(params, out[:, None], cfg), cache


def _split_decode(params, q, k, v, cfg, cache, lens, split, impl):
    """Decode against a cache whose rows are split over ``split``'s axis
    (module docstring). q: this rank's query heads [b, 1, h_loc, hd]; k, v
    the new row's kv heads. Returns y [b, 1, d]."""
    axis, _, rank = split
    t_loc = cache["k"].shape[1]
    off = rank * t_loc
    k, v = _all_kv_heads(cfg, k, v)
    # The new row lands in the block that holds position lens (scatter_kv
    # drops it elsewhere).
    scatter_kv(cache["k"], k[:, 0], lens - off)
    scatter_kv(cache["v"], v[:, 0], lens - off)
    kv_len = (lens + 1 - off).clamp(0, t_loc).to(torch.int32)
    return _split_attend(params, q, cache["k"], cache["v"], kv_len, cfg,
                         axis, impl)


def _split_attend(params, q, ck, cv, kv_len, cfg, axis, impl):
    """One query token of this rank's heads q [b, 1, h_loc, hd] against
    its block of rows ck, cv [b, t_loc, kvh, hd] (every kv head) of a
    cache split over ``axis``, ``kv_len`` [b] of them valid: the split
    pass over the block, the exchange of the partials and the combine
    pass. Returns y [b, 1, d]."""
    heads = _heads(cfg)[0]
    q = q[:, 0].contiguous()                              # [b, h_loc, hd]
    if heads is not None:
        q = shard_ctx.all_gather(q, heads, dim=1, partial_grad=False)
    ws = decode_split(q, ck, cv, kv_len, impl=impl)
    if heads == axis:
        # Each rank keeps its query heads' partials from every rank, in
        # rank order: the splits in row order.
        ws = shard_ctx.all_to_all(ws, axis, 1, 2)
    else:
        ws = shard_ctx.all_gather(ws, axis, dim=2, partial_grad=False)
        if heads is not None:
            ws = shard_ctx.slice_dim(ws, heads, 1, shard_ctx.mesh())
    out = decode_combine(ws.contiguous(), q.dtype, impl=impl)
    return _out(params, out[:, None], cfg)


def write_source(cache, params, cfg, kv_x) -> None:
    """Write the cross-attention keys and values of ``kv_x`` [b, t, d]
    into a cross layer's cache in place: this rank's kv heads or, where
    the rows split (``_cache_split``), every kv head of its block of
    rows."""
    k, v = encode_kv(params, cfg, kv_x)
    split = _cache_split(cfg, kv_x.shape[1])
    if split is not None:
        _, extent, rank = split
        k, v = _all_kv_heads(cfg, k, v)
        t_loc = kv_x.shape[1] // extent
        k = k[:, rank * t_loc:(rank + 1) * t_loc]
        v = v[:, rank * t_loc:(rank + 1) * t_loc]
    if cache["k"].shape != k.shape:
        raise ValueError(f"cross-attention cache {tuple(cache['k'].shape)} "
                         f"does not fit the source's keys {tuple(k.shape)}: "
                         "make the cache with kv_source_len (enc_len) equal "
                         "to the source length")
    cache["k"].copy_(k)
    cache["v"].copy_(v)


def cross_decode(params, x, cfg, enc_k, enc_v, *, src_len=None,
                 impl: str = "auto"):
    """Cross-attention during decode: x [b, 1, d] against all rows of the
    static encoder keys and values [b, t, kvh, hd]; nothing is written.
    ``src_len``: the source's rows over all ranks, needed under a mesh
    (``_cache_split``); a cache that is not this rank's placement of them
    raises."""
    axis, _ = _heads(cfg)
    if axis is not None:
        x = shard_ctx.enter(x, axis)
    q = einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    t_loc = enc_k.shape[1]
    split = None
    if shard_ctx.mesh() is not None:
        if src_len is None:
            raise ValueError("cross_decode under a mesh needs src_len")
        split = _cache_split(cfg, src_len)
        want = src_len if split is None else src_len // split[1]
        if t_loc != want:
            raise ValueError(f"cross-attention cache of {t_loc} rows a rank "
                             f"is not this rank's placement of {src_len} "
                             "source rows")
    lens = torch.full((x.shape[0],), t_loc, dtype=torch.int32,
                      device=x.device)
    if split is not None:
        return _split_attend(params, q, enc_k, enc_v, lens, cfg, split[0],
                             impl)
    enc_k, enc_v = _kv_heads(cfg, enc_k, enc_v)
    out = decode_attention(q[:, 0].contiguous(), enc_k, enc_v, lens,
                           impl=impl)
    return _out(params, out[:, None], cfg)


def encode_kv(params, cfg, kv_x):
    """The cross-attention keys and values of ``kv_x`` [b, t, d] (encoder
    output or vision embeddings): ([b, t, kvh, hd], [b, t, kvh, hd])."""
    k = einsum("btd,dhk->bthk", kv_x, params["wk"])
    v = einsum("btd,dhk->bthk", kv_x, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    return k, v
