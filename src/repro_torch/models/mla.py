"""Multi-head latent attention (MiniCPM3 / DeepSeek-V2 style).

KV is compressed into a small latent c_kv (kv_lora dims) plus a shared
rotary key (rope_dim dims): the decode cache is [b, t, kv_lora] and
[b, t, rope_dim].

Prefill uses the expanded form: the latent is projected back to per-head
keys and values and attended by the plain ``mha_ref``. Decode uses the
absorbed form: ``k_up`` is folded into the query, the scores are taken
over the cached latent and rotary key in f32, and ``v_up`` is applied
after the softmax, so the cache is read once. The JAX package computes
both forms with ``mha_ref`` and einsums in every ``impl`` (no Pallas
kernel lies on this path), and so does the port: no kernel launches here.
Its q/k head dim (nope + rope) and v head dim differ, which the flash
attention kernel's contract (v shaped as k) does not take anyway.

The cache is written in place, as the GQA cache is.

The decode's softmax is taken as partials, the running max m, the
denominator l and the unnormalised latent context acc of a block of
rows, merged over blocks (``_partials``, ``_merge``): on one card over
one block, the cache's. Under a mesh (``sharding.ctx``) the query and
output heads (``q_up``, ``k_up``, ``v_up``, ``wo``) are split over the
``heads`` rule's axis, the ``lora`` projections and norms replicated, and
``wo``'s partial sum is all-reduced. Where the rules split the latent
cache's rows (``cache_seq``), each rank holds rows [off, off + t_loc) of
every sequence: the prefill writes the prompt's rows of its block, and
the decode gathers the query heads, takes the partials of every head
over its rows, exchanges them so that each rank holds every rank's
partials of its own heads (``attention``'s split decode, with an
``acc`` of width ``kv_lora``) and merges them in row order.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ref import mha_ref
from ..sharding import ctx as shard_ctx
from ..sharding.spec import mesh_dims
from .attention import scatter_kv
from .common import CACHE_SEQ, EMBED, HEAD_DIM, HEADS, LORA, P
from .layers import apply_rope, einsum, rmsnorm, rmsnorm_template

NEG_INF = -1e30


def mla_template(cfg):
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    return {
        "q_down": P((d, m.q_lora), (EMBED, LORA)),
        "q_norm": rmsnorm_template(m.q_lora),
        "q_up": P((m.q_lora, h, m.nope_dim + m.rope_dim),
                  (LORA, HEADS, HEAD_DIM)),
        "kv_down": P((d, m.kv_lora + m.rope_dim), (EMBED, LORA)),
        "kv_norm": rmsnorm_template(m.kv_lora),
        "k_up": P((m.kv_lora, h, m.nope_dim), (LORA, HEADS, HEAD_DIM)),
        "v_up": P((m.kv_lora, h, m.v_dim), (LORA, HEADS, HEAD_DIM)),
        "wo": P((h, m.v_dim, d), (HEADS, HEAD_DIM, EMBED)),
    }


def mla_cache_template(cfg, batch: int, max_len: int, dtype=None):
    m = cfg.mla
    return {"ckv": P((batch, max_len, m.kv_lora),
                     ("batch", CACHE_SEQ, LORA), init="zeros", dtype=dtype),
            "krope": P((batch, max_len, m.rope_dim),
                       ("batch", CACHE_SEQ, HEAD_DIM), init="zeros",
                       dtype=dtype)}


def cache_rows_axis(rules: dict):
    """The mesh axis the latent cache's rows split over under ``rules``,
    or None (its own placement: ``mesh_dims`` over its dims)."""
    return mesh_dims((1 << 30, 1 << 30, 1), ("batch", CACHE_SEQ, LORA),
                     rules)[1]


def _cache_split():
    """(mesh axis, extent, this rank's index) of the latent cache rows'
    split, or None. The cache's length is taken to divide the axis
    (``launch.specs.plan_cell`` refuses one that does not)."""
    if shard_ctx.mesh() is None:
        return None
    return shard_ctx.split_of(cache_rows_axis(shard_ctx.current()))


def _heads_axis(cfg):
    """The mesh axis the heads are split over, or None."""
    return shard_ctx.axis_for(HEADS, cfg.n_heads)


def _scale(cfg) -> float:
    return (cfg.mla.nope_dim + cfg.mla.rope_dim) ** -0.5


def _project(params, x, cfg, positions, axis=None):
    """(q_nope [b, s, h, nope], q_rope [b, s, h, rope], ckv [b, s, kv_lora],
    k_rope [b, s, rope]) of the rank's heads; the shared rotary key is
    rotated as one head. Under a mesh the replicated latents enter the
    head-split products there, so the gradients of the replicated
    projections and norms are whole on every rank."""
    m = cfg.mla
    cq = rmsnorm(params["q_norm"], einsum("bsd,dq->bsq", x,
                                          params["q_down"]))
    if axis is not None:
        cq = shard_ctx.enter(cq, axis)
    q = einsum("bsq,qhk->bshk", cq, params["q_up"])
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = einsum("bsd,dq->bsq", x, params["kv_down"])
    ckv = rmsnorm(params["kv_norm"], ckv_full[..., :m.kv_lora])
    k_rope = apply_rope(ckv_full[..., m.kv_lora:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    if axis is not None:
        ckv, k_rope = shard_ctx.enter(ckv, axis), shard_ctx.enter(k_rope,
                                                                  axis)
    return q_nope, q_rope, ckv, k_rope


def _out(params, out, axis, eq):
    y = einsum(eq, out, params["wo"])
    return shard_ctx.exit_stream(y, axis)


def mla_apply(params, x, cfg, *, causal: bool = True, cache=None):
    """Full-sequence MLA in the expanded form over x [b, s, d] at positions
    0..s-1. ``cache``: when given (prefill), the latent and the rotary key
    are written at offset 0 in place (the rows of this rank's block where
    the rules split them) and ``(y, cache)`` is returned."""
    m = cfg.mla
    # The replicated latent projections read the whole sequence; their
    # outputs enter the head-split products (``_project``), so the
    # gradient of the input is whole on every rank.
    x = shard_ctx.enter_stream(x, None)
    b, s, _ = x.shape
    axis = _heads_axis(cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, ckv, k_rope = _project(params, x, cfg, positions, axis)
    k_nope = einsum("btq,qhk->bthk", ckv, params["k_up"])
    v = einsum("btq,qhk->bthk", ckv, params["v_up"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, k_nope.shape[2], m.rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = mha_ref(q, k, v, causal=causal, scale=_scale(cfg))
    y = _out(params, out, axis, "bshk,hkd->bsd")
    if cache is None:
        return y
    t_loc = cache["ckv"].shape[1]
    split = _cache_split()
    extent, rank = (1, 0) if split is None else split[1:]
    if s > t_loc * extent:
        raise ValueError(f"prefill of {s} tokens exceeds the cache's "
                         f"{t_loc * extent} positions")
    lo = rank * t_loc
    hi = min(lo + t_loc, s)
    if hi > lo:
        cache["ckv"][:, :hi - lo] = ckv[:, lo:hi].to(cache["ckv"].dtype)
        cache["krope"][:, :hi - lo] = k_rope[:, lo:hi].to(
            cache["krope"].dtype)
    return y, cache


def _partials(q_eff, q_rope, ckv, krope, kv_len, scale):
    """The softmax partials of every query head over one block of latent
    rows: [b, h, 2 + kv_lora] = (m, l, acc), in f32. q_eff [b, h, kv_lora]
    and q_rope [b, h, rope] against ckv [b, t, kv_lora] and krope [b, t,
    rope]; the rows at or beyond kv_len [b] are masked. A block with no
    row below kv_len carries m = -1e30, and the merge weighs it by 0."""
    ckv, krope = ckv.float(), krope.float()
    scores = (torch.einsum("bhq,btq->bht", q_eff.float(), ckv)
              + torch.einsum("bhk,btk->bht", q_rope.float(), krope)) * scale
    t = ckv.shape[1]
    valid = (torch.arange(t, device=ckv.device)[None, None, :]
             < kv_len[:, None, None])
    scores = torch.where(valid, scores,
                         torch.tensor(NEG_INF, device=ckv.device))
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    acc = torch.einsum("bht,btq->bhq", p, ckv)
    return torch.cat([m, torch.sum(p, dim=-1, keepdim=True), acc], dim=-1)


def _merge(ws):
    """The latent context [b, h, kv_lora] from the partials [b, h, n, 2 +
    kv_lora] of n blocks of rows."""
    ws = ws.contiguous()
    m, l, acc = ws[..., :1], ws[..., 1:2], ws[..., 2:]
    w = torch.exp(m - torch.amax(m, dim=2, keepdim=True))
    return (torch.sum(acc * w, dim=2) / torch.sum(l * w, dim=2)).contiguous()


def mla_decode(params, x, cfg, cache, lens):
    """Absorbed-form single-token decode. x: [b, 1, d]; lens: int32 [b]
    cache fill. Writes the new latent and rotary key at ``lens`` in place
    and attends over the ``lens + 1`` first rows. Returns (y [b, 1, d],
    cache)."""
    axis = _heads_axis(cfg)
    q_nope, q_rope, ckv_new, k_rope_new = _project(params, x, cfg,
                                                   lens[:, None], axis)
    split = _cache_split()
    off = 0 if split is None else split[2] * cache["ckv"].shape[1]
    # The new row lands in the block that holds position lens.
    scatter_kv(cache["ckv"], ckv_new[:, 0], lens - off)
    scatter_kv(cache["krope"], k_rope_new[:, 0], lens - off)
    # k_up folded into the query: q_eff [b, h, kv_lora].
    q_eff = einsum("bhk,qhk->bhq", q_nope[:, 0], params["k_up"]).contiguous()
    q_rope = q_rope[:, 0].contiguous()
    kv_len = lens + 1 - off
    if split is None:
        ws = _partials(q_eff, q_rope, cache["ckv"], cache["krope"], kv_len,
                       _scale(cfg))[:, :, None]
    else:
        rows = split[0]
        if axis is not None:
            q_eff = shard_ctx.all_gather(q_eff, axis, dim=1,
                                         partial_grad=False)
            q_rope = shard_ctx.all_gather(q_rope, axis, dim=1,
                                          partial_grad=False)
        ws = _partials(q_eff, q_rope, cache["ckv"], cache["krope"], kv_len,
                       _scale(cfg))[:, :, None]
        if axis == rows:
            # Each rank keeps its heads' partials from every rank, in rank
            # order: the blocks in row order.
            ws = shard_ctx.all_to_all(ws, rows, 1, 2)
        else:
            ws = shard_ctx.all_gather(ws, rows, dim=2, partial_grad=False)
            if axis is not None:
                ws = shard_ctx.slice_dim(ws, axis, 1, shard_ctx.mesh())
    ctx = _merge(ws)                                       # latent context
    out = einsum("bhq,qhk->bhk", ctx.to(x.dtype), params["v_up"])
    return _out(params, out, axis, "bhk,hkd->bd")[:, None], cache
