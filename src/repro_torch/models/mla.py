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
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ref import mha_ref
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


def _scale(cfg) -> float:
    return (cfg.mla.nope_dim + cfg.mla.rope_dim) ** -0.5


def _project(params, x, cfg, positions):
    """(q_nope [b, s, h, nope], q_rope [b, s, h, rope], ckv [b, s, kv_lora],
    k_rope [b, s, rope]); the shared rotary key is rotated as one head."""
    m = cfg.mla
    cq = rmsnorm(params["q_norm"], einsum("bsd,dq->bsq", x,
                                          params["q_down"]))
    q = einsum("bsq,qhk->bshk", cq, params["q_up"])
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = einsum("bsd,dq->bsq", x, params["kv_down"])
    ckv = rmsnorm(params["kv_norm"], ckv_full[..., :m.kv_lora])
    k_rope = apply_rope(ckv_full[..., m.kv_lora:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def mla_apply(params, x, cfg, *, causal: bool = True, cache=None):
    """Full-sequence MLA in the expanded form over x [b, s, d] at positions
    0..s-1. ``cache``: when given (prefill), the latent and the rotary key
    are written at offset 0 in place and ``(y, cache)`` is returned."""
    m = cfg.mla
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, ckv, k_rope = _project(params, x, cfg, positions)
    k_nope = einsum("btq,qhk->bthk", ckv, params["k_up"])
    v = einsum("btq,qhk->bthk", ckv, params["v_up"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, cfg.n_heads, m.rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = mha_ref(q, k, v, causal=causal, scale=_scale(cfg))
    y = einsum("bshk,hkd->bsd", out, params["wo"])
    if cache is None:
        return y
    if s > cache["ckv"].shape[1]:
        raise ValueError(f"prefill of {s} tokens exceeds the cache's "
                         f"{cache['ckv'].shape[1]} positions")
    cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, :s] = k_rope.to(cache["krope"].dtype)
    return y, cache


def mla_decode(params, x, cfg, cache, lens):
    """Absorbed-form single-token decode. x: [b, 1, d]; lens: int32 [b]
    cache fill. Writes the new latent and rotary key at ``lens`` in place
    and attends over the ``lens + 1`` first rows. Returns (y [b, 1, d],
    cache)."""
    q_nope, q_rope, ckv_new, k_rope_new = _project(params, x, cfg,
                                                   lens[:, None])
    scatter_kv(cache["ckv"], ckv_new[:, 0], lens)
    scatter_kv(cache["krope"], k_rope_new[:, 0], lens)
    # k_up folded into the query: q_eff [b, h, kv_lora].
    q_eff = einsum("bhk,qhk->bhq", q_nope[:, 0], params["k_up"])
    ckv_c = cache["ckv"].float()
    kr_c = cache["krope"].float()
    scores = (torch.einsum("bhq,btq->bht", q_eff.float(), ckv_c)
              + torch.einsum("bhk,btk->bht", q_rope[:, 0].float(), kr_c)
              ) * _scale(cfg)
    t = ckv_c.shape[1]
    valid = (torch.arange(t, device=x.device)[None, None, :]
             < (lens + 1)[:, None, None])
    scores = torch.where(valid, scores,
                         torch.tensor(NEG_INF, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,btq->bhq", probs, ckv_c)       # latent context
    out = einsum("bhq,qhk->bhk", ctx.to(x.dtype), params["v_up"])
    y = einsum("bhk,hkd->bd", out, params["wo"])[:, None]
    return y, cache
