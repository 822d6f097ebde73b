"""Plain PyTorch version of (grouped-query) causal attention.

The port's counterpart of the JAX package's ``mha_ref``: f32 scores, a
causal mask with query positions offset by ``q_offset``, an optional
per-sequence ``kv_len``, the finite sentinel -1e30 for masked scores, and
the output in q's dtype. KV heads are expanded with ``repeat_interleave``
(``jnp.repeat``'s order: q head h reads KV head h // g); ``Tensor.repeat``
would tile them in the wrong order.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """[b, t, kvh, d] -> [b, t, h, d], q head i reading KV head i // g."""
    kvh = k.shape[2]
    return k if kvh == h else torch.repeat_interleave(k, h // kvh, dim=2)


def mha_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
            q_offset: int | None = None, kv_len: torch.Tensor | None = None):
    """q: [b, s, h, d]; k, v: [b, t, kvh, d] (h % kvh == 0) -> [b, s, h, d]
    in q's dtype. ``q_offset`` defaults to t - s; keys at index >=
    ``kv_len[b]`` are masked when ``kv_len`` is given."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    k = expand_kv(k, h)
    v = expand_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    if causal:
        off = (t - s) if q_offset is None else q_offset
        q_pos = torch.arange(s, device=q.device)[:, None] + off
        k_pos = torch.arange(t, device=q.device)[None, :]
        scores = torch.where(q_pos >= k_pos, scores, neg)
    if kv_len is not None:
        valid = (torch.arange(t, device=q.device)[None, :]
                 < kv_len.to(q.device)[:, None])
        scores = torch.where(valid[:, None, None, :], scores, neg)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)
