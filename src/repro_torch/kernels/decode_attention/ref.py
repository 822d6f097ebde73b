"""Plain PyTorch version of single-token decode attention over a KV cache.

It equals the JAX package's ``decode_ref`` wherever ``kv_len > 0``. At
``kv_len = 0`` it follows the TPU kernel ``flash_decode`` and the port's
CUDA kernel, which run no cache block and return zeros; ``decode_ref``
there takes a softmax over an all-masked row and returns the mean of V
(ROADMAP queue 3).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_ref(q, k_cache, v_cache, kv_len):
    """q: [b, h, d]; caches: [b, t, kvh, d]; kv_len: int [b] -> [b, h, d]
    in q's dtype. Keys at index >= kv_len are masked; a sequence with
    kv_len = 0 gives zeros."""
    b, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = d ** -0.5
    if g > 1:
        k_cache = torch.repeat_interleave(k_cache, g, dim=2)
        v_cache = torch.repeat_interleave(v_cache, g, dim=2)
    scores = torch.einsum("bhd,bthd->bht", q.float() * scale,
                          k_cache.float())
    kv_len = kv_len.to(q.device)
    valid = torch.arange(t, device=q.device)[None, :] < kv_len[:, None]
    scores = torch.where(valid[:, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs, v_cache.float())
    out = torch.where((kv_len > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)
