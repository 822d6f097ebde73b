"""Plain PyTorch version of single-token decode attention over a KV cache.

It equals the JAX package's ``decode_ref`` wherever ``kv_len > 0``. At
``kv_len = 0`` it follows the TPU kernel ``flash_decode`` and the port's
CUDA kernel, which run no cache block and return zeros; ``decode_ref``
there takes a softmax over an all-masked row and returns the mean of V
(ROADMAP queue 3). ``decode_partials_ref`` and ``combine_partials`` are the
CUDA kernel's two passes (per-split partial softmaxes, then their
combination), and ``decode_split_ref`` the two in turn; a sequence-sharded
cache runs the first on each rank's rows and the second on every rank's
partials. The tests hold them against the JAX package.
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


def combine_partials(m, l, acc):
    """The combine pass of the split kernel. m, l: f32 [..., n_split], each
    split's running max and denominator; acc: f32 [..., n_split, d], its
    unnormalised P.V sum. Returns f32 [..., d]:

        m* = max_i m_i,  l = sum_i l_i e^{m_i - m*},
        out = sum_i acc_i e^{m_i - m*} / max(l, 1e-30).

    An empty split (l_i = 0, written where the split starts at or beyond
    kv_len) carries no weight, so a sequence with no live split gives
    zeros."""
    live = l > 0
    neg = torch.tensor(NEG_INF, dtype=m.dtype, device=m.device)
    m_star = torch.where(live, m, neg).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - m_star), torch.zeros_like(m))
    den = torch.sum(l * w, dim=-1)
    num = torch.where(live[..., None], acc * w[..., None],
                      torch.zeros_like(acc)).sum(-2)
    return num / torch.clamp(den, min=1e-30)[..., None]


def decode_partials_ref(q, k_cache, v_cache, kv_len, n_split, chunk=None):
    """The split pass in plain PyTorch: split i takes cache rows [i *
    chunk, (i + 1) * chunk) (chunk = ceil(t / n_split) unless given) and
    computes its partial softmax over its keys below ``kv_len`` (clamped
    to [0, t]). Returns (m, l) f32 [b, h, n_split] and acc f32 [b, h,
    n_split, d], the input of ``combine_partials``. An empty split (it
    starts at or beyond kv_len; every split where kv_len <= 0) gives m =
    NEG_INF, l = 0 and acc = 0."""
    b, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    chunk = -(-t // n_split) if chunk is None else chunk
    if (n_split - 1) * chunk >= max(t, 1) or n_split * chunk < t:
        raise ValueError(f"{n_split} splits of {chunk} rows do not cover "
                         f"a cache of {t}")
    pad = n_split * chunk - t
    k = torch.repeat_interleave(k_cache.float(), g, dim=2)
    v = torch.repeat_interleave(v_cache.float(), g, dim=2)
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scores = torch.einsum("bhd,bthd->bht", q.float() * d ** -0.5, k)
    kv_len = kv_len.to(q.device)
    valid = (torch.arange(n_split * chunk, device=q.device)[None, :]
             < kv_len.clamp(0, t)[:, None])                  # [b, T]
    neg = torch.tensor(NEG_INF, device=q.device)
    scores = torch.where(valid[:, None, :], scores, neg)
    scores = scores.reshape(b, h, n_split, chunk)
    live = valid.reshape(b, 1, n_split, chunk).any(-1)       # [b, 1, n]
    m = scores.amax(-1)                                      # [b, h, n]
    p = torch.exp(scores - m[..., None])
    l = torch.where(live, p.sum(-1), torch.zeros_like(m))
    m = torch.where(live, m, neg)
    acc = torch.einsum("bhnc,bnchd->bhnd", p,
                       v.reshape(b, n_split, chunk, h, d))
    acc = torch.where(live[..., None], acc, torch.zeros_like(acc))
    return m, l, acc


def decode_split_ref(q, k_cache, v_cache, kv_len, n_split, chunk=None):
    """The split kernel's schedule in plain PyTorch: ``decode_partials_ref``
    then ``combine_partials``. Same shapes and result as ``decode_ref``,
    with the kernel's order of sums."""
    m, l, acc = decode_partials_ref(q, k_cache, v_cache, kv_len, n_split,
                                    chunk)
    return combine_partials(m, l, acc).to(q.dtype)
