"""Plain PyTorch version of (grouped-query) causal attention.

The port's counterpart of the JAX package's ``mha_ref``: f32 scores, a
causal mask with query positions offset by ``q_offset``, an optional
per-sequence ``kv_len``, the finite sentinel -1e30 for masked scores, and
the output in q's dtype. KV heads are expanded with ``repeat_interleave``
(``jnp.repeat``'s order: q head h reads KV head h // g); ``Tensor.repeat``
would tile them in the wrong order.

``flash_tiled_ref`` and ``split_tf32`` are the plain versions of the CUDA
kernel's schedule and of its operand split, for the tests; nothing on the
main path calls them.
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


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 x -> (hi, lo) as the kernel splits an operand for 3xTF32: hi is
    x rounded to TF32 (10 mantissa bits, ties away from zero) by adding
    2^12 to the bit pattern and clearing its 13 low bits; lo = x - hi,
    which is exact."""
    x = x.float().contiguous()
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def flash_tiled_ref(q, k, v, *, block_q: int, block_k: int,
                    causal: bool = True, q_offset: int | None = None,
                    scale: float | None = None):
    """The kernel's schedule in plain f32: query tiles of ``block_q`` rows
    (longest first, as launched), each walking KV tiles of ``block_k`` keys
    with the online softmax (running max, denominator and accumulator),
    tiles wholly above the causal diagonal skipped, and a tile skipped by a
    group of 16 rows (a warp) whose last position precedes its first key
    (rows beyond s are not computed at all).
    Masked scores take NEG_INF, keys beyond t read zero rows, and the row is
    acc / max(l, 1e-30). Shapes and the result as ``mha_ref``'s. Rows with
    no visible key average the keys of the tiles they walked, where
    ``mha_ref`` averages all t."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    off = (t - s) if q_offset is None else q_offset
    n_kv = -(-t // block_k)
    pad = (0, 0, 0, 0, 0, n_kv * block_k - t)
    kx = torch.nn.functional.pad(expand_kv(k, h).float(), pad)
    vx = torch.nn.functional.pad(expand_kv(v, h).float(), pad)
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    for qi in reversed(range(-(-s // block_q))):
        q0 = qi * block_q
        nr = min(block_q, s - q0)
        qt = q[:, q0:q0 + nr].float()
        pos = torch.arange(nr, device=q.device) + q0 + off
        group_last = (torch.arange(nr, device=q.device) // 16 * 16 + 15
                      + q0 + off)
        n_tiles = n_kv
        if causal:
            last = q0 + block_q - 1 + off
            n_tiles = min(n_tiles, 0 if last < 0 else last // block_k + 1)
        m = torch.full((b, h, nr), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, nr, d), dtype=torch.float32,
                          device=q.device)
        for kt in range(n_tiles):
            k0 = kt * block_k
            keys = torch.arange(k0, k0 + block_k, device=q.device)
            sc = torch.einsum("bshd,bthd->bhst", qt,
                              kx[:, k0:k0 + block_k]) * scale
            masked = (keys >= t)[None, :]
            if causal:
                masked = masked | (keys[None, :] > pos[:, None])
            sc = torch.where(masked, neg, sc)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l_new = l * alpha + p.sum(-1)
            acc_new = acc * alpha[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p, vx[:, k0:k0 + block_k])
            live = (k0 <= group_last) if causal else torch.ones_like(
                group_last, dtype=torch.bool)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live[:, None], acc_new, acc)
        rows = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + nr] = rows.permute(0, 2, 1, 3)
    return out.to(q.dtype)
