"""Plain PyTorch versions of the mLSTM (xLSTM's matrix-memory cell).

The port's counterparts of the JAX package's ``kernels/mlstm/ref.py``,
with its operation order: ``logsigmoid`` and ``cumsum`` in f32, the finite
sentinel -1e30 for masked decays, and the denominator
``max(|den|, exp(-m))``.

Recurrent definition (per head, stabilised with the max state m_t):

    logf_t = logsigmoid(f~_t),  logi_t = i~_t
    m_t = max(logf_t + m_{t-1}, logi_t)
    C_t = e^{logf_t + m_{t-1} - m_t} C_{t-1} + e^{logi_t - m_t} v_t k'_t^T
    n_t = e^{logf_t + m_{t-1} - m_t} n_{t-1} + e^{logi_t - m_t} k'_t
    h_t = (C_t q_t) / max(|n_t . q_t|, e^{-m_t})        k' = k / sqrt(d)

The parallel form (the kernel's function, quadratic like attention):

    D~[t,s] = F_t - F_s + logi_s  (s <= t, F = cumsum logf),  m_t = max_s D~
    S = (q k'^T) * exp(D~ - m_t)
    h_t = S v / max(|sum_s S[t,s]|, e^{-m_t})
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import slice_width

NEG_INF = -1e30


def mlstm_parallel_ref(q, k, v, i_gate, f_gate):
    """q, k, v: [b, s, h, d]; i_gate, f_gate: [b, s, h] pre-activations.
    Returns h: [b, s, h, d] in q's dtype."""
    return mlstm_cluster_ref(q, k, v, i_gate, f_gate, 1)


def mlstm_cluster_ref(q, k, v, i_gate, f_gate, n_ranks):
    """``mlstm_parallel_ref`` with the CUDA kernel's cluster schedule of the
    scores: the q.k products are summed over ``n_ranks`` slices of the d
    columns (``kernel.slice_width`` each), in rank order 0, 1, ..., R - 1,
    then scaled, as every CTA of a cluster adds the partials it reads.
    ``n_ranks = 1`` is ``mlstm_parallel_ref``."""
    s, d = q.shape[1], q.shape[3]
    logf = F.logsigmoid(f_gate.float())                       # [b, s, h]
    logi = i_gate.float()
    cum = torch.cumsum(logf, dim=1)
    dtil = cum[:, :, None, :] - cum[:, None, :, :] + logi[:, None, :, :]
    tpos = torch.arange(s, device=q.device)
    causal = tpos[:, None] >= tpos[None, :]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    dtil = torch.where(causal[None, :, :, None], dtil, neg)   # [b, t, s, h]
    m = torch.amax(dtil, dim=2)                               # [b, t, h]
    dec = torch.exp(dtil - m[:, :, None, :])
    dv = slice_width(d, n_ranks)
    qk = None
    for r in range(n_ranks):
        cols = slice(r * dv, min((r + 1) * dv, d))
        part = torch.einsum("bthd,bshd->btsh", q[..., cols].float(),
                            k[..., cols].float())
        qk = part if qk is None else qk + part
    S = (qk * (d ** -0.5)) * dec
    den = torch.sum(S, dim=2)                                 # [b, t, h]
    den = torch.maximum(torch.abs(den), torch.exp(-m))
    out = torch.einsum("btsh,bshd->bthd", S, v.float())
    return (out / den[..., None]).to(q.dtype)


def mlstm_step(q, k, v, i_gate, f_gate, C, n, m):
    """One decode step. q, k, v: [b, h, d]; gates: [b, h]; states C:
    [b, h, d, d], n: [b, h, d], m: [b, h], all f32.

    Unlike the JAX package's ``mlstm_step``, the states are updated in
    place (a served model's C is 16 MB per lane and layer at xlstm-1.3b's
    widths); returns (h [b, h, d] in q's dtype, (C, n, m))."""
    b, h, d = q.shape
    logf = F.logsigmoid(f_gate.float())
    logi = i_gate.float()
    m_new = torch.maximum(logf + m, logi)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(logi - m_new)
    kp = k.float() * (d ** -0.5)
    C.mul_(fp[..., None, None])
    C.view(b * h, d, d).baddbmm_(
        (ip[..., None] * v.float()).reshape(b * h, d, 1),
        kp.reshape(b * h, 1, d))
    n.mul_(fp[..., None]).add_(ip[..., None] * kp)
    m.copy_(m_new)
    q32 = q.float()
    num = torch.matmul(C, q32[..., None])[..., 0]
    den = torch.maximum(torch.abs(torch.sum(n * q32, dim=-1)),
                        torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), (C, n, m)


def mlstm_final_state(k, v, i_gate, f_gate):
    """The recurrent state (C, n, m) after the s tokens of k, v [b, s, h,
    d] and the gates [b, s, h], from the zero state with m = -1e30, in
    closed form:

        m_S = max_s (F_S - F_s + logi_s)
        C_S = sum_s exp(F_S - F_s + logi_s - m_S) v_s k'_s^T
        n_S = sum_s exp(F_S - F_s + logi_s - m_S) k'_s

    This is the state the JAX package's prefill gets by scanning
    ``mlstm_step`` over the sequence (``models/transformer.py``
    ``_mlstm_state_from_seq``; its start from m = -1e30 multiplies the
    cache's C and n by exactly 0), and the state update of its chunkwise
    form (``ref.mlstm_chunkwise_xla``); C is one [d, s] x [s, d] product
    per head."""
    d = k.shape[-1]
    logf = F.logsigmoid(f_gate.float())
    cum = torch.cumsum(logf, dim=1)
    decay = cum[:, -1:, :] - cum + i_gate.float()              # [b, s, h]
    m = torch.amax(decay, dim=1)                               # [b, h]
    w = torch.exp(decay - m[:, None, :])
    kp = k.float() * (d ** -0.5)
    wv = (v.float() * w[..., None]).permute(0, 2, 3, 1)        # [b, h, d, s]
    C = torch.matmul(wv, kp.permute(0, 2, 1, 3))               # [b, h, d, d]
    n = torch.einsum("bsh,bshd->bhd", w, kp)
    return C, n, m


def mlstm_chunkwise_xla(q, k, v, i_gate, f_gate, chunk: int = 256):
    """The chunkwise-parallel mLSTM in plain PyTorch: the JAX package's
    ``mlstm_chunkwise_xla`` (its ``mlstm_impl="chunkwise"``), with its
    operation order. The parallel form within each chunk of ``chunk``
    tokens, and the running state (C, n, m) carried from chunk to chunk
    (a Python loop where the JAX package scans), entering each query with
    the decay exp(F_t + m0). s * (chunk + 2 d) work per head instead of
    s^2, and a [chunk, chunk] decay matrix at most. A sequence that is no
    multiple of ``chunk``, or no longer than one chunk, takes
    ``mlstm_parallel_ref``, as in the JAX package. Same shapes as
    ``mlstm_parallel_ref``; differentiable (no in-place op)."""
    b, s, h, d = q.shape
    if s % chunk != 0 or s <= chunk:
        return mlstm_parallel_ref(q, k, v, i_gate, f_gate)
    scale = d ** -0.5
    logf = F.logsigmoid(f_gate.float())
    logi = i_gate.float()
    tpos = torch.arange(chunk, device=q.device)
    causal = tpos[:, None] >= tpos[None, :]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    C0 = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
    n0 = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m0 = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    outs = []
    for c in range(s // chunk):
        rows = slice(c * chunk, (c + 1) * chunk)
        lf, li = logf[:, rows], logi[:, rows]                 # [b, L, h]
        cum = torch.cumsum(lf, dim=1)
        # Intra-chunk decay, and the carried state's decay F_t + m0.
        dtil = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        dtil = torch.where(causal[None, :, :, None], dtil, neg)
        m_intra = torch.amax(dtil, dim=2)                     # [b, t, h]
        m_inter = cum + m0[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)

        qf = q[:, rows].float()
        kf = k[:, rows].float() * scale
        vf = v[:, rows].float()
        S = torch.einsum("bthd,bshd->btsh", qf, kf) * \
            torch.exp(dtil - m_t[:, :, None, :])
        num = torch.einsum("btsh,bshd->bthd", S, vf)
        den = torch.sum(S, dim=2)
        qw = qf * torch.exp(m_inter - m_t)[..., None]
        # C0[d, e] = v_d k'_e: the query contracts the key index (e).
        num = num + torch.einsum("bthe,bhde->bthd", qw, C0)
        den = den + torch.einsum("bthd,bhd->bth", qw, n0)
        out = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
        outs.append(out.to(q.dtype))

        # The state at the chunk's end (position chunk - 1).
        fc = cum[:, -1, :]                                    # [b, h]
        m1 = torch.maximum(fc + m0, torch.amax(fc[:, None, :] - cum + li,
                                               dim=1))
        wv = torch.exp(fc[:, None, :] - cum + li - m1[:, None, :])
        carry = torch.exp(fc + m0 - m1)
        C0 = C0 * carry[..., None, None] + torch.einsum(
            "bshd,bshe->bhde", wv[..., None] * vf, kf)
        n0 = n0 * carry[..., None] + torch.einsum("bsh,bshd->bhd", wv, kf)
        m0 = m1
    return torch.cat(outs, dim=1)
