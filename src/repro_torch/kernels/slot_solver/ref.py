"""Plain PyTorch versions of the slot-solver kernels.

``config_argmin_ref`` is the Algorithm-1 line-3 exhaustive search written
as ``repro.kernels.slot_solver.ref.config_argmin_ref`` writes it: the full
``[N, M, R, 2]`` score tensor and one flat argmin per camera.
``baseline_argmax_ref`` is the DOS/JCAB configuration scan the same way
(``[N, M, R]`` tensors, one flat argmax). The water-fills' plain versions,
untiled and tiled alike, are ``repro_torch.core.allocate``'s
``waterfill_bandwidth``, ``waterfill_compute`` and ``waterfill_pair``.
"""
from __future__ import annotations

import torch

from ...core import aopi


def config_argmin_ref(b, c, acc, xi, size, eff, q, v, n_total):
    """Per-camera ``(r_idx, m_idx, pol)`` minimizing
    ``(V * AoPI - q * acc) / n_total`` over (model, resolution, policy);
    ties go to the first flat index in (m, r, policy) order."""
    lam = (b * eff)[:, None] / size[None, :]
    mu = c[:, None, None] / xi[None, :, :]
    lam_b = lam[:, None, :].expand(mu.shape)
    p = torch.clamp_min(acc, 1e-3)
    a = torch.stack([aopi.aopi_fcfs(lam_b, mu, p),
                     aopi.aopi_lcfsp(lam_b, mu, p)], dim=-1)  # [n, m, r, 2]
    # A device tensor, not a Python number: CUDA divides by a host scalar
    # as a multiplication by its reciprocal, which rounds differently.
    n_t = torch.full((), float(n_total), dtype=a.dtype, device=a.device)
    score = (v * a - q * acc[..., None]) / n_t
    best = torch.argmin(score.reshape(score.shape[0], -1), dim=1)
    n_r = xi.shape[1]
    m_idx = torch.div(best, n_r * 2, rounding_mode="floor").to(torch.int32)
    r_idx = (torch.div(best, 2, rounding_mode="floor") % n_r).to(torch.int32)
    pol = (best % 2).to(torch.int32)
    return r_idx, m_idx, pol


def baseline_argmax_ref(b, c, acc, xi, size, eff, *, mode, threshold):
    """DOS/JCAB configuration scans, per camera ``(m_idx, r_idx)``.

    ``mode="dos"``: argmax of ``acc - threshold * latency``;
    ``mode="jcab"``: argmax of ``acc`` over configs with ``latency <=
    threshold``, else the min-latency config. ``latency = 1/max(lam, 1e-9)
    + 1/max(mu, 1e-9)``; ties go to the first flat (m-major) index.
    """
    n = acc.shape[0]
    n_r = xi.shape[1]
    lam = (b * eff)[:, None, None] / size[None, None, :]
    mu = c[:, None, None] / xi[None, :, :]
    latency = (1.0 / torch.clamp_min(lam, 1e-9) +
               1.0 / torch.clamp_min(mu, 1e-9))               # [n, m, r]
    if mode == "dos":
        best = torch.argmax((acc - threshold * latency).reshape(n, -1), dim=1)
    elif mode == "jcab":
        ok = latency <= threshold
        score = torch.where(ok, acc, torch.full_like(acc, float("-inf")))
        best = torch.argmax(score.reshape(n, -1), dim=1)
        fallback = torch.argmin(latency.reshape(n, -1), dim=1)
        best = torch.where(ok.reshape(n, -1).any(dim=1), best, fallback)
    else:
        raise ValueError(f"unknown baseline scan mode {mode!r}")
    m_idx = torch.div(best, n_r, rounding_mode="floor").to(torch.int32)
    return m_idx, (best % n_r).to(torch.int32)
