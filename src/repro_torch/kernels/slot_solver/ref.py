"""Plain PyTorch versions of the slot-solver kernels.

``config_argmin_ref`` is the Algorithm-1 line-3 exhaustive search written
as ``repro.kernels.slot_solver.ref.config_argmin_ref`` writes it: the full
``[N, M, R, 2]`` score tensor and one flat argmin per camera.
``baseline_argmax_ref`` is the DOS/JCAB configuration scan the same way
(``[N, M, R]`` tensors, one flat argmax). The water-fills' plain versions,
untiled and tiled alike, are ``repro_torch.core.allocate``'s
``waterfill_bandwidth``, ``waterfill_compute`` and ``waterfill_pair``.

``config_argmin_lanes_ref`` and ``baseline_argmax_lanes_ref`` compute the
same per-entry values and fold them in the CUDA kernels' order (a team of
lanes per camera, then a butterfly); the tests hold them to the flat
versions bitwise, on inputs from ``tied_scan_inputs`` too.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import aopi

NO_INDEX = 2 ** 31 - 1       # the kernels' kNoIndex: a lane with no entry


def _config_scores(b, c, acc, xi, size, eff, q, v, n_total):
    """The ``[N, M, R, 2]`` score tensor of ``config_argmin_ref``."""
    lam = (b * eff)[:, None] / size[None, :]
    mu = c[:, None, None] / xi[None, :, :]
    lam_b = lam[:, None, :].expand(mu.shape)
    p = torch.clamp_min(acc, 1e-3)
    a = torch.stack([aopi.aopi_fcfs(lam_b, mu, p),
                     aopi.aopi_lcfsp(lam_b, mu, p)], dim=-1)  # [n, m, r, 2]
    # A device tensor, not a Python number: CUDA divides by a host scalar
    # as a multiplication by its reciprocal, which rounds differently.
    n_t = torch.full((), float(n_total), dtype=a.dtype, device=a.device)
    return (v * a - q * acc[..., None]) / n_t


def _config_indices(best, n_r):
    m_idx = torch.div(best, n_r * 2, rounding_mode="floor").to(torch.int32)
    r_idx = (torch.div(best, 2, rounding_mode="floor") % n_r).to(torch.int32)
    pol = (best % 2).to(torch.int32)
    return r_idx, m_idx, pol


def config_argmin_ref(b, c, acc, xi, size, eff, q, v, n_total):
    """Per-camera ``(r_idx, m_idx, pol)`` minimizing
    ``(V * AoPI - q * acc) / n_total`` over (model, resolution, policy);
    ties go to the first flat index in (m, r, policy) order."""
    score = _config_scores(b, c, acc, xi, size, eff, q, v, n_total)
    best = torch.argmin(score.reshape(score.shape[0], -1), dim=1)
    return _config_indices(best, xi.shape[1])


def _precedes(v, f, w, g, largest: bool):
    """The kernels' total order on (value, flat index): the smaller (or,
    ``largest``, the larger) value first, then the smaller index."""
    return ((v > w) if largest else (v < w)) | ((v == w) & (f < g))


def _lane_fold(val, flat, lanes: int, largest: bool):
    """Fold ``[N, E]`` (value, flat index) pairs as a team of ``lanes``
    lanes does: lane l meets entries l, l + lanes, ... in order, starting
    from (-inf or +inf, its first entry's index, or ``NO_INDEX`` without
    one) and taking an entry only where its value is strictly greater
    (smaller); then butterfly step k takes lane l ^ 2^k's pair where it
    precedes in the total order (the value, then the index). Returns lane
    0's pair."""
    if lanes < 1 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"lanes={lanes}: a power of two up to 32")
    n, e = val.shape
    k = -(-e // lanes)
    ident = float("-inf") if largest else float("inf")
    val = torch.nn.functional.pad(val, (0, k * lanes - e), value=ident)
    flat = torch.nn.functional.pad(flat.expand(n, e), (0, k * lanes - e),
                                   value=NO_INDEX)
    val, flat = val.view(n, k, lanes), flat.view(n, k, lanes)
    best_v = torch.full((n, lanes), ident, dtype=val.dtype,
                        device=val.device)
    best_f = flat[:, 0].clone()
    for step in range(k):              # padding is the identity: a no-op
        v = val[:, step]
        take = (v > best_v) if largest else (v < best_v)
        best_v = torch.where(take, v, best_v)
        best_f = torch.where(take, flat[:, step], best_f)
    lane = torch.arange(lanes, device=val.device)
    off = 1
    while off < lanes:
        v, f = best_v[:, lane ^ off], best_f[:, lane ^ off]
        take = _precedes(v, f, best_v, best_f, largest)
        best_v, best_f = torch.where(take, v, best_v), torch.where(take, f,
                                                                   best_f)
        off *= 2
    return best_v[:, 0], best_f[:, 0]


def config_argmin_lanes_ref(b, c, acc, xi, size, eff, q, v, n_total, *,
                            lanes: int):
    """``config_argmin_ref`` folded in ``config_argmin_kernel``'s order:
    per (m, r) the FCFS/LCFSP pair decided as there (LCFSP only if
    strictly lower), then the flat (m, r) entries over ``lanes`` lanes
    (``_lane_fold``)."""
    score = _config_scores(b, c, acc, xi, size, eff, q, v, n_total)
    n = score.shape[0]
    s_f, s_l = score[..., 0].reshape(n, -1), score[..., 1].reshape(n, -1)
    l_wins = s_l < s_f
    j = torch.arange(s_f.shape[1], device=score.device)
    _, best = _lane_fold(torch.where(l_wins, s_l, s_f),
                         2 * j + l_wins.long(), lanes, largest=False)
    return _config_indices(best, xi.shape[1])


def _latency(b, c, xi, size, eff):
    lam = (b * eff)[:, None, None] / size[None, None, :]
    mu = c[:, None, None] / xi[None, :, :]
    return (1.0 / torch.clamp_min(lam, 1e-9) +
            1.0 / torch.clamp_min(mu, 1e-9))


def baseline_argmax_ref(b, c, acc, xi, size, eff, *, mode, threshold):
    """DOS/JCAB configuration scans, per camera ``(m_idx, r_idx)``.

    ``mode="dos"``: argmax of ``acc - threshold * latency``;
    ``mode="jcab"``: argmax of ``acc`` over configs with ``latency <=
    threshold``, else the min-latency config. ``latency = 1/max(lam, 1e-9)
    + 1/max(mu, 1e-9)``; ties go to the first flat (m-major) index.
    """
    n = acc.shape[0]
    n_r = xi.shape[1]
    latency = _latency(b, c, xi, size, eff)                  # [n, m, r]
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


def baseline_argmax_lanes_ref(b, c, acc, xi, size, eff, *, mode, threshold,
                              lanes: int):
    """``baseline_argmax_ref`` folded in ``baseline_argmax_kernel``'s
    order over ``lanes`` lanes (``_lane_fold``): DOS's and JCAB's scores
    by the larger value, JCAB's latencies by the smaller, and JCAB's
    fallback where the folded best value is -inf."""
    n = acc.shape[0]
    n_r = xi.shape[1]
    latency = _latency(b, c, xi, size, eff).reshape(n, -1)
    a = acc.reshape(n, -1)
    j = torch.arange(a.shape[1], device=a.device)
    if mode == "dos":
        _, best = _lane_fold(a - threshold * latency, j, lanes, largest=True)
    elif mode == "jcab":
        score = torch.where(latency <= threshold, a,
                            torch.full_like(a, float("-inf")))
        best_v, best = _lane_fold(score, j, lanes, largest=True)
        _, fallback = _lane_fold(latency, j, lanes, largest=False)
        best = torch.where(best_v == float("-inf"), fallback, best)
    else:
        raise ValueError(f"unknown baseline scan mode {mode!r}")
    m_idx = torch.div(best, n_r, rounding_mode="floor").to(torch.int32)
    return m_idx, (best % n_r).to(torch.int32)


# Planted ties (tied_scan_inputs): models 1 and 3, resolutions 2 and 4.
TIED_MODELS = (1, 3)
TIED_RESOLUTIONS = (2, 4)


def tied_scan_inputs(n: int, seed: int = 0):
    """Scan inputs ``(b, c, acc, xi, size, eff)`` as float32 numpy arrays
    (M=9, R=6) with exact ties planted, to hold the scans to their
    first-index rule: models 1 and 3 have identical xi rows and accuracy
    columns, resolutions 2 and 4 identical size, xi columns and
    accuracies, so their entries' scores are the same floats. Every
    camera has the same rates (latencies repeat across cameras), except
    that every fourth (i % 4 == 3) has b = 0 (every config_argmin score
    +inf, every latency ~1e9); every third (i % 3 == 0) has its best
    accuracy, 0.999, on the four tied entries; camera 1's accuracies are
    all zero, -0.0 at flat 0. Model 1's and 3's first resolution has the
    least latency of all entries (``tied_jcab_cap``)."""
    rng = np.random.default_rng(seed)
    m1, m3 = TIED_MODELS
    r2, r4 = TIED_RESOLUTIONS
    xi = np.sort(rng.uniform(1e9, 2e11, (9, 6)), axis=1)
    xi[m1, 0] = 0.5 * xi.min()
    xi[m3] = xi[m1]
    xi[:, r4] = xi[:, r2]
    size = 1.2 * np.array([160.0, 224.0, 320.0, 416.0, 320.0, 608.0]) ** 2
    acc = rng.uniform(0.2, 0.95, (n, 9, 6))
    acc[::3, m1, r2] = 0.999
    acc[:, m3] = acc[:, m1]
    acc[:, :, r4] = acc[:, :, r2]
    if n > 1:
        acc[1] = 0.0
        acc[1, 0, 0] = -0.0
    b = np.full(n, 5e6)
    b[3::4] = 0.0
    c = np.full(n, 5e12)
    eff = np.full(n, 5.5)
    return tuple(np.asarray(x, np.float32) for x in (b, c, acc, xi, size,
                                                      eff))


def tied_jcab_cap(b, c, xi, size, eff) -> float:
    """The JCAB cap that exactly the tied pair (models 1 and 3 at the
    first resolution) meets on ``tied_scan_inputs``' cameras with b > 0:
    their latency, as ``baseline_argmax_ref`` computes it."""
    i = int(np.flatnonzero(np.asarray(b) > 0)[0])
    lat = _latency(*(torch.as_tensor(np.asarray(x)[i:i + 1] if k < 2 else x)
                     for k, x in enumerate((b, c))),
                   torch.as_tensor(xi), torch.as_tensor(size),
                   torch.as_tensor(np.asarray(eff)[i:i + 1]))
    return float(lat[0, TIED_MODELS[0], 0])
