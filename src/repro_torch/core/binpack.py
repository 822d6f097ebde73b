"""Algorithm 2 — edge-server selection as 2D first-fit bin packing.

Cameras are sized by Eq. (56), servers by Eq. (57), both sorted
descending; each camera goes to the first server with enough remaining
bandwidth AND compute, or, if none fits, to the server with the most
remaining volume (lines 4-9).

  * ``first_fit``       - host numpy version (the per-slot controller path);
  * ``first_fit_torch`` - tensor version on the tensors' device, written after
    ``repro.core.binpack.first_fit_jax``: one loop step per camera with no
    host synchronisation, so on the card it is bound by launch overhead;
  * ``hierarchical_first_fit`` - host first-fit over pods, then over the
    islands of each pod (beyond the paper).
"""
from __future__ import annotations

import numpy as np
import torch


def first_fit(b_hat: np.ndarray, c_hat: np.ndarray,
              budgets_b: np.ndarray, budgets_c: np.ndarray) -> np.ndarray:
    """Assign cameras to servers on the host. Returns int32[N] server ids."""
    b_hat = np.asarray(b_hat, np.float64)
    c_hat = np.asarray(c_hat, np.float64)
    budgets_b = np.asarray(budgets_b, np.float64)
    budgets_c = np.asarray(budgets_c, np.float64)
    tot_b, tot_c = budgets_b.sum(), budgets_c.sum()

    phi = b_hat / tot_b + c_hat / tot_c                  # Eq. (56)
    psi = budgets_b / tot_b + budgets_c / tot_c          # Eq. (57)

    cam_order = np.argsort(-phi)                         # largest first
    srv_order = np.argsort(-psi)
    rem_b = budgets_b.copy()
    rem_c = budgets_c.copy()
    assign = np.zeros(b_hat.shape[0], np.int32)

    for n in cam_order:
        placed = False
        for s in srv_order:
            if rem_b[s] >= b_hat[n] and rem_c[s] >= c_hat[n]:
                assign[n] = s
                rem_b[s] -= b_hat[n]
                rem_c[s] -= c_hat[n]
                placed = True
                break
        if not placed:                                    # lines 6-8
            rem_vol = rem_b / tot_b + rem_c / tot_c
            s = int(np.argmax(rem_vol))
            assign[n] = s
            rem_b[s] = max(rem_b[s] - b_hat[n], 0.0)
            rem_c[s] = max(rem_c[s] - c_hat[n], 0.0)
    return assign


def first_fit_torch(b_hat: torch.Tensor, c_hat: torch.Tensor,
                    budgets_b: torch.Tensor, budgets_c: torch.Tensor
                    ) -> torch.Tensor:
    """Algorithm 2 placement on the tensors' device; returns int32[N].

    Same arithmetic as ``first_fit_jax``: float32 volumes, stable sorts,
    first fit in server order, else the first server of largest remaining
    volume, remainders clamped at zero.
    """
    tot_b = budgets_b.sum()
    tot_c = budgets_c.sum()
    phi = b_hat / tot_b + c_hat / tot_c                  # Eq. (56)
    psi = budgets_b / tot_b + budgets_c / tot_c          # Eq. (57)
    cam_order = torch.argsort(-phi, stable=True)         # largest first
    srv_order = torch.argsort(-psi, stable=True)
    b_sorted = b_hat[cam_order]
    c_sorted = c_hat[cam_order]
    servers = torch.arange(budgets_b.shape[0], device=b_hat.device)
    rem_b, rem_c = budgets_b, budgets_c
    placed = []
    for i in range(b_hat.shape[0]):
        bn, cn = b_sorted[i], c_sorted[i]
        fits = (rem_b[srv_order] >= bn) & (rem_c[srv_order] >= cn)
        fits_i = fits.to(torch.int32)
        s_fit = srv_order[torch.argmax(fits_i)]          # first fit in order
        rem_vol = rem_b / tot_b + rem_c / tot_c          # lines 6-8
        s = torch.where(fits_i.amax() > 0, s_fit, torch.argmax(rem_vol))
        hit = servers == s
        rem_b = torch.clamp_min(rem_b - torch.where(hit, bn, 0.0), 0.0)
        rem_c = torch.clamp_min(rem_c - torch.where(hit, cn, 0.0), 0.0)
        placed.append(s)
    assign = torch.empty(b_hat.shape[0], dtype=torch.int32,
                         device=b_hat.device)
    if placed:
        assign[cam_order] = torch.stack(placed).to(torch.int32)
    return assign


def hierarchical_first_fit(b_hat, c_hat, pod_budgets_b, pod_budgets_c,
                           islands_per_pod: int) -> np.ndarray:
    """Two-level placement (beyond the paper): first-fit over pods, then
    over the islands of the chosen pod, each island holding
    1/``islands_per_pod`` of its pod's capacity. Returns global island ids
    ``pod * islands_per_pod + i`` (int32, on the host)."""
    b_hat = np.asarray(b_hat)
    c_hat = np.asarray(c_hat)
    pod_budgets_b = np.asarray(pod_budgets_b, np.float64)
    pod_budgets_c = np.asarray(pod_budgets_c, np.float64)
    pods = first_fit(b_hat, c_hat, pod_budgets_b, pod_budgets_c)
    out = np.zeros_like(pods)
    for pod in range(pod_budgets_b.shape[0]):
        mask = pods == pod
        if not mask.any():
            continue
        ib = np.full(islands_per_pod, pod_budgets_b[pod] / islands_per_pod)
        ic = np.full(islands_per_pod, pod_budgets_c[pod] / islands_per_pod)
        local = first_fit(b_hat[mask], c_hat[mask], ib, ic)
        out[mask] = pod * islands_per_pod + local
    return out
