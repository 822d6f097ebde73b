"""Closed-form Age-of-Processed-Information (AoPI), Theorems 1-3.

The PyTorch counterpart of ``repro.core.aopi``, in float32. Every power is
written as explicit products in the association XLA lowers
``integer_pow`` to (``x**3 -> x*(x*x)``, ``x**4 -> (x*x)*(x*x)``), because
``torch.pow`` calls ``powf`` and can differ by an ulp. The CUDA kernels of
``repro_torch.kernels.slot_solver`` inline the same expressions in the same
order, so the plain and kernel paths round alike.

Notation: ``lam`` transmission rate, ``mu`` computation rate, ``p``
recognition accuracy (per camera).
"""
from __future__ import annotations

import torch

FCFS = 0
LCFSP = 1


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float32 else x.float()
    return torch.as_tensor(x, dtype=torch.float32)


def _sq(x):
    return x * x


def _cube(x):
    return x * (x * x)


def _quad(x):
    x2 = x * x
    return x2 * x2


def aopi_fcfs(lam, mu, p):
    """Average AoPI under FCFS (Theorem 1, Eq. 11); +inf where lam >= mu."""
    lam, mu, p = _f32(lam), _f32(mu), _f32(p)
    stable = lam < mu
    lam_s = torch.where(stable, lam, 0.5 * mu)
    queue = (2.0 * _cube(lam_s) + lam_s * _sq(mu) - mu * _sq(lam_s)) / (
        _quad(mu) - _sq(mu) * _sq(lam_s))
    a = (1.0 + 1.0 / p) / lam_s + 1.0 / mu + queue
    return torch.where(stable, a, torch.full_like(a, float("inf")))


def aopi_lcfsp(lam, mu, p):
    """Average AoPI under LCFSP (Theorem 2, Eq. 23)."""
    lam, mu, p = _f32(lam), _f32(mu), _f32(p)
    return (1.0 + 1.0 / p) / lam + 1.0 / (p * mu)


def aopi(lam, mu, p, policy):
    """Policy-dispatched AoPI; ``policy`` 0 (FCFS) or 1 (LCFSP) per camera."""
    policy = torch.as_tensor(policy)
    return torch.where(policy == LCFSP, aopi_lcfsp(lam, mu, p),
                       aopi_fcfs(lam, mu, p))


def policy_threshold(rho):
    """Theorem 3 (Eq. 43): FCFS AoPI exceeds LCFSP iff ``p`` is at least
    ``(1 - rho^2) / (2 rho^3 - 2 rho^2 + rho + 1)``; 0 for rho >= 1."""
    rho = _f32(rho)
    thr = (1.0 - _sq(rho)) / (2.0 * _cube(rho) - 2.0 * _sq(rho) + rho + 1.0)
    return torch.where(rho < 1.0, thr, torch.zeros_like(thr))


def optimal_policy(lam, mu, p):
    """Per Theorem 3: LCFSP (1) where it achieves the lower AoPI."""
    rho = _f32(lam) / _f32(mu)
    return (_f32(p) >= policy_threshold(rho)).to(torch.int32)


def aopi_masked(lam, mu, p, policy, active=None):
    """AoPI with the zero-rate corner masked: dead streams (``lam`` or
    ``mu`` zero, or ``active == 0``) give exactly 0.0, live streams the
    plain ``aopi`` value."""
    lam, mu, p = _f32(lam), _f32(mu), _f32(p)
    live = (lam > 0) & (mu > 0)
    if active is not None:
        live = live & (torch.as_tensor(active) > 0)
    lam_s = torch.where(live, lam, torch.ones_like(lam))
    mu_s = torch.where(live, mu, torch.full_like(mu, 2.0))
    p_s = torch.where(live, p, torch.full_like(p, 0.5))
    a = aopi(lam_s, mu_s, p_s, policy)
    return torch.where(live, a, torch.zeros_like(a))


# ---------------------------------------------------------------------------
# Analytic derivatives (the water-fill marginal values and the
# interior-point Newton steps are built on these).
# ---------------------------------------------------------------------------

def d_aopi_lcfsp_dlam(lam, mu, p):
    return -(1.0 + 1.0 / p) / _sq(lam)


def d_aopi_lcfsp_dmu(lam, mu, p):
    return -1.0 / (p * _sq(mu))


def d_aopi_fcfs_dlam(lam, mu, p):
    """dA_F/dlam, valid for lam < mu."""
    num = 2.0 * _cube(lam) + lam * _sq(mu) - mu * _sq(lam)
    den = _quad(mu) - _sq(mu) * _sq(lam)
    dnum = 6.0 * _sq(lam) + _sq(mu) - 2.0 * mu * lam
    dden = -2.0 * _sq(mu) * lam
    dq = (dnum * den - num * dden) / _sq(den)
    return -(1.0 + 1.0 / p) / _sq(lam) + dq


def d_aopi_fcfs_dmu(lam, mu, p):
    num = 2.0 * _cube(lam) + lam * _sq(mu) - mu * _sq(lam)
    den = _quad(mu) - _sq(mu) * _sq(lam)
    dnum = 2.0 * lam * mu - _sq(lam)
    dden = 4.0 * _cube(mu) - 2.0 * mu * _sq(lam)
    dq = (dnum * den - num * dden) / _sq(den)
    return -1.0 / _sq(mu) + dq


# Second derivatives (the interior-point method's diagonal Hessians). For
# the FCFS queue term q = N / D the recurrences q' = (N' - q D') / D and
# q'' = (N'' - 2 q' D' - q D'') / D keep every intermediate at the scale
# of D (no D^2 or D^3), which stays inside float32's range.

def d2_aopi_lcfsp_dlam2(lam, mu, p):
    return 2.0 * (1.0 + 1.0 / p) / _cube(lam)


def d2_aopi_lcfsp_dmu2(lam, mu, p):
    return 2.0 / (p * _cube(mu))


def d12_aopi_fcfs_dlam(lam, mu, p):
    """``(dA_F/dlam, d^2 A_F/dlam^2)`` from shared terms, for lam < mu; the
    first is bitwise ``d_aopi_fcfs_dlam``."""
    lam2, mu2 = _sq(lam), _sq(mu)
    num = 2.0 * _cube(lam) + lam * mu2 - mu * lam2
    den = _quad(mu) - mu2 * lam2
    dnum = 6.0 * lam2 + mu2 - 2.0 * mu * lam
    dden = -2.0 * mu2 * lam
    c = 1.0 + 1.0 / p
    d = -c / lam2 + (dnum * den - num * dden) / _sq(den)
    q = num / den
    dq = (dnum - q * dden) / den
    d2q = (12.0 * lam - 2.0 * mu - 2.0 * dq * dden + q * 2.0 * mu2) / den
    return d, 2.0 * c / _cube(lam) + d2q


def d12_aopi_fcfs_dmu(lam, mu, p):
    """``(dA_F/dmu, d^2 A_F/dmu^2)`` from shared terms, for lam < mu; the
    first is bitwise ``d_aopi_fcfs_dmu``."""
    lam2, mu2 = _sq(lam), _sq(mu)
    num = 2.0 * _cube(lam) + lam * mu2 - mu * lam2
    den = _quad(mu) - mu2 * lam2
    dnum = 2.0 * lam * mu - lam2
    dden = 4.0 * _cube(mu) - 2.0 * mu * lam2
    d = -1.0 / mu2 + (dnum * den - num * dden) / _sq(den)
    q = num / den
    dq = (dnum - q * dden) / den
    d2q = (2.0 * lam - 2.0 * dq * dden - q * (12.0 * mu2 - 2.0 * lam2)) / den
    return d, 2.0 / _cube(mu) + d2q


def argmin_lam_fcfs(mu, p, iters: int = 26):
    """Interior minimizer lam* of the convex A_F(lam) on (0, mu), by
    bisection on the increasing derivative (Corollary 4.1)."""
    mu, p = _f32(mu), _f32(p)
    lo = torch.full_like(mu, 1e-9)
    hi = 0.999999 * mu
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        neg = d_aopi_fcfs_dlam(mid, mu, p) < 0.0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    return 0.5 * (lo + hi)


def aopi_best(lam, mu, p):
    """AoPI under the per-point optimal policy (the lower envelope of
    Theorems 1 and 2)."""
    return torch.minimum(aopi_fcfs(lam, mu, p), aopi_lcfsp(lam, mu, p))


# ---------------------------------------------------------------------------
# Rate frontiers (Figs. 3 and 5): the least lam (resp. mu) that meets an
# average-AoPI target given the other rate, by bisection. Every argument
# may be a tensor; the result has their broadcast shape.
# ---------------------------------------------------------------------------

def _bisect(fn, lo, hi, iters: int = 60):
    """Root of the decreasing ``fn`` on [lo, hi] by ``iters`` halvings."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = fn(mid) > 0.0     # still above target -> need a larger rate
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _frontier_args(target, rate, p, policy):
    """The arguments as float32 (policy int) tensors of one broadcast
    shape, on the device of the first tensor among them."""
    dev = next((x.device for x in (target, rate, p, policy)
                if isinstance(x, torch.Tensor)), torch.device("cpu"))
    target, rate, p = (_f32(x).to(dev) for x in (target, rate, p))
    policy = torch.as_tensor(policy, device=dev)
    return torch.broadcast_tensors(target, rate, p, policy)


def min_lam_for_target(target, mu, p, policy, hi: float = 1e6):
    """The least transmission rate with AoPI(lam, mu, p, policy) <= target.

    Under FCFS, AoPI is convex in lam (Corollary 4.1): the bisection runs on
    the decreasing branch up to the interior minimizer, and the result is
    +inf where even that minimum misses the target."""
    target, mu, p, policy = _frontier_args(target, mu, p, policy)
    lo = torch.full_like(mu, 1e-9)
    lam_star = argmin_lam_fcfs(mu, p)   # interior minimizer of the convex A_F
    lcfsp = _bisect(lambda lam: aopi_lcfsp(lam, mu, p) - target, lo,
                    torch.full_like(mu, hi))
    fcfs = _bisect(lambda lam: aopi_fcfs(lam, mu, p) - target, lo, lam_star)
    fcfs = torch.where(aopi_fcfs(lam_star, mu, p) <= target, fcfs,
                       torch.full_like(fcfs, float("inf")))
    return torch.where(policy == LCFSP, lcfsp, fcfs)


def min_mu_for_target(target, lam, p, policy, hi: float = 1e6):
    """The least computation rate with AoPI <= target (AoPI decreases in
    mu); +inf where even ``mu = hi`` misses the target."""
    target, lam, p, policy = _frontier_args(target, lam, p, policy)
    top = torch.full_like(lam, hi)
    feasible = aopi(lam, top, p, policy) <= target
    mu = _bisect(lambda mu: aopi(lam, mu, p, policy) - target,
                 torch.full_like(lam, 1e-9), top)
    return torch.where(feasible, mu, torch.full_like(mu, float("inf")))
