"""Bandwidth / computation water-filling (Algorithm 1, lines 4-5), plain.

The PyTorch counterpart of ``repro.core.allocate``'s water-fill path.
Given fixed video configurations, problems (53)/(54) are separable convex
programs with one budget per edge server:

    min_b  sum_n A_n(lam_n(b_n), mu_n)   s.t.  sum_{n in s} b_n <= B_s
    min_c  sum_n A_n(lam_n, mu_n(c_n))   s.t.  sum_{n in s} c_n <= C_s

with lam_n = b_n * eff_n / size_n and mu_n = c_n / xi_n. The per-server
dual is found by an Illinois search on its logarithm; each camera's
allocation by a closed form (LCFSP) or a bracketed bisection (FCFS). All in
normalized per-server units (x = allocation / budget).

Each takes an optional ``active`` fleet-churn mask (1 live, 0 churned
out), as the reference's do: a dead camera's box collapses to [0, 0], so
it gets exactly zero and its share of the budget water-fills to the live
cameras. No kernel takes the mask; a masked fill always runs here.

These functions are the plain versions that the CUDA water-fill kernels of
``repro_torch.kernels.slot_solver`` are held against: the loops are Python
loops of whole-fleet tensor operations, and the per-server fill sums are
pairwise trees (``tree_segment_sum``) in the order the kernels reduce, so
kernel and plain version add alike and the plain version is deterministic
on the card (no atomics).

The paper's own method, ``interior_point`` (a log barrier with damped
Newton steps), has no kernel in either package: it runs here only, with
its per-server sums on the same trees.
"""
from __future__ import annotations

import dataclasses

import torch

from . import aopi

_LOG_NU_LO = -34.0   # dual-variable search window (log domain)
_LOG_NU_HI = 34.0
_EPS = 1e-12


def segment_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for a 1-D ``x``."""
    out = torch.zeros(n_segments, dtype=x.dtype, device=x.device)
    return out.index_add_(0, segment_ids.long(), x)


@dataclasses.dataclass
class SegmentTree:
    """Where each element sits in a zero-padded ``[n_segments, width]``
    table: row = its segment, column = its rank within the segment in
    stable order; ``width`` is a power of two >= the element count."""
    index: torch.Tensor       # [N] int64, row * width + column
    n_segments: int
    width: int


def segment_tree(segment_ids: torch.Tensor, n_segments: int) -> SegmentTree:
    """Build the :class:`SegmentTree` of an assignment (no host sync)."""
    n = segment_ids.shape[0]
    sid = segment_ids.long()
    order = torch.argsort(sid, stable=True)
    counts = torch.zeros(n_segments, dtype=torch.int64, device=sid.device)
    counts.index_add_(0, sid, torch.ones_like(sid))
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=sid.device)
    width = 1 if n <= 1 else 1 << (n - 1).bit_length()
    return SegmentTree(sid * width + rank - start[sid], n_segments, width)


def tree_segment_sum(x: torch.Tensor, tree: SegmentTree) -> torch.Tensor:
    """Per-segment sums by a pairwise halving tree: each segment, in stable
    order and zero-padded to ``width``, is folded as x[j] += x[j + w] for
    w = width/2, ..., 1 (the water-fill kernels' ``segment_sum``). Leading
    axes of ``x`` are independent rows, each summed as a 1-D ``x``."""
    lead = x.shape[:-1]
    buf = torch.zeros(lead + (tree.n_segments * tree.width,),
                      dtype=x.dtype, device=x.device)
    buf = buf.scatter_(-1, tree.index.expand(lead + (-1,)), x).view(
        lead + (tree.n_segments, tree.width))
    w = tree.width
    while w > 1:
        w //= 2
        buf = buf[..., :w] + buf[..., w:]
    return buf[..., 0]


def clip(x, lo, hi):
    """``jnp.clip`` as ``minimum(maximum(x, lo), hi)``: the bounds may
    cross, and then ``hi`` wins."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _h_bandwidth(u, lam_scale, mu, p, pol):
    """-dA/du at normalized bandwidth u (lam = lam_scale * u)."""
    lam = torch.clamp_min(lam_scale * u, _EPS)
    d_l = aopi.d_aopi_lcfsp_dlam(lam, mu, p)
    d_f = aopi.d_aopi_fcfs_dlam(torch.minimum(lam, 0.999 * mu), mu, p)
    d = torch.where(pol == aopi.LCFSP, d_l, d_f)
    return torch.clamp_min(-d * lam_scale, 0.0)


def _h_compute(v, mu_scale, lam, p, pol):
    """-dA/dv at normalized compute v (mu = mu_scale * v)."""
    mu = torch.clamp_min(mu_scale * v, _EPS)
    d_l = aopi.d_aopi_lcfsp_dmu(lam, mu, p)
    d_f = aopi.d_aopi_fcfs_dmu(torch.minimum(lam, 0.999 * mu), mu, p)
    d = torch.where(pol == aopi.LCFSP, d_l, d_f)
    return torch.clamp_min(-d * mu_scale, 0.0)


def _solve_h_equals_nu(h_fn, nu, lo, hi, iters: int):
    """Per-camera bisection: largest x in [lo, hi] with h(x) >= nu."""
    a, b = lo, hi
    for _ in range(iters):
        mid = 0.5 * (a + b)
        go_up = h_fn(mid) >= nu
        a, b = torch.where(go_up, mid, a), torch.where(go_up, b, mid)
    return 0.5 * (a + b)


def _waterfill(h_fn, closed_form, lo, hi, server_id, tree: SegmentTree,
               outer_iters: int = 16, inner_iters: int = 6,
               final_inner_iters: int = 20):
    """Per-server water-filling: Illinois outer search on the log-duals,
    bracketed inner bisection (see ``repro.core.allocate._waterfill``)."""
    sid = server_id.long()
    n_servers = tree.n_segments

    def alloc_at(log_nu_s, blo, bhi, iters):
        nu = torch.exp(log_nu_s)[sid]
        x_cf = closed_form(nu)
        x_bi = _solve_h_equals_nu(h_fn, nu, blo, bhi, iters)
        x = torch.where(torch.isnan(x_cf), x_bi, x_cf)
        return clip(x, lo, hi)

    def bracket(xa, xb):
        pad = 0.25 * torch.clamp_min(xa - xb, 0.0) + 1e-7
        return torch.maximum(lo, xb - pad), torch.minimum(hi, xa + pad)

    def fill_at(log_nu_s, xa, xb, iters):
        blo, bhi = bracket(xa, xb)
        x = alloc_at(log_nu_s, blo, bhi, iters)
        return x, tree_segment_sum(x, tree) - 1.0

    a = torch.full((n_servers,), _LOG_NU_LO, device=lo.device)
    b = torch.full((n_servers,), _LOG_NU_HI, device=lo.device)
    xa, fa = fill_at(a, hi, lo, inner_iters + 4)
    xb, fb = fill_at(b, hi, lo, inner_iters + 4)
    for _ in range(outer_iters):
        denom = fa - fb
        t = torch.where(denom.abs() > 1e-12, fa / denom,
                        torch.full_like(fa, 0.5))
        t = torch.clamp(t, 0.05, 0.95)
        mid = a + t * (b - a)
        x, f = fill_at(mid, xa, xb, inner_iters)
        over = f > 0.0             # over budget -> raise the price
        over_n = over[sid]
        a, b = torch.where(over, mid, a), torch.where(over, b, mid)
        fa, fb = (torch.where(over, f, 0.5 * fa),      # Illinois halving
                  torch.where(over, 0.5 * fb, f))
        xa, xb = torch.where(over_n, x, xa), torch.where(over_n, xb, x)
    blo, bhi = bracket(xa, xb)
    # If the total cap is below budget the constraint is slack: keep caps.
    return alloc_at(0.5 * (a + b), blo, bhi, final_inner_iters)


def _masked_box(lo, hi, active):
    """The reference's churn mask on a fill's box: [0, 0] where dead."""
    if active is None:
        return lo, hi
    live = active > 0
    return (torch.where(live, lo, torch.zeros_like(lo)),
            torch.where(live, hi, torch.zeros_like(hi)))


def waterfill_bandwidth(k, p, pol, mu, server_id, budgets, n_servers: int,
                        outer_iters: int = 16, inner_iters: int = 6,
                        final_inner_iters: int = 20, active=None):
    """Allocate bandwidth b[n] (Hz) per server budget.

    ``k`` is eff/size (lam per Hz), ``mu`` the fixed computation rate,
    ``server_id`` int[n] in [0, n_servers), ``budgets`` Hz per server,
    ``active`` the optional churn mask (dead cameras get exactly 0).
    """
    B = budgets[server_id.long()]
    lam_scale = k * B
    # FCFS cap: interior minimizer lam* of A_F; LCFSP cap: the full budget.
    lam_star = aopi.argmin_lam_fcfs(mu, p)
    hi = torch.where(pol == aopi.LCFSP, torch.ones_like(lam_scale),
                     torch.clamp_max(lam_star / torch.clamp_min(
                         lam_scale, _EPS), 1.0))
    lo, hi = _masked_box(torch.full_like(hi, 1e-9), hi, active)

    def h_fn(u):
        return _h_bandwidth(u, lam_scale, mu, p, pol)

    def closed_form(nu):
        # LCFSP: (1+1/p) * lam_scale / (lam_scale*u)^2 = nu
        u = torch.sqrt((1.0 + 1.0 / p) / torch.clamp_min(lam_scale * nu,
                                                         _EPS))
        return torch.where(pol == aopi.LCFSP, u, torch.full_like(u, torch.nan))

    u = _waterfill(h_fn, closed_form, lo, hi, server_id,
                   segment_tree(server_id, n_servers),
                   outer_iters=outer_iters, inner_iters=inner_iters,
                   final_inner_iters=final_inner_iters)
    return u * B


def waterfill_compute(inv_xi, p, pol, lam, server_id, budgets,
                      n_servers: int, stability_margin: float = 1.05,
                      outer_iters: int = 16, inner_iters: int = 6,
                      final_inner_iters: int = 20, active=None):
    """Allocate computation c[n] (FLOPS) per server budget; ``inv_xi`` is
    1/xi (mu per FLOPS), ``lam`` the fixed transmission rate, ``active``
    the optional churn mask (dead cameras get exactly 0 and no floor)."""
    sid = server_id.long()
    C = budgets[sid]
    mu_scale = inv_xi * C
    tree = segment_tree(server_id, n_servers)
    # FCFS stability floors (mu >= margin * lam), scaled down per server
    # where they alone exceed its budget.
    floor = torch.where(pol == aopi.FCFS,
                        stability_margin * lam / torch.clamp_min(mu_scale,
                                                                 _EPS),
                        torch.full_like(lam, 1e-9))
    if active is not None:
        floor = torch.where(active > 0, floor, torch.zeros_like(floor))
    scale = torch.clamp_max(
        1.0 / torch.clamp_min(tree_segment_sum(floor, tree), _EPS), 1.0)
    floor = floor * scale[sid]
    lo, hi = _masked_box(
        clip(floor, torch.full_like(floor, 1e-9), torch.ones_like(floor)),
        torch.ones_like(floor), active)

    def h_fn(v):
        return _h_compute(v, mu_scale, lam, p, pol)

    def closed_form(nu):
        # LCFSP: mu_scale / (p * (mu_scale*v)^2) = nu
        v = torch.sqrt(1.0 / torch.clamp_min(p * mu_scale * nu, _EPS))
        return torch.where(pol == aopi.LCFSP, v, torch.full_like(v, torch.nan))

    v = _waterfill(h_fn, closed_form, lo, hi, server_id, tree,
                   outer_iters=outer_iters, inner_iters=inner_iters,
                   final_inner_iters=final_inner_iters)
    return v * C


def waterfill_pair(k, p, pol, mu, inv_xi, server_id, budgets_b, budgets_c,
                   n_servers: int, stability_margin: float = 1.05,
                   outer_iters: int = 16, inner_iters: int = 6,
                   final_inner_iters: int = 20, active=None):
    """Lines 4 and 5 of Algorithm 1: the bandwidth water-fill, then the
    FCFS stability floors and the compute water-fill at ``lam = b * k``.
    Returns ``(b, c)`` in Hz / FLOPS."""
    kw = dict(outer_iters=outer_iters, inner_iters=inner_iters,
              final_inner_iters=final_inner_iters, active=active)
    b = waterfill_bandwidth(k, p, pol, mu, server_id, budgets_b, n_servers,
                            **kw)
    c = waterfill_compute(inv_xi, p, pol, b * k, server_id, budgets_c,
                          n_servers, stability_margin=stability_margin, **kw)
    return b, c


# ---------------------------------------------------------------------------
# The paper's interior-point method (log barrier, damped Newton).
# ---------------------------------------------------------------------------

def _kkt_step(g, h, x, server_id, n_servers: int, target_fill,
              tree: SegmentTree | None = None):
    """Equality-constrained Newton step with a diagonal Hessian.

    Solves ``[diag(h) W^T; W 0] [dx; nu] = [-g; r]``, where ``W`` is the
    camera -> server indicator and ``r`` the residual of the per-server
    fill against ``target_fill``. The per-server sums are halving trees
    (``tree_segment_sum``), deterministic on the card."""
    tree = tree or segment_tree(server_id, n_servers)
    sid = server_id.long()
    h = torch.clamp_min(h, 1e-8)
    inv_h = 1.0 / h
    g_over_h, inv_sum, fill = tree_segment_sum(
        torch.stack([g * inv_h, inv_h, x]), tree)
    r = target_fill - fill
    nu = (-g_over_h - r) / torch.clamp_min(inv_sum, 1e-8)
    return -(g + nu[sid]) * inv_h


# The damped step's ladder, alpha = 2^-k for k = 0..7 (exact in f32).
_N_ALPHAS = 8


def _barrier(x, lo, hi):
    return (-torch.log(torch.clamp_min(x - lo, _EPS))
            - torch.log(torch.clamp_min(hi - x, _EPS)))


def _barrier_derivs(x, lo, hi):
    """First and second derivatives of ``_barrier`` in ``x`` (zero where a
    clamp holds, as autograd gives)."""
    a, b = x - lo, hi - x
    ia = torch.where(a >= _EPS, 1.0 / a, 0.0)
    ib = torch.where(b >= _EPS, 1.0 / b, 0.0)
    return ib - ia, ia * ia + ib * ib


def interior_point(score_elem, derivs, x0, lo, hi, server_id,
                   n_servers: int, t0: float = 4.0, t_mult: float = 6.0,
                   n_outer: int = 7, n_inner: int = 14):
    """Minimize ``sum_n score_elem(x)_n`` subject to a per-server sum equal
    to the target fill and ``lo < x < hi``: Algorithm 1's interior-point
    step, in normalized per-server units.

    ``score_elem(x)`` maps allocations of shape ``[..., N]`` to per-camera
    scores of the same shape, separable and convex in each ``x_n``, and
    ``derivs(x)`` gives their first and second derivatives (the reference
    takes both from ``jax.grad``; the tests hold these against autograd);
    ``x0`` is strictly feasible. Round ``i`` of ``n_outer`` runs
    ``n_inner`` damped Newton steps on ``t * score + barrier`` at
    ``t = t0 * t_mult**i``.
    """
    tree = segment_tree(server_id, n_servers)
    # The budget is an inequality: where the caps sum below it the target
    # is the (slightly interior) cap total instead.
    target_fill = torch.clamp_max(0.999 * tree_segment_sum(hi, tree), 1.0)
    # [0, 1, 1/2, ..., 2^-7] as a column, made on the device (no host
    # copy: the solve may be captured in a CUDA graph); halvings are exact.
    half = torch.full((_N_ALPHAS,), 0.5, dtype=x0.dtype, device=x0.device)
    alphas = torch.cat([torch.zeros_like(half[:1]),
                        2.0 * torch.cumprod(half, 0)])[:, None]
    inf = torch.full_like(half, float("inf"))

    def phi(x, t):
        return t * score_elem(x) + _barrier(x, lo, hi)

    def step(x, t):
        ds, d2s = derivs(x)
        gb, hb = _barrier_derivs(x, lo, hi)
        g, h = t * ds + gb, t * d2s + hb
        dx = _kkt_step(g, h, x, server_id, n_servers, target_fill, tree)
        # Row 0 is x itself, rows 1-8 the ladder's candidates. The damped
        # step takes the best candidate strictly inside the box, and only
        # if it lowers the objective.
        cand = x + alphas * dx
        vals = phi(cand, t).sum(dim=1)
        feas = ((cand[1:] > lo + _EPS) & (cand[1:] < hi - _EPS)).all(dim=1)
        vals, total = torch.where(feas, vals[1:], inf), vals[:1]
        best = torch.argmin(vals).reshape(1)
        improved = vals.index_select(0, best) < total
        return torch.where(improved, cand.index_select(0, best + 1)[0], x)

    x = x0
    for i in range(n_outer):
        t = t0 * t_mult ** i
        for _ in range(n_inner):
            x = step(x, t)
    return x


def _interior_start(server_id, n_servers: int, lo, hi):
    """The equal split of each server, kept 1e-6 inside the box (``hi``
    wins where the box is narrower than 2e-6, as in ``jnp.clip``)."""
    counts = segment_sum(torch.ones_like(lo), server_id, n_servers)
    share = (1.0 / torch.clamp_min(counts, 1.0))[server_id.long()]
    return clip(share, lo + 1e-6, hi - 1e-6)


def _bandwidth_score(lam_scale, p, pol, mu):
    """Problem (53)'s per-camera score in normalized bandwidth, and its
    first and second derivatives (FCFS at ``min(lam, 0.999 mu)``)."""
    lcfsp = pol == aopi.LCFSP

    def score(x):
        lam = lam_scale * x
        a_l = aopi.aopi_lcfsp(lam, mu, p)
        a_f = aopi.aopi_fcfs(torch.minimum(lam, 0.999 * mu), mu, p)
        return torch.where(lcfsp, a_l, a_f)

    cap = 0.999 * mu
    scale2 = lam_scale * lam_scale

    def derivs(x):
        lam = lam_scale * x
        lam_f = torch.minimum(lam, cap)
        free = lam < cap              # the clamp passes no derivative
        d_f, d2_f = aopi.d12_aopi_fcfs_dlam(lam_f, mu, p)
        d = torch.where(lcfsp, aopi.d_aopi_lcfsp_dlam(lam, mu, p),
                        torch.where(free, d_f, 0.0))
        d2 = torch.where(lcfsp, aopi.d2_aopi_lcfsp_dlam2(lam, mu, p),
                         torch.where(free, d2_f, 0.0))
        return d * lam_scale, d2 * scale2

    return score, derivs


def _compute_score(mu_scale, p, pol, lam):
    """Problem (54)'s per-camera score in normalized compute, and its
    first and second derivatives (FCFS at ``max(mu, lam / 0.999)``)."""
    lcfsp = pol == aopi.LCFSP
    floor = lam / 0.999

    def score(x):
        mu = mu_scale * x
        a_l = aopi.aopi_lcfsp(lam, mu, p)
        a_f = aopi.aopi_fcfs(lam, torch.maximum(mu, floor), p)
        return torch.where(lcfsp, a_l, a_f)

    scale2 = mu_scale * mu_scale

    def derivs(x):
        mu = mu_scale * x
        mu_f = torch.maximum(mu, floor)
        free = mu > floor             # the clamp passes no derivative
        d_f, d2_f = aopi.d12_aopi_fcfs_dmu(lam, mu_f, p)
        d = torch.where(lcfsp, aopi.d_aopi_lcfsp_dmu(lam, mu, p),
                        torch.where(free, d_f, 0.0))
        d2 = torch.where(lcfsp, aopi.d2_aopi_lcfsp_dmu2(lam, mu, p),
                         torch.where(free, d2_f, 0.0))
        return d * mu_scale, d2 * scale2

    return score, derivs


def interior_point_bandwidth(k, p, pol, mu, server_id, budgets,
                             n_servers: int):
    """Problem (53) by the paper's interior-point method; Hz per camera."""
    B = budgets[server_id.long()]
    lam_scale = k * B
    hi = torch.where(pol == aopi.LCFSP, torch.ones_like(lam_scale),
                     torch.clamp_max(0.995 * mu / torch.clamp_min(
                         lam_scale, _EPS), 1.0))
    lo = torch.full_like(hi, 1e-7)
    u = interior_point(*_bandwidth_score(lam_scale, p, pol, mu),
                       _interior_start(server_id, n_servers, lo, hi), lo, hi,
                       server_id, n_servers)
    return u * B


def interior_point_compute(inv_xi, p, pol, lam, server_id, budgets,
                           n_servers: int, stability_margin: float = 1.05):
    """Problem (54) by the paper's interior-point method; FLOPS per
    camera, with the FCFS stability floors of ``waterfill_compute``."""
    sid = server_id.long()
    C = budgets[sid]
    mu_scale = inv_xi * C
    floor = torch.where(pol == aopi.FCFS,
                        stability_margin * lam / torch.clamp_min(mu_scale,
                                                                 _EPS),
                        torch.full_like(lam, 1e-7))
    scale = torch.clamp_max(1.0 / torch.clamp_min(tree_segment_sum(
        floor, segment_tree(server_id, n_servers)), _EPS), 1.0)
    lo = clip(floor * scale[sid], torch.full_like(floor, 1e-7),
              torch.full_like(floor, 1.0 - 1e-6))
    hi = torch.ones_like(lo)
    v = interior_point(*_compute_score(mu_scale, p, pol, lam),
                       _interior_start(server_id, n_servers, lo, hi), lo, hi,
                       server_id, n_servers)
    return v * C
