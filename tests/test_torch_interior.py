"""The port's interior-point method (the paper's own Algorithm-1
allocator: a log barrier with damped Newton steps) held against the JAX
package's on the CPU: the Newton step, both allocators, and
``bcd.solve_slot(method="interior")``.

Both packages run the method in float32, and both stall in the line
search where a step's gain falls below the objective's rounding: at a
distance ~sqrt(2 eps N) (eps = 2^-24, N cameras) from the optimum, along
the objective's flat directions. ``repro``'s own float32 run lies up to
1.7e-3 from its float64 run here, so no float32 run can be held to
``repro``'s allocations at 1e-4. Allocations are held to ``repro``'s
float64 solution within that band (:func:`_band`), objectives to 1e-6,
and the gap to ``repro``'s float32 allocations is printed (ROADMAP
section 3)."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import allocate as j_alloc  # noqa: E402
from repro.core import aopi as j_aopi  # noqa: E402
from repro.core import bcd as j_bcd  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro_torch.core import allocate as t_alloc  # noqa: E402
from repro_torch.core import aopi as t_aopi  # noqa: E402
from repro_torch.core import bcd as t_bcd  # noqa: E402


# tests/test_allocators.py's instances hold 4 cameras a server; larger
# ones keep that per-camera share of the budgets (``_share``), where the
# FCFS stability floors fit (an overloaded server: ``test_overloaded_*``).

def _share(n, s):
    return max(1.0, n / (4 * s))


def _bandwidth_case(n, s, seed, lcfsp_frac, share=None):
    """tests/test_allocators.py's bandwidth instance, in float32."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(1e-6, 5e-6, n).astype(np.float32)
    p = rng.uniform(0.3, 0.95, n).astype(np.float32)
    pol = (rng.random(n) < lcfsp_frac).astype(np.int32)
    mu = rng.uniform(5.0, 40.0, n).astype(np.float32)
    sid = rng.integers(0, s, n).astype(np.int32)
    budgets = rng.uniform(2e7, 5e7, s) * (share or _share(n, s))
    return k, p, pol, mu, sid, budgets.astype(np.float32)


def _compute_case(n, s, seed, lcfsp_frac, share=None):
    """tests/test_allocators.py's compute instance, in float32."""
    rng = np.random.default_rng(seed)
    inv_xi = rng.uniform(1e-12, 5e-12, n).astype(np.float32)
    p = rng.uniform(0.3, 0.95, n).astype(np.float32)
    pol = (rng.random(n) < lcfsp_frac).astype(np.int32)
    lam = rng.uniform(1.0, 8.0, n).astype(np.float32)
    sid = rng.integers(0, s, n).astype(np.int32)
    budgets = rng.uniform(3e13, 8e13, s) * (share or _share(n, s))
    return inv_xi, p, pol, lam, sid, budgets.astype(np.float32)


KINDS = {"bandwidth": (_bandwidth_case, "interior_point_bandwidth",
                       "waterfill_bandwidth"),
         "compute": (_compute_case, "interior_point_compute",
                     "waterfill_compute")}
# (n, s, seed, LCFSP share): tests/test_allocators.py's two cases, then
# N=30 on one and three servers, all FCFS, all LCFSP and mixed.
CASES = [(8, 2, 5, 0.5), (8, 2, 7, 0.5)] + [
    (30, s, seed, frac) for s in (1, 3)
    for seed, frac in ((11, 0.0), (12, 1.0), (13, 0.5))]
IDS = [f"n{n}-s{s}-seed{seed}-lcfsp{frac}" for n, s, seed, frac in CASES]


def _band(n):
    """The float32 stall band of an N-camera solve, sqrt(2 eps N)."""
    return float(np.sqrt(2.0 * 2.0 ** -24 * n))


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b) / np.abs(b)))


def _f64(args):
    return [jnp.asarray(np.asarray(a, np.float64) if a.dtype == np.float32
                        else a) for a in args]


def _objective(kind, x, args):
    """The problem's objective in float64 (the scores' expressions)."""
    a = [np.asarray(v, np.float64) for v in args]
    if kind == "bandwidth":
        k, p, pol, mu, _, _ = a
        lam, lam_f = x * k, np.minimum(x * k, 0.999 * mu)
        mu_f = mu
    else:
        inv_xi, p, pol, lam, _, _ = a
        mu = x * inv_xi
        mu_f, lam_f = np.maximum(mu, lam / 0.999), lam
    a_l = (1 + 1 / p) / lam + 1 / (p * mu)
    queue = (2 * lam_f ** 3 + lam_f * mu_f ** 2 - mu_f * lam_f ** 2) / (
        mu_f ** 4 - mu_f ** 2 * lam_f ** 2)
    a_f = (1 + 1 / p) / lam_f + 1 / mu_f + queue
    return float(np.where(pol == 1, a_l, a_f).sum())


@pytest.fixture(scope="module")
def solved():
    """Per (kind, case): the inputs, repro's float32 and float64
    allocations and the port's."""
    out = {}
    for kind, (make, fn, _) in KINDS.items():
        for case in CASES:
            args = make(*case)
            s = case[1]
            j32 = np.asarray(getattr(j_alloc, fn)(*map(jnp.asarray, args),
                                                  n_servers=s))
            with jax.enable_x64(True):
                j64 = np.asarray(getattr(j_alloc, fn)(*_f64(args),
                                                      n_servers=s))
            t = getattr(t_alloc, fn)(*map(torch.as_tensor, args),
                                     n_servers=s).numpy()
            out[kind, case] = (args, j32, j64, t)
    return out


# The one case whose FCFS cameras leave budget unused at their optimum
# (lam* of Corollary 4.1): see test_interior_fills_fcfs_past_their_optimum.
SLACK_FCFS = ("bandwidth", (30, 3, 11, 0.0))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_interior_allocator_matches_reference(solved, kind, case):
    args, j32, j64, t = solved[kind, case]
    n, s = case[:2]
    assert t.dtype == np.float32 and t.shape == (n,)
    assert _rel(t, j64) <= _band(n), (_rel(t, j64), _band(n))
    assert _rel(j32, j64) <= _band(n)             # repro's own float32 run
    obj64 = _objective(kind, j64, args)
    assert _objective(kind, t, args) == pytest.approx(obj64, rel=1e-6)
    sid, budgets = args[4], args[5]
    assert (t > 0).all()
    for j in range(s):
        assert t[sid == j].sum() <= float(budgets[j]) * (1 + 1e-5)
    # The paper's method and the water-fill reach the same optimum
    # (tests/test_allocators.py's bar), but for SLACK_FCFS.
    wf = getattr(t_alloc, KINDS[kind][2])(*map(torch.as_tensor, args),
                                          n_servers=s).numpy()
    if (kind, case) != SLACK_FCFS:
        assert _objective(kind, t, args) == pytest.approx(
            _objective(kind, wf, args), rel=5e-3)
    print(f"{kind} {case}: port vs repro f32 {_rel(t, j32):.3e}, port vs "
          f"repro f64 {_rel(t, j64):.3e}, repro f32 vs f64 "
          f"{_rel(j32, j64):.3e} (band {_band(n):.3e})")


def test_interior_fills_fcfs_past_their_optimum(solved):
    """Pins a fault of the reference that the port follows: the interior
    method's equality target is min(1, 0.999 x the caps' total), with the
    FCFS caps at the stability edge (0.995 mu), not at the FCFS optimum
    lam* where the water-fill caps them. With 30 FCFS cameras on 3 servers
    at the 4-camera share, the water-fill leaves 21-52% of each server's
    bandwidth unused; the interior method fills it, past lam*, and its
    total AoPI is 24% above the water-fill's, in both packages."""
    kind, case = SLACK_FCFS
    args, j32, _, t = solved[kind, case]
    wf = t_alloc.waterfill_bandwidth(*map(torch.as_tensor, args),
                                     n_servers=case[1]).numpy()
    sid, budgets = args[4], args[5]
    fill = [float(wf[sid == j].sum() / budgets[j]) for j in range(case[1])]
    obj_t, obj_j, obj_wf = (_objective(kind, x, args) for x in (t, j32, wf))
    print(f"water-fill fills {fill}; interior objective {obj_t:.6f} (repro "
          f"{obj_j:.6f}), water-fill {obj_wf:.6f}")
    assert max(fill) < 0.8
    assert obj_t == pytest.approx(obj_j, rel=1e-6)
    assert obj_t / obj_wf - 1 > 0.2


def test_overloaded_server_overfills_in_both_packages():
    """30 FCFS cameras on one server at the 4-camera share of
    tests/test_allocators.py's budgets: the stability floors alone ask for
    1.86 servers, so they are scaled to fill it and no point strictly
    inside the box meets the budget. The start (the equal split raised to
    the floors) holds 2.0 servers; both packages' line searches stop at
    1.23 of the budget (the water-fill at 1.01)."""
    args = _compute_case(30, 1, 11, 0.0, share=1.0)
    want = np.asarray(j_alloc.interior_point_compute(*map(jnp.asarray, args),
                                                     n_servers=1))
    got = t_alloc.interior_point_compute(*map(torch.as_tensor, args),
                                         n_servers=1).numpy()
    fill_j, fill_t = (float(x.sum(dtype=np.float64) / args[5][0])
                      for x in (want, got))
    print(f"fill: repro {fill_j:.6f}, port {fill_t:.6f}")
    assert fill_j > 1.2 and fill_t == pytest.approx(fill_j, rel=1e-4)
    assert _rel(got, want) <= 2 * _band(30)


def test_interior_gap_to_reference_is_the_float32_band(solved):
    """Pins both sides: repro's own float32 runs leave its float64
    solutions by more than 1e-4, and the port's gap to repro's float32
    allocations stays inside twice the band (each side within it)."""
    ref = max(_rel(j32, j64) for _, j32, j64, _ in solved.values())
    gap = max(_rel(t, j32) / _band(case[0])
              for (_, case), (_, j32, _, t) in solved.items())
    print(f"repro f32 vs f64 at most {ref:.3e}; port vs repro f32 at most "
          f"{gap:.3f} bands")
    assert ref > 1e-4
    assert gap <= 2.0


@pytest.mark.parametrize("kind", list(KINDS))
def test_interior_allocators_under_no_grad(solved, kind):
    """A caller under ``torch.no_grad()`` gets the same allocation,
    bitwise."""
    fn = KINDS[kind][1]
    for case in (CASES[0], CASES[-1]):
        args, _, _, t = solved[kind, case]
        with torch.no_grad():
            got = getattr(t_alloc, fn)(*map(torch.as_tensor, args),
                                       n_servers=case[1])
        np.testing.assert_array_equal(got.numpy(), t)


@pytest.mark.parametrize("kind", list(KINDS))
def test_newton_derivatives_match_autograd(kind):
    """The Newton steps' closed-form first and second derivatives of each
    score against autograd of the score itself (the reference takes them
    with ``jax.grad``), at points inside and outside the FCFS clamp
    (``min(lam, 0.999 mu)``, ``max(mu, lam / 0.999)``); and the barrier's
    against autograd of ``_barrier``."""
    rng = np.random.default_rng(3)
    n = 64
    p = torch.as_tensor(rng.uniform(0.3, 0.95, n), dtype=torch.float32)
    pol = torch.as_tensor(np.arange(n) % 2, dtype=torch.int32)
    if kind == "bandwidth":
        scale = torch.as_tensor(rng.uniform(20.0, 200.0, n),
                                dtype=torch.float32)
        other = torch.as_tensor(rng.uniform(5.0, 40.0, n),
                                dtype=torch.float32)
        # lam = scale * x from 0.02 to 1.3 times mu: past 0.999 mu the
        # clamp holds.
        ratio = rng.uniform(0.02, 0.99, n)
        ratio[:16:2] = rng.uniform(1.0, 1.3, 8)    # FCFS under the clamp
        x = other / scale * torch.as_tensor(ratio, dtype=torch.float32)
        score, derivs = t_alloc._bandwidth_score(scale, p, pol, other)
    else:
        scale = torch.as_tensor(rng.uniform(20.0, 250.0, n),
                                dtype=torch.float32)
        other = torch.as_tensor(rng.uniform(1.0, 8.0, n),
                                dtype=torch.float32)
        ratio = rng.uniform(1.01, 20.0, n)
        ratio[:16:2] = rng.uniform(0.7, 0.99, 8)   # FCFS under the clamp
        x = other / scale * torch.as_tensor(ratio, dtype=torch.float32)
        score, derivs = t_alloc._compute_score(scale, p, pol, other)
    xg = x.clone().requires_grad_(True)
    g, = torch.autograd.grad(score(xg).sum(), xg, create_graph=True)
    h, = torch.autograd.grad(g.sum(), xg)
    d, d2 = derivs(x)
    np.testing.assert_allclose(d.numpy(), g.detach().numpy(), rtol=2e-5,
                               atol=1e-30)
    np.testing.assert_allclose(d2.numpy(), h.numpy(), rtol=2e-4, atol=1e-30)
    assert int((d == 0).sum()) == 8
    lo = x * torch.as_tensor(rng.uniform(0.1, 0.9, n), dtype=torch.float32)
    hi = x * torch.as_tensor(rng.uniform(1.1, 3.0, n), dtype=torch.float32)
    xg = x.clone().requires_grad_(True)
    g, = torch.autograd.grad(t_alloc._barrier(xg, lo, hi).sum(), xg,
                             create_graph=True)
    h, = torch.autograd.grad(g.sum(), xg)
    d, d2 = t_alloc._barrier_derivs(x, lo, hi)
    np.testing.assert_allclose(d.numpy(), g.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(d2.numpy(), h.numpy(), rtol=1e-6)


@pytest.mark.parametrize("which", ["lam", "mu"])
def test_second_derivatives_match_reference(which):
    """``aopi``'s closed-form second derivatives against ``jax.grad`` twice
    over the reference's closed forms, on stable points."""
    rng = np.random.default_rng(4)
    n = 257
    mu = rng.uniform(2.0, 60.0, n).astype(np.float32)
    lam = (mu * rng.uniform(0.05, 0.97, n)).astype(np.float32)
    p = rng.uniform(0.05, 1.0, n).astype(np.float32)
    for name, fn in (("fcfs", j_aopi.aopi_fcfs),
                     ("lcfsp", j_aopi.aopi_lcfsp)):
        if which == "lam":
            d2 = jax.vmap(jax.grad(jax.grad(fn, 0), 0))
        else:
            d2 = jax.vmap(jax.grad(jax.grad(fn, 1), 1))
        want = np.asarray(d2(*map(jnp.asarray, (lam, mu, p))))
        targs = tuple(map(torch.as_tensor, (lam, mu, p)))
        if name == "fcfs":
            d, got = getattr(t_aopi, f"d12_aopi_fcfs_d{which}")(*targs)
            assert torch.equal(d, getattr(t_aopi,
                                          f"d_aopi_fcfs_d{which}")(*targs))
        else:
            got = getattr(t_aopi, f"d2_aopi_lcfsp_d{which}2")(*targs)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   err_msg=name)


def test_kkt_step_matches_reference():
    rng = np.random.default_rng(6)
    for n, s in ((8, 2), (30, 3), (30, 1)):
        g = rng.normal(0.0, 50.0, n).astype(np.float32)
        h = rng.uniform(1.0, 1e4, n).astype(np.float32)
        h[0] = 0.0                        # clamped to 1e-8
        x = rng.uniform(0.01, 0.5, n).astype(np.float32)
        sid = rng.integers(0, s, n).astype(np.int32)
        target = rng.uniform(0.5, 1.0, s).astype(np.float32)
        want = np.asarray(j_alloc._kkt_step(*map(jnp.asarray, (
            g, h, x, sid)), s, jnp.asarray(target)))
        got = t_alloc._kkt_step(*map(torch.as_tensor, (g, h, x, sid)), s,
                                torch.as_tensor(target)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


def test_narrow_box_starts_at_its_upper_end():
    """A server whose only (FCFS) camera's stability floor fills it: the
    box is [1 - 1e-6, 1], narrower than the start's 2e-6 margin, so the
    start is ``hi - 1e-6`` (``jnp.clip``: the upper bound wins) and no
    candidate is ever feasible. Both packages keep the start."""
    args = list(_compute_case(6, 2, 8, 0.5))
    sid = np.array([0, 1, 1, 1, 1, 1], np.int32)
    args[2] = np.array([0, 1, 1, 0, 1, 0], np.int32)       # camera 0 FCFS
    args[3] = args[3].copy()
    args[3][0] = 2.0 * float(args[0][0] * args[5][0])     # floor 2.1
    args[4] = sid
    want = np.asarray(j_alloc.interior_point_compute(
        *map(jnp.asarray, args), n_servers=2))
    got = t_alloc.interior_point_compute(*map(torch.as_tensor, args),
                                         n_servers=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# bcd.solve_slot(method="interior")
# ---------------------------------------------------------------------------

def _slot_instance(seed, n=12, s=3):
    rng = np.random.default_rng(seed)
    tab = j_prof.EdgeSystem(n_cameras=n, n_servers=s, n_slots=4,
                            seed=seed).horizon(1)
    sid = rng.integers(0, s, n).astype(np.int32)
    arrays = (np.asarray(tab.acc[0]), np.asarray(tab.xi),
              np.asarray(tab.size), np.asarray(tab.eff), sid,
              np.asarray(tab.budgets_b[0]), np.asarray(tab.budgets_c[0]))
    return arrays, np.float32(rng.uniform(0.0, 3.0)), \
        float(np.float32(rng.uniform(1.0, 30.0)))


@pytest.mark.parametrize("seed,n,s", [(0, 12, 3), (1, 10, 2), (2, 30, 3)])
def test_solve_slot_interior_matches_reference(seed, n, s):
    """Indices equal; AoPI, accuracy, rates and score at the rollout
    contract (rtol 1e-3); b, c and mu within the float32 band of repro's
    float64 solve, as repro's own float32 solve."""
    arrays, q, v = _slot_instance(seed, n, s)
    d_j = j_bcd.solve_slot(*map(jnp.asarray, arrays), jnp.float32(q),
                           jnp.float32(v), n_servers=s, method="interior")
    with jax.enable_x64(True):
        d_64 = j_bcd.solve_slot(*_f64(arrays), jnp.float64(q),
                                jnp.float64(v), n_servers=s,
                                method="interior")
    d_t = t_bcd.solve_slot(*map(torch.as_tensor, arrays), float(q), v,
                           n_servers=s, method="interior")
    for f in ("r_idx", "m_idx", "pol"):
        np.testing.assert_array_equal(getattr(d_t, f).numpy(),
                                      np.asarray(getattr(d_j, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(d_t, f).numpy(),
                                      np.asarray(getattr(d_64, f)),
                                      err_msg=f)
    for f in ("aopi", "acc", "lam", "score"):
        np.testing.assert_allclose(getattr(d_t, f).numpy(),
                                   np.asarray(getattr(d_j, f)), rtol=1e-3,
                                   err_msg=f)
    for f in ("b", "c", "mu"):
        got, want = getattr(d_t, f).numpy(), np.asarray(getattr(d_64, f))
        assert _rel(got, want) <= _band(n), f
        assert _rel(np.asarray(getattr(d_j, f)), want) <= _band(n), f
        print(f"seed {seed} {f}: port vs repro f32 "
              f"{_rel(got, np.asarray(getattr(d_j, f))):.3e}, vs f64 "
              f"{_rel(got, want):.3e}, repro f32 vs f64 "
              f"{_rel(np.asarray(getattr(d_j, f)), want):.3e}")


def test_interior_refusals_and_resolution():
    arrays, q, v = _slot_instance(5)
    args = tuple(map(torch.as_tensor, arrays)) + (float(q), v)
    # No kernel runs the interior method: an explicit "cuda" is refused,
    # "auto" resolves to the plain path on every device.
    with pytest.raises(ValueError, match="method='interior'"):
        t_bcd.solve_slot(*args, n_servers=3, method="interior",
                         solver_backend="cuda")
    for dev in ("cpu", "cuda"):
        assert t_bcd.resolve_spec("auto", torch.device(dev), 12,
                                  method="interior").backend == "torch"
        assert t_bcd.resolve_spec("auto:nofuse", torch.device(dev), 10 ** 5,
                                  method="interior").tile_n is None
    assert j_bcd.resolve_spec("auto", 10 ** 5,
                              method="interior").backend == "jnp"
    # A churn mask is refused with the reference's message, before the
    # backend is looked at.
    for backend in ("auto", "torch", "cuda"):
        with pytest.raises(ValueError, match="fleet-churn mask"):
            t_bcd.solve_slot(*args, n_servers=3, method="interior",
                             active=torch.ones(12), solver_backend=backend)
    with pytest.raises(ValueError, match="fleet-churn mask"):
        j_bcd.solve_slot(*map(jnp.asarray, arrays), jnp.float32(q),
                         jnp.float32(v), n_servers=3, method="interior",
                         active=jnp.ones(12))
    with pytest.raises(ValueError, match="unknown method"):
        t_bcd.solve_slot(*args, n_servers=3, method="newton")


def test_solve_slot_interior_under_no_grad():
    """The interior solve from a caller under ``torch.no_grad()`` is
    bitwise the solve outside it; seed effort changes nothing (the method
    has no polish pass)."""
    arrays, q, v = _slot_instance(7, n=8, s=2)
    args = tuple(map(torch.as_tensor, arrays)) + (float(q), v)
    d = t_bcd.solve_slot(*args, n_servers=2, method="interior")
    with torch.no_grad():
        d_ng = t_bcd.solve_slot(*args, n_servers=2, method="interior")
    d_seed = t_bcd.solve_slot(*args, n_servers=2, method="interior",
                              solver_effort="seed")
    for f in ("r_idx", "b", "c", "aopi", "score"):
        assert torch.equal(getattr(d_ng, f), getattr(d, f)), f
        assert torch.equal(getattr(d_seed, f), getattr(d, f)), f
