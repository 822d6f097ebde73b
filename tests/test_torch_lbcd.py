"""The port's Algorithm 2-3 (first-fit, rollout, controller) held against
the JAX package on the CPU, and the import boundary of the port."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import baselines as j_base  # noqa: E402
from repro.core import binpack as j_binpack  # noqa: E402
from repro.core import lbcd as j_lbcd  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro_torch.core import baselines as t_base  # noqa: E402
from repro_torch.core import binpack as t_binpack  # noqa: E402
from repro_torch.core import lbcd as t_lbcd  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SYSTEM = dict(n_cameras=10, n_servers=3, n_slots=8, mean_bandwidth_hz=15e6,
              mean_compute_flops=20e12)


def _horizons(t=8, **kw):
    cfg = {**SYSTEM, **kw}
    hj = j_prof.EdgeSystem(**cfg).horizon(t)
    fields = {f: np.asarray(getattr(hj, f))
              for f in ("acc", "xi", "size", "eff", "budgets_b",
                        "budgets_c")}
    return hj, t_prof.horizon_from_numpy(fields, "cpu")


def _assert_rollout_contract(r_t, r_j, rtol_aopi=1e-3):
    """tests/test_slot_solver.py's backend contract: identical assignments
    on >= 75% of slots, AoPI within ``rtol_aopi`` (scalar or per camera)
    there, fleet means and q close."""
    a_t, a_j = r_t.assign.numpy(), np.asarray(r_j.assign)
    same = np.all(a_t == a_j, axis=-1)
    assert same.mean() >= 0.75, f"assignment differs on {(~same).sum()}"
    aopi_t, aopi_j = r_t.aopi.numpy(), np.asarray(r_j.aopi)
    rel = np.abs(aopi_t - aopi_j) / np.abs(aopi_j)
    bound = np.broadcast_to(rtol_aopi, rel.shape)
    assert (rel[same] <= bound[same]).all(), (
        f"AoPI off by {rel[same].max():.2e} (bound {bound[same].min():.1e})")
    np.testing.assert_allclose(aopi_t.mean(axis=-1), aopi_j.mean(axis=-1),
                               rtol=5e-3)
    np.testing.assert_allclose(r_t.q.numpy(), np.asarray(r_j.q), rtol=1e-3,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# First-fit (Algorithm 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,s,seed,load", [(10, 3, 0, 0.5), (40, 5, 1, 0.9),
                                           (25, 3, 2, 2.5), (60, 8, 3, 1.1)])
def test_first_fit_torch_bitwise(n, s, seed, load):
    """Same demands -> the same placement as first_fit_jax, including
    overloaded fleets that reach the most-remaining-volume fallback."""
    rng = np.random.default_rng(seed)
    bb = rng.uniform(1e7, 3e7, s).astype(np.float32)
    bc = rng.uniform(2e13, 6e13, s).astype(np.float32)
    b_hat = (rng.dirichlet(np.ones(n)) * bb.sum() * load).astype(np.float32)
    c_hat = (rng.dirichlet(np.ones(n)) * bc.sum() * load).astype(np.float32)
    a_j = np.asarray(j_binpack.first_fit_jax(*map(jnp.asarray,
                                                  (b_hat, c_hat, bb, bc))))
    a_t = t_binpack.first_fit_torch(*map(torch.as_tensor,
                                         (b_hat, c_hat, bb, bc)))
    assert a_t.dtype == torch.int32
    np.testing.assert_array_equal(a_t.numpy(), a_j)
    # The host copy agrees with the reference's host version.
    np.testing.assert_array_equal(
        t_binpack.first_fit(b_hat, c_hat, bb, bc),
        j_binpack.first_fit(b_hat, c_hat, bb, bc))


@pytest.mark.parametrize("seed,n,pods,per_pod,cap", [
    (0, 16, 2, 4, 20.0),       # tests/test_lbcd.py's instance
    (1, 40, 3, 4, 12.0),
    (2, 25, 2, 8, 6.0),        # overloaded: the fallbacks at both levels
    (3, 5, 4, 2, 20.0)])       # pods left empty
def test_hierarchical_first_fit_bitwise(seed, n, pods, per_pod, cap):
    rng = np.random.default_rng(seed)
    b_hat = rng.uniform(0.5, 2.0, n)
    c_hat = rng.uniform(0.5, 2.0, n)
    pb, pc = np.full(pods, cap), rng.uniform(0.8, 1.2, pods) * cap
    want = j_binpack.hierarchical_first_fit(b_hat, c_hat, pb, pc, per_pod)
    got = t_binpack.hierarchical_first_fit(b_hat, c_hat, pb, pc, per_pod)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < pods * per_pod


# ---------------------------------------------------------------------------
# Rollout (Algorithm 3) and the controller
# ---------------------------------------------------------------------------

def test_rollout_matches_reference():
    """Against both of the reference's backends (jnp and Pallas) by the
    contract, per camera at rtol=1e-3 or, where those two backends
    disagree with each other by more, at 1.1 times their gap. On this
    horizon that is one camera of one slot (2.0e-3): an allocation the
    fast-effort water-fill leaves short of convergence, where the result
    depends on the order of the fill sums; the port lands on the jnp value
    there."""
    hj, ht = _horizons()
    r_pl = j_lbcd.rollout(hj, 10.0, 0.7, solver_backend="pallas")
    r_jnp = j_lbcd.rollout(hj, 10.0, 0.7, solver_backend="jnp")
    r_t = t_lbcd.rollout(ht, 10.0, 0.7, device="cpu")
    ref_gap = np.abs(np.asarray(r_pl.aopi) / np.asarray(r_jnp.aopi) - 1.0)
    bound = np.maximum(1e-3, 1.1 * ref_gap)
    assert (bound > 1e-3).sum() <= 1
    _assert_rollout_contract(r_t, r_jnp, rtol_aopi=bound)
    _assert_rollout_contract(r_t, r_pl, rtol_aopi=bound)
    assert r_t.decision.b.shape == (8, 10)
    assert r_t.assign.dtype == torch.int32


def test_rollout_fleet_means_at_scale():
    """N=10,000 cameras on 32 servers at the paper's per-camera share. The
    first-fit placement is chaotic in the summation order (a camera that
    moves shifts every later fit), so port and reference place most
    cameras differently; the fleet means still agree."""
    n, s = 10_000, 32
    share = n / (10 * s)
    hj, ht = _horizons(t=2, n_cameras=n, n_servers=s,
                       mean_bandwidth_hz=30e6 * share,
                       mean_compute_flops=50e12 * share, seed=0)
    r_j = j_lbcd.rollout(hj, 10.0, 0.7)
    r_t = t_lbcd.rollout(ht, 10.0, 0.7, device="cpu")
    moved = (r_t.assign.numpy() != np.asarray(r_j.assign)).mean()
    assert moved > 0.5          # the chaos this test documents
    np.testing.assert_allclose(r_t.aopi.mean(-1).numpy(),
                               np.asarray(r_j.aopi).mean(-1), rtol=1e-3)
    np.testing.assert_allclose(r_t.acc.mean(-1).numpy(),
                               np.asarray(r_j.acc).mean(-1), rtol=1e-2)


def test_rollout_nofuse_and_q0():
    hj, ht = _horizons(t=4)
    r_j = j_lbcd.rollout(hj, 5.0, 0.75, q0=0.3)
    r_t = t_lbcd.rollout(ht, 5.0, 0.75, q0=0.3, device="cpu",
                         solver_backend="torch:nofuse")
    _assert_rollout_contract(r_t, r_j)


def test_controller_run_matches_reference():
    s_j = j_lbcd.LBCDController(j_prof.EdgeSystem(**SYSTEM), v=10.0,
                                p_min=0.7)
    s_t = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM), v=10.0,
                                p_min=0.7, device="cpu")
    out_j, out_t = s_j.run(6), s_t.run(6)
    np.testing.assert_allclose(out_t.aopi_series, out_j.aopi_series,
                               rtol=5e-3)
    np.testing.assert_allclose(out_t.q_series, out_j.q_series, rtol=1e-3,
                               atol=1e-4)
    assert s_t.queue.q == pytest.approx(s_j.queue.q, rel=1e-3)
    rec = out_t.records[2]
    assert isinstance(rec.decision.b, np.ndarray) and rec.t == 2
    # plan() leaves the queue where run() put it.
    q_before = s_t.queue.q
    plan = s_t.plan(s_t.system.horizon(3, device="cpu"))
    assert plan.q.shape == (3,) and s_t.queue.q == q_before


def test_controller_legacy_step_matches_reference():
    s_j = j_lbcd.LBCDController(j_prof.EdgeSystem(**SYSTEM))
    s_t = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM), device="cpu")
    out_j = s_j.run(3, engine="legacy")
    out_t = s_t.run(3, engine="legacy")
    for rj, rt in zip(out_j.records, out_t.records):
        np.testing.assert_array_equal(rt.assign, rj.assign)
        np.testing.assert_allclose(rt.aopi, rj.aopi, rtol=1e-3)
    assert s_t.queue.q == pytest.approx(s_j.queue.q, rel=1e-3)


def test_rollout_grid_and_scenarios_match_reference():
    hj, ht = _horizons(t=3)
    vs, pm = np.array([2.0, 20.0]), np.array([0.6, 0.8])
    g_j = j_lbcd.rollout_grid(hj, jnp.asarray(vs), jnp.asarray(pm))
    g_t = t_lbcd.rollout_grid(ht, vs, pm, device="cpu")
    assert g_t.aopi.shape == (2, 3, 10)
    for i in range(2):
        _assert_rollout_contract(
            t_lbcd.RolloutResult(g_t.aopi[i], g_t.acc[i], g_t.q[i],
                                 g_t.assign[i], None),
            j_lbcd.RolloutResult(g_j.aopi[i], g_j.acc[i], g_j.q[i],
                                 g_j.assign[i], None))
    hj2, ht2 = _horizons(t=3, seed=5)
    s_j = j_lbcd.rollout_scenarios(j_prof.stack_horizons([hj, hj2]),
                                   10.0, 0.7)
    s_t = t_lbcd.rollout_scenarios(t_prof.stack_horizons([ht, ht2]),
                                   10.0, 0.7, device="cpu")
    np.testing.assert_allclose(s_t.aopi.mean(-1).numpy(),
                               np.asarray(s_j.aopi).mean(-1), rtol=5e-3)
    summary = t_lbcd.summarize(
        t_lbcd.rollout(ht, 10.0, 0.7, device="cpu"), 10.0, 0.7)
    assert len(summary.records) == 3
    with pytest.raises(ValueError, match="rollout_grid"):
        t_lbcd.rollout_grid(ht, [1.0, 2.0], [0.7], device="cpu")


# tests/test_lbcd.py's system for the paper's interior-point method.
INTERIOR_SYSTEM = dict(n_cameras=10, n_servers=2, n_slots=12, seed=6)


def test_rollout_interior_matches_reference():
    """``method="interior"`` over 4 slots, by the rollout contract: AoPI
    per camera at rtol 1e-3 or, where repro's float32 per-server solve
    strays further from its own float64 solve of the same slot, at 1.1
    times that gap. On this horizon that is five cameras of slot 1:
    repro's float32 line search stops with one camera's compute 14% (AoPI
    1.2%) off the float64 solution, the port's within 2.1e-4 (ROADMAP
    section 3). The port is held to the float64 solves at 1e-3 on every
    camera."""
    from repro.core import bcd as j_bcd
    hj = j_prof.EdgeSystem(**INTERIOR_SYSTEM).horizon(4)
    ht = t_prof.EdgeSystem(**INTERIOR_SYSTEM).horizon(4, device="cpu")
    r_j = j_lbcd.rollout(hj, 10.0, 0.7, method="interior")
    r_t = t_lbcd.rollout(ht, 10.0, 0.7, method="interior", device="cpu")
    effs = np.asarray(j_prof.eff_sequence(hj))
    q_j = np.concatenate([[0.0], np.asarray(r_j.q)[:-1]])
    a64 = []
    for t in range(4):
        args = (hj.acc[t], hj.xi, hj.size, effs[t], r_j.assign[t],
                hj.budgets_b[t], hj.budgets_c[t], q_j[t], 10.0)
        with jax.enable_x64(True):
            a64.append(np.asarray(j_bcd.solve_slot(
                *(jnp.asarray(np.asarray(a, np.float64)
                              if np.asarray(a).dtype != np.int32 else a)
                  for a in args), n_servers=2, method="interior").aopi))
    a64 = np.stack(a64)
    ref_gap = np.abs(np.asarray(r_j.aopi) / a64 - 1.0)
    bound = np.maximum(1e-3, 1.1 * ref_gap)
    print(f"repro f32 vs f64 AoPI at most {ref_gap.max():.3e} "
          f"({int((bound > 1e-3).sum())} cameras over 1e-3); port vs f64 "
          f"{np.abs(r_t.aopi.numpy() / a64 - 1.0).max():.3e}")
    print("slots with cameras over 1e-3:", sorted(set(
        np.nonzero(bound > 1e-3)[0].tolist())))
    assert ref_gap.max() > 1e-2          # repro's side of the fault
    _assert_rollout_contract(r_t, r_j, rtol_aopi=bound)
    same = np.all(r_t.assign.numpy() == np.asarray(r_j.assign), axis=-1)
    np.testing.assert_allclose(r_t.aopi.numpy()[same], a64[same], rtol=1e-3)
    np.testing.assert_array_equal(r_t.decision.m_idx.numpy(),
                                  np.asarray(r_j.decision.m_idx))


def test_interior_point_method_end_to_end():
    """tests/test_lbcd.py's property on the port: over 12 slots the
    paper's interior-point method reaches the water-fill's mean AoPI
    within 15%, and the accuracy queue stays finite."""
    ip = t_lbcd.LBCDController(t_prof.EdgeSystem(**INTERIOR_SYSTEM), v=10.0,
                               p_min=0.7, method="interior",
                               device="cpu").run(12)
    wf = t_lbcd.LBCDController(t_prof.EdgeSystem(**INTERIOR_SYSTEM), v=10.0,
                               p_min=0.7, method="waterfill",
                               device="cpu").run(12)
    assert ip.mean_aopi == pytest.approx(wf.mean_aopi, rel=0.15)
    assert np.isfinite(ip.q_series).all()


def test_reference_interior_misses_the_15pct_bar_at_the_paper_setting():
    """The reference's own 25-slot runs of the paper setting (N=30, S=3,
    seed 0): the interior method's mean AoPI is 0.76 of the water-fill's,
    outside tests/test_lbcd.py's 15% (held on that test's own system
    above), so chip_smoke.py phase 9 holds the port's two means on the
    card to these values of the reference's and reports the ratio."""
    sys.path.insert(0, str(SRC.parent))
    import chip_smoke
    got = {m: j_lbcd.LBCDController(j_prof.EdgeSystem(
        **chip_smoke.PAPER_SYSTEM), v=10.0, p_min=0.7, method=m).run(
            chip_smoke.INTERIOR_SLOTS).mean_aopi
        for m in ("interior", "waterfill")}
    for m, v in got.items():
        assert v == pytest.approx(chip_smoke.REFERENCE_PAPER_AOPI[m],
                                  rel=1e-5)
    assert got["interior"] / got["waterfill"] < 1 - 0.15


def test_min_controller_interior_matches_reference():
    """MIN with the interior method passes ``method`` through to the
    solve (2 slots)."""
    out_j = j_base.MINController(j_prof.EdgeSystem(**INTERIOR_SYSTEM),
                                 method="interior").run(2)
    out_t = t_base.MINController(t_prof.EdgeSystem(**INTERIOR_SYSTEM),
                                 method="interior", device="cpu").run(2)
    for rj, rt in zip(out_j.records, out_t.records):
        for f in ("r_idx", "m_idx", "pol"):
            np.testing.assert_array_equal(getattr(rt.decision, f),
                                          getattr(rj.decision, f))
        np.testing.assert_allclose(rt.aopi, rj.aopi, rtol=1e-3)


def test_entry_points_refuse_cpu_by_default_and_unported_masks(
        monkeypatch):
    """No kernel takes a churn mask: an explicit "cuda" with one raises
    (the masked rollout itself is held to repro in
    tests/test_torch_scenarios.py)."""
    _, ht = _horizons(t=2)
    with pytest.raises(ValueError, match="mask"):
        t_lbcd.rollout(t_prof.HorizonTables(
            ht.acc, ht.xi, ht.size, ht.eff, ht.budgets_b, ht.budgets_c,
            active=torch.ones(2, 10)), 10.0, 0.7, device="cpu",
            solver_backend="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_lbcd.rollout(ht, 10.0, 0.7)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM))


def test_port_imports_neither_jax_nor_repro():
    """Importing the port's main path loads no jax* and no repro.* module."""
    code = ("import sys, repro_torch.core.lbcd, "
            "repro_torch.kernels.slot_solver.ops, "
            "repro_torch.training.failure, repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
