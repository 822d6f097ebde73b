"""The port's baselines (MIN, DOS, JCAB) and energy-aware LBCD held against
the JAX package on the CPU. On the card: tests/test_torch_gpu.py."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import baselines as j_bl  # noqa: E402
from repro.core import energy as j_energy  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro.kernels import slot_solver as j_ss  # noqa: E402
from repro_torch.core import baselines as t_bl  # noqa: E402
from repro_torch.core import energy as t_energy  # noqa: E402
from repro_torch.core import lbcd as t_lbcd  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402
from repro_torch.kernels.slot_solver import ops as t_ops  # noqa: E402
from repro_torch.kernels.slot_solver import ref as t_ref  # noqa: E402

SYSTEM = dict(n_cameras=40, n_servers=3, n_slots=4)


def _horizons(t=4, **kw):
    cfg = {**SYSTEM, **kw}
    hj = j_prof.EdgeSystem(**cfg).horizon(t)
    fields = {f: np.asarray(getattr(hj, f))
              for f in ("acc", "xi", "size", "eff", "budgets_b",
                        "budgets_c")}
    return hj, t_prof.horizon_from_numpy(fields, "cpu")


def _config_inputs(n, seed=0, m=5, r=6):
    rng = np.random.default_rng(seed)
    acc = rng.uniform(0.2, 0.95, (n, m, r)).astype(np.float32)
    xi = np.sort(rng.uniform(1e9, 2e11, (m, r)), axis=1).astype(np.float32)
    size = (1.2 * np.asarray(j_prof.RESOLUTIONS)[:r] ** 2).astype(np.float32)
    eff = rng.uniform(4.0, 7.0, n).astype(np.float32)
    b = rng.uniform(1e6, 1e7, n).astype(np.float32)
    c = rng.uniform(1e12, 1e13, n).astype(np.float32)
    return b, c, acc, xi, size, eff


# ---------------------------------------------------------------------------
# baseline_argmax: the plain version vs the reference's ref and Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,threshold",
                         [("dos", 0.3), ("dos", 3.0),
                          ("jcab", 0.5), ("jcab", 1e-6)])
def test_baseline_argmax_ref_matches_reference(mode, threshold):
    """Bitwise against repro's materialized scan and its Pallas kernel in
    interpret mode (a camera tile that does not divide N), including
    JCAB's all-infeasible fallback (threshold=1e-6)."""
    for seed in range(3):
        inputs = _config_inputs(29, seed=seed)
        port = t_ref.baseline_argmax_ref(*map(torch.as_tensor, inputs),
                                         mode=mode, threshold=threshold)
        j_in = tuple(map(jnp.asarray, inputs))
        ref = j_ss.baseline_argmax_ref(*j_in, mode=mode, threshold=threshold)
        pallas = j_ss.baseline_argmax(*j_in, mode=mode, threshold=threshold,
                                      backend="pallas", block_n=16)
        for other, label in ((ref, "jnp ref"), (pallas, "pallas")):
            for name, a, o in zip(("m", "r"), port, other):
                assert a.dtype == torch.int32
                np.testing.assert_array_equal(
                    a.numpy(), np.asarray(o),
                    err_msg=f"{label} {name} seed={seed}")
        # The CPU wrapper is the plain version and launches nothing.
        t_ops.reset_launches()
        out = t_ops.baseline_argmax(*map(torch.as_tensor, inputs), mode=mode,
                                    threshold=threshold)
        assert all(torch.equal(a, b) for a, b in zip(out, port))
        assert t_ops.launches["baseline_argmax"] == 0


# Every lane count the kernel launches (kernel.scan_lanes), and 1 (the
# sequential scan).
LANES = [1, 2, 4, 8, 16, 32]
# Thresholds on tied_scan_inputs: DOS at weight 0 (the scores are the
# accuracies, maxima duplicated) and 1 (b = 0 rows tie at ~ -1e9), JCAB
# with no config under the cap (the fallback), under the cap that exactly
# the tied least-latency pair meets ("pair"), and at 0.5.
TIED_SCANS = [("dos", 0.0), ("dos", 1.0), ("jcab", 1e-6), ("jcab", "pair"),
              ("jcab", 0.5)]


@pytest.mark.parametrize("mode,threshold", TIED_SCANS)
@pytest.mark.parametrize("n,seed", [(40, 0), (37, 1)])
def test_baseline_argmax_planted_ties_bitwise(n, seed, mode, threshold):
    """On inputs with exact ties (``tied_scan_inputs``), the reference's
    jnp scan and its Pallas kernel (interpret mode), the port's plain
    version and its lane twins at every L pick the same indices bitwise
    (no near-tie allowance: the tied values are the same floats)."""
    inputs = t_ref.tied_scan_inputs(n, seed)
    cap = t_ref.tied_jcab_cap(*(inputs[k] for k in (0, 1, 3, 4, 5)))
    threshold = cap if threshold == "pair" else threshold
    port = t_ref.baseline_argmax_ref(*map(torch.as_tensor, inputs),
                                     mode=mode, threshold=threshold)
    flat = port[0].numpy() * 6 + port[1].numpy()
    if mode == "jcab" and threshold <= cap:
        # Only the tied pair (flat 6 and 18) meets the cap, or nothing
        # does: the fallback's least latency is the same pair; b = 0 rows
        # tie everywhere and give flat 0.
        assert (flat[3::4] == 0).all() and (np.delete(
            flat, np.arange(3, n, 4)) == 6).all(), flat
    if mode == "dos" and threshold == 0.0:
        assert flat[1] == 0            # all +-0, -0.0 first
        assert (flat[::3] == 8).all()  # four tied maxima, the first wins
    j_in = tuple(map(jnp.asarray, inputs))
    others = {
        "jnp ref": j_ss.baseline_argmax_ref(*j_in, mode=mode,
                                            threshold=threshold),
        "pallas": j_ss.baseline_argmax(*j_in, mode=mode, threshold=threshold,
                                       backend="pallas", block_n=16)}
    for lanes in LANES:
        others[f"lanes={lanes}"] = t_ref.baseline_argmax_lanes_ref(
            *map(torch.as_tensor, inputs), mode=mode, threshold=threshold,
            lanes=lanes)
    for label, other in others.items():
        for name, a, o in zip(("m", "r"), port, other):
            np.testing.assert_array_equal(a.numpy(), np.asarray(o),
                                          err_msg=f"{label} {name}")


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("mode,threshold",
                         [("dos", 0.3), ("dos", 3.0), ("jcab", 0.5),
                          ("jcab", 1e-6)])
def test_baseline_argmax_lanes_ref_equals_plain(mode, threshold, lanes):
    """The kernel's order (lanes, then a butterfly) picks the plain
    version's indices bitwise on random and paper-pool inputs."""
    tab = j_prof.EdgeSystem(n_cameras=300, n_servers=3, n_slots=2,
                            seed=1).horizon(1)
    rng = np.random.default_rng(1)
    paper = (rng.uniform(0.3, 3.0, 300).astype(np.float32) * 3e6,
             rng.uniform(0.3, 3.0, 300).astype(np.float32) * 5e12,
             np.array(tab.acc[0]), np.array(tab.xi), np.array(tab.size),
             np.array(tab.eff))
    for inputs in (_config_inputs(64, seed=2), paper):
        args = tuple(map(torch.as_tensor, inputs))
        got = t_ref.baseline_argmax_lanes_ref(*args, mode=mode,
                                              threshold=threshold,
                                              lanes=lanes)
        want = t_ref.baseline_argmax_ref(*args, mode=mode,
                                         threshold=threshold)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_baseline_argmax_rejects_unknown_mode():
    inputs = tuple(map(torch.as_tensor, _config_inputs(4)))
    with pytest.raises(ValueError, match="unknown baseline scan mode"):
        t_ops.baseline_argmax(*inputs, mode="min", threshold=1.0)
    with pytest.raises(ValueError, match="unknown baseline scan mode"):
        t_ref.baseline_argmax_ref(*inputs, mode="min", threshold=1.0)
    with pytest.raises(ValueError, match="unknown baseline scan mode"):
        t_ref.baseline_argmax_lanes_ref(*inputs, mode="min", threshold=1.0,
                                        lanes=8)


# ---------------------------------------------------------------------------
# Rollouts
# ---------------------------------------------------------------------------

def _assert_same_decisions(r_t, r_j, label, aopi_rtol):
    for f in ("m_idx", "r_idx", "pol"):
        np.testing.assert_array_equal(
            getattr(r_t.decision, f).numpy(),
            np.asarray(getattr(r_j.decision, f)), err_msg=f"{label} {f}")
    np.testing.assert_array_equal(r_t.assign.numpy(), np.asarray(r_j.assign),
                                  err_msg=f"{label} assign")
    np.testing.assert_allclose(r_t.aopi.numpy(), np.asarray(r_j.aopi),
                               rtol=aopi_rtol, err_msg=f"{label} aopi")
    np.testing.assert_array_equal(r_t.q.numpy(), np.asarray(r_j.q))


@pytest.mark.parametrize("name,kw", [("dos", {}), ("dos", {"weight": 3.0}),
                                     ("jcab", {}),
                                     ("jcab", {"latency_cap": 1e-6})])
def test_dos_jcab_rollouts_match_reference(name, kw):
    """Indices, policies and assignments bitwise; the allocation differs
    from the reference only in the order of its float sums."""
    hj, ht = _horizons()
    fn_j = {"dos": j_bl.rollout_dos, "jcab": j_bl.rollout_jcab}[name]
    fn_t = {"dos": t_bl.rollout_dos, "jcab": t_bl.rollout_jcab}[name]
    r_t = fn_t(ht, **kw, device="cpu")
    for backend in ("jnp", "pallas"):
        r_j = fn_j(hj, **kw, solver_backend=backend)
        _assert_same_decisions(r_t, r_j, f"{name} vs {backend}", 1e-5)
        np.testing.assert_allclose(r_t.decision.b.numpy(),
                                   np.asarray(r_j.decision.b), rtol=1e-5)


def test_min_rollout_matches_reference():
    """MIN runs Algorithm 1 on the virtual server: indices bitwise, AoPI by
    the rollout contract (water-fill floats at the solver's tolerance)."""
    hj, ht = _horizons()
    r_t = t_bl.rollout_min(ht, 10.0, device="cpu")
    for backend in ("jnp", "pallas"):
        r_j = j_bl.rollout_min(hj, 10.0, solver_backend=backend)
        _assert_same_decisions(r_t, r_j, f"min vs {backend}", 1e-3)
        np.testing.assert_allclose(r_t.aopi.numpy().mean(-1),
                                   np.asarray(r_j.aopi).mean(-1), rtol=5e-3)


def test_min_rollout_tiled_spec_equals_untiled():
    """A tiled spec changes nothing on the CPU (the plain version is the
    tiled kernel's plain version too), and matches repro's tiled Pallas
    path in interpret mode."""
    hj, ht = _horizons(t=2)
    r_t = t_bl.rollout_min(ht, device="cpu")
    r_tt = t_bl.rollout_min(ht, device="cpu", solver_backend="torch:tile=16")
    assert torch.equal(r_t.aopi, r_tt.aopi)
    r_j = j_bl.rollout_min(hj, solver_backend="pallas:tile=128")
    _assert_same_decisions(r_t, r_j, "min vs pallas:tile=128", 1e-3)


def test_min_budget_use_matches_reference():
    """MIN at N=1,000 on S=32 at the paper's per-camera share, one slot:
    the port and repro's jnp path pick the same models and use the same
    share of the pooled budgets. Both fill the bandwidth budget and leave
    most of the compute budget unused: the water-fill's dual search stops
    short at this N, in the reference as in the port."""
    n, s = 1000, 32
    share = n / (10 * s)
    cfg = dict(n_cameras=n, n_servers=s, n_slots=4, seed=0,
               mean_bandwidth_hz=30e6 * share,
               mean_compute_flops=50e12 * share)
    hj = j_prof.EdgeSystem(**cfg).horizon(1)
    ht = t_prof.EdgeSystem(**cfg).horizon(1, device="cpu")
    dec_t = t_bl.rollout_min(ht, device="cpu").decision
    dec_j = j_bl.rollout_min(hj).decision
    np.testing.assert_array_equal(dec_t.m_idx.numpy(),
                                  np.asarray(dec_j.m_idx))
    np.testing.assert_array_equal(dec_t.r_idx.numpy(),
                                  np.asarray(dec_j.r_idx))
    used = {}
    for label, dec in (("port", dec_t), ("repro", dec_j)):
        used[label] = np.array([
            np.asarray(dec.b, np.float64).sum() / ht.budgets_b.sum().item(),
            np.asarray(dec.c, np.float64).sum() / ht.budgets_c.sum().item()])
    np.testing.assert_allclose(used["port"], used["repro"], rtol=1e-5)
    assert abs(used["port"][0] - 1.0) < 1e-3
    assert 0.35 < used["port"][1] < 0.40


def test_rollouts_refuse_churn_masks():
    """Where a churn mask is refused: MIN with an explicit "cuda" (no
    kernel takes the mask; "auto" runs it on the plain path) and
    energy-aware LBCD with any backend (the reference ignores the mask
    silently, ROADMAP section 3). DOS and JCAB take the mask on every
    backend; tests/test_torch_scenarios.py holds the masked rollouts to
    the reference."""
    _, ht = _horizons(t=2)
    masked = t_prof.HorizonTables(ht.acc, ht.xi, ht.size, ht.eff,
                                  ht.budgets_b, ht.budgets_c,
                                  active=torch.ones(2, 40))
    with pytest.raises(ValueError, match="mask"):
        t_bl.rollout_min(masked, device="cpu", solver_backend="cuda")
    with pytest.raises(NotImplementedError, match="active"):
        t_energy.rollout_energy(masked, 10.0, 0.7, 2e-8, 2e-12, 1.0,
                                device="cpu")


# ---------------------------------------------------------------------------
# Controllers
# ---------------------------------------------------------------------------

CTL_SYSTEM = dict(n_cameras=12, n_servers=3, n_slots=8,
                  mean_bandwidth_hz=15e6, mean_compute_flops=20e12)


@pytest.mark.parametrize("name", ["MIN", "DOS", "JCAB"])
def test_controller_step_matches_reference(name):
    """The host step paths, slot by slot."""
    c_j = j_bl.make(name, j_prof.EdgeSystem(**CTL_SYSTEM))
    c_t = t_bl.make(name, t_prof.EdgeSystem(**CTL_SYSTEM), device="cpu")
    out_j, out_t = c_j.run(3, engine="legacy"), c_t.run(3, engine="legacy")
    for rj, rt in zip(out_j.records, out_t.records):
        np.testing.assert_array_equal(rt.assign, rj.assign)
        np.testing.assert_array_equal(np.asarray(rt.decision.m_idx),
                                      np.asarray(rj.decision.m_idx))
        np.testing.assert_array_equal(np.asarray(rt.decision.pol),
                                      np.asarray(rj.decision.pol))
        np.testing.assert_allclose(rt.aopi, rj.aopi, rtol=1e-3)
        assert isinstance(rt.aopi, np.ndarray)


@pytest.mark.parametrize("name", ["MIN", "DOS", "JCAB"])
def test_controller_run_matches_reference(name):
    c_j = j_bl.make(name, j_prof.EdgeSystem(**CTL_SYSTEM))
    c_t = t_bl.make(name, t_prof.EdgeSystem(**CTL_SYSTEM), device="cpu")
    out_j, out_t = c_j.run(4), c_t.run(4)
    np.testing.assert_allclose(out_t.aopi_series, out_j.aopi_series,
                               rtol=1e-3)
    np.testing.assert_array_equal(out_t.q_series, 0.0)
    for rj, rt in zip(out_j.records, out_t.records):
        np.testing.assert_array_equal(rt.assign, rj.assign)


def test_make_and_controller_arguments():
    sys_t = t_prof.EdgeSystem(**CTL_SYSTEM)
    assert isinstance(t_bl.make("min", sys_t, device="cpu"),
                      t_bl.MINController)
    with pytest.raises(ValueError, match="unknown baseline"):
        t_bl.make("LBCD", sys_t, device="cpu")
    with pytest.raises(TypeError, match="unknown options"):
        t_bl.MINController(sys_t, device="cpu", seed=3)


# ---------------------------------------------------------------------------
# Energy-aware LBCD
# ---------------------------------------------------------------------------

ENERGY_SYSTEM = dict(n_cameras=10, n_servers=2, n_slots=6, seed=0,
                     mean_bandwidth_hz=15e6, mean_compute_flops=15e12)


def test_energy_scales_match_reference():
    scales = 0.75 ** torch.arange(13, dtype=torch.float32)
    j_scales = 0.75 ** jnp.arange(13, dtype=jnp.float32)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(j_scales))


def test_rollout_energy_matches_reference():
    """A tight energy budget (e_max=0.25) so that z > 0 after the first
    slot: the ladder runs in both solves of the second. Cut to 7 rungs and
    2 BCD passes, in both packages, to keep the plain solves few."""
    cfg = ENERGY_SYSTEM
    hj = j_prof.EdgeSystem(**cfg).horizon(2)
    ht = t_prof.EdgeSystem(**cfg).horizon(2, device="cpu")
    args = (10.0, 0.6, 2e-8, 2e-12, 0.25)
    kw = dict(n_scales=7, n_bcd_iters=2)
    res_j, pw_j, z_j = j_energy.rollout_energy(hj, *args, **kw,
                                               solver_backend="jnp")
    res_t, pw_t, z_t = t_energy.rollout_energy(ht, *args, **kw,
                                               device="cpu")
    assert (z_t.numpy()[:-1] > 0).all()
    for f in ("m_idx", "r_idx", "pol"):
        np.testing.assert_array_equal(getattr(res_t.decision, f).numpy(),
                                      np.asarray(getattr(res_j.decision, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(res_t.assign.numpy(),
                                  np.asarray(res_j.assign))
    np.testing.assert_allclose(pw_t.numpy(), np.asarray(pw_j), rtol=1e-3)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-3)
    np.testing.assert_allclose(res_t.q.numpy(), np.asarray(res_j.q),
                               rtol=1e-3, atol=1e-4)


def test_energy_controller_matches_reference():
    """``step`` from the same queue state with z > 0 (the 13-rung ladder
    in both solves) against the reference's host step; then a loose budget
    keeps z at 0 and the controller's run is plain LBCD's."""
    kw = dict(v=10.0, p_min=0.6, n_bcd_iters=2)
    c_j = j_energy.EnergyAwareLBCD(j_prof.EdgeSystem(**ENERGY_SYSTEM),
                                   energy=j_energy.EnergyModel(e_max=0.25),
                                   **kw)
    c_t = t_energy.EnergyAwareLBCD(t_prof.EdgeSystem(**ENERGY_SYSTEM),
                                   energy=t_energy.EnergyModel(e_max=0.25),
                                   device="cpu", **kw)
    for c in (c_j, c_t):
        c.queue.q, c.z_queue.q = 0.05, 6.0
    rec_j, rec_t = c_j.step(0), c_t.step(0)
    assert isinstance(rec_t.aopi, np.ndarray) and rec_t.t == 0
    np.testing.assert_array_equal(rec_t.assign, rec_j.assign)
    np.testing.assert_array_equal(np.asarray(rec_t.decision.m_idx),
                                  np.asarray(rec_j.decision.m_idx))
    assert rec_t.power == pytest.approx(rec_j.power, rel=1e-3)
    assert rec_t.z == pytest.approx(rec_j.z, rel=1e-3)
    assert c_t.z_queue.q == pytest.approx(c_j.z_queue.q, rel=1e-3)
    assert c_t.queue.q == pytest.approx(c_j.queue.q, rel=1e-3, abs=1e-4)
    # A loose budget keeps z at 0, and the decisions are plain LBCD's.
    loose = t_energy.EnergyAwareLBCD(t_prof.EdgeSystem(**ENERGY_SYSTEM),
                                     energy=t_energy.EnergyModel(e_max=100.0),
                                     device="cpu", **kw)
    plain = t_lbcd.LBCDController(t_prof.EdgeSystem(**ENERGY_SYSTEM),
                                  device="cpu", **kw)
    out, out_p = loose.run(2), plain.run(2)
    assert all(r.z == 0.0 for r in out.records)
    np.testing.assert_array_equal(out.aopi_series, out_p.aopi_series)
    np.testing.assert_array_equal(out.q_series, out_p.q_series)
