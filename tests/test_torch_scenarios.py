"""The port's scenario suite (registry, generators, the sweep runner, the
robustness report) and the fleet-churn mask through Algorithm 1, LBCD and
the baselines, held against the JAX package on the CPU. On the card
(kernel sweep against the plain sweep): tests/test_torch_gpu.py."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import faults as j_faults  # noqa: E402
from repro import obs as j_obs  # noqa: E402
from repro import scenarios as j_scen  # noqa: E402
from repro.core import baselines as j_bl  # noqa: E402
from repro.core import bcd as j_bcd  # noqa: E402
from repro.core import lbcd as j_lbcd  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch import scenarios as t_scen  # noqa: E402
from repro_torch.core import baselines as t_bl  # noqa: E402
from repro_torch.core import bcd as t_bcd  # noqa: E402
from repro_torch.core import lbcd as t_lbcd  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402
from repro_torch.scenarios import runner as t_runner  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
FIELDS = ("acc", "xi", "size", "eff", "budgets_b", "budgets_c", "active")
DIMS = dict(n_cameras=7, n_servers=3, n_slots=10, seed=1)
SYSTEM = dict(n_cameras=12, n_servers=3, n_slots=6, mean_bandwidth_hz=15e6,
              mean_compute_flops=20e12)


def _assert_tables_bitwise(ht, hj, label=""):
    for f in FIELDS:
        a, b = getattr(ht, f), getattr(hj, f)
        assert (a is None) == (b is None), f"{label} {f}"
        if a is not None:
            assert a.dtype == torch.float32, f"{label} {f}"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{label} {f}")


# ---------------------------------------------------------------------------
# Registry and generators
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert t_scen.names() == j_scen.names()
    assert len(t_scen.names()) == 11
    assert t_scen.families() == j_scen.families()
    for name in t_scen.names():
        assert t_scen.family_of(name) == j_scen.family_of(name)
        over = {"n_cameras": 5, "flash_depth": 0.3,
                "params": {"p_gb": 0.2}}
        st = t_scen.spec_for(name, over, seed=4)
        sj = j_scen.spec_for(name, over, seed=4)
        assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    with pytest.raises(KeyError, match="steady_ar1"):
        t_scen.spec_for("no_such_scenario")
    assert t_runner.POLICIES == ("lbcd", "min", "dos", "jcab")


@pytest.mark.parametrize("name", j_scen.names())
def test_scenario_tables_bitwise(name):
    """Every registered scenario, at a small size and a non-default seed:
    the same float32 tables, the churn mask included."""
    ht = t_scen.build(name, DIMS, device="cpu")
    hj = j_scen.build(name, DIMS)
    _assert_tables_bitwise(ht, hj, name)
    assert (ht.active is not None) == name.startswith("camera_churn")


def test_overrides_reach_generators_bitwise():
    over = dict(DIMS, flash_depth=0.9, n_flash=5)
    _assert_tables_bitwise(t_scen.build("diurnal_flash", over, device="cpu"),
                           j_scen.build("diurnal_flash", over))
    over = dict(DIMS, churn_fraction=0.8, churn_t0=2, pool="lm")
    _assert_tables_bitwise(t_scen.build("camera_churn", over, device="cpu"),
                           j_scen.build("camera_churn", over))


def test_suite_stacks_like_reference():
    """A mixed suite gives every scenario a mask, all ones where it had
    none, as the reference's stack_horizons does."""
    names = ["steady_ar1", "camera_churn", "server_outage"]
    st = t_scen.suite(names, DIMS, device="cpu")
    sj = j_scen.suite(names, DIMS)
    assert st.names == sj.names and st.families == sj.families
    assert st.n_scenarios == 3
    _assert_tables_bitwise(st.tables, sj.tables)
    assert bool((st.tables.active[0] == 1).all())
    assert not bool((st.tables.active[1] == 1).all())


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_scen.build("steady_ar1", DIMS)
    st = t_scen.suite(["steady_ar1"], DIMS, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_scen.sweep(st, policies=("jcab",))


# ---------------------------------------------------------------------------
# The churn mask through Algorithm 1, LBCD and the baselines
# ---------------------------------------------------------------------------

def _churn_horizons():
    """A horizon with a churn mask; in slot 2 every camera of JCAB's
    round-robin server 1 (cameras 1, 4, 7, 10) is dead."""
    hj = j_prof.EdgeSystem(**SYSTEM).horizon(6)
    fields = {f: np.asarray(getattr(hj, f)) for f in FIELDS[:-1]}
    plan = j_faults.FaultPlan((j_faults.FaultSpec(
        "camera_churn", t0=1, params={"fraction": 0.5, "leave_prob": 0.2,
                                      "join_prob": 0.2}),), seed=3)
    mask = plan.camera_active(6, 12)
    mask[2, 1::3] = 0.0
    ht = t_prof.horizon_from_numpy({**fields, "active": mask}, "cpu")
    return dataclasses.replace(hj, active=jnp.asarray(mask)), ht, mask


def _slot_inputs(seed):
    """One slot's inputs on 3 servers, server 2's cameras all dead."""
    rng = np.random.default_rng(seed)
    tab = j_prof.EdgeSystem(n_cameras=10, n_servers=3, n_slots=2,
                            seed=seed).horizon(1)
    sid = np.array([0, 1, 2, 0, 1, 2, 0, 1, 0, 2], np.int32)
    act = (rng.uniform(size=10) > 0.3).astype(np.float32)
    act[sid == 2] = 0.0
    act[0] = 1.0
    host = [np.array(x) for x in (tab.acc[0], tab.xi, tab.size, tab.eff,
                                  sid, tab.budgets_b[0], tab.budgets_c[0])]
    q, v = np.float32(rng.uniform(0.0, 3.0)), float(rng.uniform(1.0, 30.0))
    return host, q, v, act


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", ["torch", "auto", "torch:nofuse"])
def test_masked_solve_slot_matches_reference(seed, backend):
    """test_solve_slot_pallas_matches_jnp's bars against the reference's
    masked jnp solve; dead cameras (a whole server included) get exact
    zeros in every per-camera output."""
    host, q, v, act = _slot_inputs(seed)
    dj = j_bcd.solve_slot(*map(jnp.asarray, host), jnp.float32(q),
                          jnp.float32(v), n_servers=3,
                          active=jnp.asarray(act))
    dt = t_bcd.solve_slot(*map(torch.as_tensor, host), float(q), v,
                          n_servers=3, solver_backend=backend,
                          active=torch.as_tensor(act))
    for f in ("r_idx", "m_idx", "pol"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(),
                                      np.asarray(getattr(dj, f)), err_msg=f)
    for f in ("b", "c", "lam", "mu", "acc", "aopi"):
        got = getattr(dt, f).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(dj, f)),
                                   rtol=5e-4, err_msg=f)
        assert (got[act == 0] == 0).all(), f
        assert (got[act == 1] > 0).all(), f
    assert float(dt.score) == pytest.approx(float(dj.score), rel=1e-4)


def _assert_same_decisions(r_t, r_j, label, aopi_rtol):
    for f in ("m_idx", "r_idx", "pol"):
        np.testing.assert_array_equal(
            getattr(r_t.decision, f).numpy(),
            np.asarray(getattr(r_j.decision, f)), err_msg=f"{label} {f}")
    np.testing.assert_array_equal(r_t.assign.numpy(), np.asarray(r_j.assign),
                                  err_msg=f"{label} assign")
    np.testing.assert_allclose(r_t.aopi.numpy(), np.asarray(r_j.aopi),
                               rtol=aopi_rtol, err_msg=f"{label} aopi")
    np.testing.assert_allclose(r_t.q.numpy(), np.asarray(r_j.q), rtol=1e-3,
                               atol=1e-4, err_msg=f"{label} q")


def _rollout_pairs():
    return {
        "lbcd": (lambda h: j_lbcd.rollout(h, 10.0, 0.7),
                 lambda h: t_lbcd.rollout(h, 10.0, 0.7, device="cpu")),
        "min": (lambda h: j_bl.rollout_min(h, 10.0),
                lambda h: t_bl.rollout_min(h, 10.0, device="cpu")),
        "dos": (lambda h: j_bl.rollout_dos(h),
                lambda h: t_bl.rollout_dos(h, device="cpu")),
        "jcab": (lambda h: j_bl.rollout_jcab(h),
                 lambda h: t_bl.rollout_jcab(h, device="cpu"))}


@pytest.mark.parametrize("name", ["lbcd", "min", "dos", "jcab"])
def test_masked_rollouts_match_reference(name):
    """Indices and assignments bitwise, AoPI within the rollout bars
    (rtol 1e-3 where Algorithm 1's water-fill runs, 1e-5 for DOS and
    JCAB, whose allocation differs only in the order of float sums), q
    as the rollout contract; dead cameras give exact zeros, including
    the slot where a whole JCAB server is dead."""
    hj, ht, mask = _churn_horizons()
    fj, ft = _rollout_pairs()[name]
    r_j, r_t = fj(hj), ft(ht)
    _assert_same_decisions(r_t, r_j, name,
                           1e-3 if name in ("lbcd", "min") else 1e-5)
    for f in ("aopi", "acc"):
        got = getattr(r_t, f).numpy()
        assert np.isfinite(got).all()
        assert (got[mask == 0] == 0).all() and (got[mask == 1] > 0).all()
    assert (r_t.decision.b.numpy()[mask == 0] == 0).all()
    assert (r_t.decision.c.numpy()[mask == 0] == 0).all()


def test_masked_lbcd_rollout_contract_on_a_scenario():
    """The camera_churn scenario itself, at N=8, through LBCD."""
    over = dict(n_cameras=8, n_servers=3, n_slots=8, seed=2, churn_t0=1)
    r_j = j_lbcd.rollout(j_scen.build("camera_churn", over), 10.0, 0.7)
    r_t = t_lbcd.rollout(t_scen.build("camera_churn", over, device="cpu"),
                         10.0, 0.7, device="cpu")
    same = np.all(r_t.assign.numpy() == np.asarray(r_j.assign), axis=-1)
    assert same.mean() >= 0.75
    np.testing.assert_allclose(r_t.aopi.numpy()[same],
                               np.asarray(r_j.aopi)[same], rtol=1e-3)
    np.testing.assert_allclose(r_t.q.numpy(), np.asarray(r_j.q), rtol=1e-3,
                               atol=1e-4)


def test_explicit_cuda_refuses_a_mask():
    """No kernel takes the mask: "cuda" with one raises ValueError naming
    it (before any device check), "auto" and "torch" run the plain path."""
    hj, ht, _ = _churn_horizons()
    for fn in (lambda: t_lbcd.rollout(ht, 10.0, 0.7, device="cpu",
                                      solver_backend="cuda"),
               lambda: t_bl.rollout_min(ht, device="cpu",
                                        solver_backend="cuda:nofuse")):
        with pytest.raises(ValueError, match="mask"):
            fn()
    host, q, v, act = _slot_inputs(0)
    with pytest.raises(ValueError, match="mask"):
        t_bcd.solve_slot(*map(torch.as_tensor, host), float(q), v,
                         n_servers=3, solver_backend="cuda",
                         active=torch.as_tensor(act))


def test_reference_all_ones_mask_is_not_bitwise_maskless():
    """The finding behind the runner's mask dispatch. In the reference, a
    masked solve with an all-ones mask (what stacking gives a maskless
    scenario) equals the maskless solve in every decision (indices,
    assignments, allocations, accuracy) but not bitwise in its floats:
    the AoPI through aopi_masked and the live-count means (sum / n_live
    against mean) differ by an ulp or two. Bounded here at 1e-6."""
    hj = j_prof.EdgeSystem(**SYSTEM).horizon(6)
    ones = dataclasses.replace(hj, active=jnp.ones((6, 12), jnp.float32))
    a, b = j_lbcd.rollout(hj, 10.0, 0.7), j_lbcd.rollout(ones, 10.0, 0.7)
    for f in ("acc", "assign"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    for f in ("r_idx", "m_idx", "pol", "b", "c"):
        np.testing.assert_array_equal(np.asarray(getattr(a.decision, f)),
                                      np.asarray(getattr(b.decision, f)))
    for f in ("aopi", "q"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        np.testing.assert_allclose(y, x, rtol=1e-6)
    assert not np.array_equal(np.asarray(a.aopi), np.asarray(b.aopi))


def test_port_all_ones_mask_and_active_none():
    """The port's masked path with an all-ones mask makes the same
    decisions as its maskless path, within the same 1e-6; and the runner
    hands an all-ones scenario to the rollout as active=None, so its
    series are bitwise those of the maskless tables."""
    ht = t_prof.EdgeSystem(**SYSTEM).horizon(6, device="cpu")
    ones = dataclasses.replace(ht, active=torch.ones(6, 12))
    a = t_lbcd.rollout(ht, 10.0, 0.7, device="cpu")
    b = t_lbcd.rollout(ones, 10.0, 0.7, device="cpu")
    assert torch.equal(a.assign, b.assign) and torch.equal(a.acc, b.acc)
    np.testing.assert_allclose(b.aopi.numpy(), a.aopi.numpy(), rtol=1e-6)
    stacked = t_prof.stack_horizons([ones, ht.window(0, 6)])
    assert stacked.active is not None
    one = t_runner.scenario(stacked, 1)
    assert one.active is None
    r_suite = t_scen.sweep(stacked, policies=("lbcd",), device="cpu")
    assert r_suite.masked == []
    for k in range(2):      # both rows: the maskless rollout's series
        np.testing.assert_array_equal(r_suite.aopi["lbcd"][k],
                                      a.aopi.mean(-1).numpy())
        np.testing.assert_array_equal(r_suite.q["lbcd"][k], a.q.numpy())


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

MIXED = ["steady_ar1", "camera_churn", "server_outage", "camera_churn_heavy"]
SWEEP_DIMS = dict(n_cameras=8, n_servers=3, n_slots=8, seed=0,
                  churn_t0=1)


@pytest.fixture(scope="module")
def sweeps():
    """The reference's vmap sweep and the port's loop sweep of a mixed
    suite with two churned scenarios, all four policies; and the
    reference's LBCD fleet means on its Pallas path for the scenarios
    without a churn mask (the masked ones run jnp on either backend)."""
    suite_j = j_scen.suite(MIXED, SWEEP_DIMS)
    sj = j_scen.sweep(suite_j, devices=jax.devices()[:1])
    t_obs.reset()
    st = t_scen.sweep(t_scen.suite(MIXED, SWEEP_DIMS, device="cpu"),
                      device="cpu")
    pallas = np.array(sj.aopi["lbcd"])
    for k, name in enumerate(MIXED):
        if not name.startswith("camera_churn"):
            one = jax.tree.map(lambda x, k=k: x[k], suite_j.tables)
            res = j_lbcd.rollout(dataclasses.replace(one, active=None),
                                 10.0, 0.7, solver_backend="pallas")
            pallas[k] = np.asarray(res.aopi).mean(-1)
    return sj, st, t_obs.events(), t_obs.snapshot(), pallas


@pytest.mark.parametrize("policy", ["lbcd", "min", "dos", "jcab"])
def test_sweep_matches_reference(sweeps, policy):
    """The rollout bars of tests/test_slot_solver.py on the [K, T] fleet
    means: AoPI rtol 5e-3, accuracy 1e-3, q rtol 1e-3 / atol 1e-4. For
    LBCD the AoPI bar is, per slot, 5e-3 or 1.1 times the gap between the
    reference's own jnp and Pallas runs, where larger: in steady_ar1's
    slot 5 the two place the cameras differently (a first-fit tie that
    their fill sums break apart, ROADMAP section 3) and their fleet means
    differ by 2.9%; the port lands on the Pallas value there."""
    sj, st, _, _, pallas = sweeps
    assert st.errors == {} and sj.errors == {}
    assert st.names == sj.names and st.families == sj.families
    assert st.backend == "loop" and sj.backend == "vmap"
    assert st.masked == ["camera_churn", "camera_churn_heavy"]
    for f, rtol, atol in (("aopi", 5e-3, 0.0), ("acc", 1e-3, 0.0),
                          ("q", 1e-3, 1e-4)):
        got, want = getattr(st, f)[policy], getattr(sj, f)[policy]
        assert got.shape == (4, 8) and np.isfinite(got).all()
        if f == "aopi" and policy == "lbcd":
            gap = np.abs(pallas / want - 1.0)
            rtol = np.maximum(rtol, 1.1 * gap)
            assert (rtol > 5e-3).sum() <= 1
            assert (np.abs(got / want - 1.0) <= rtol).all(), f
            continue
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"{policy} {f}")


def test_sweep_obs_spans_and_histograms(sweeps):
    """One sweep.policy span per policy and one sweep.aopi histogram per
    (policy, family), holding every scenario's slot series."""
    _, st, events, snapshot, _ = sweeps
    spans = [e for e in events if e["name"] == "sweep.policy"]
    assert [e["args"]["policy"] for e in spans] == list(t_runner.POLICIES)
    assert all(e["args"]["backend"] == "loop" and
               e["args"]["n_scenarios"] == 4 for e in spans)
    solves = [e for e in events if e["name"] == "bcd.solve_slot"]
    assert {e["parent"] for e in solves} <= {e["id"] for e in spans}
    hists = {(m["labels"]["policy"], m["labels"]["family"]): m["count"]
             for m in snapshot if m["name"] == "sweep.aopi"}
    fams = sorted(set(st.families))
    assert set(hists) == {(p, f) for p in t_runner.POLICIES for f in fams}
    assert hists[("lbcd", "camera_churn")] == 2 * 8
    assert hists[("dos", "steady")] == 8


def test_robustness_equals_reference(sweeps):
    """The report's numbers and text from the same series (the port's)."""
    sj, st, _, _, _ = sweeps
    same = j_scen.runner.SweepResult(
        names=st.names, families=st.families, policies=st.policies,
        v=st.v, p_min=st.p_min, backend=st.backend, aopi=st.aopi,
        acc=st.acc, q=st.q)
    for pct in (95.0, 50.0):
        rt, rj = t_scen.robustness(st, pct=pct), j_scen.robustness(same,
                                                                   pct=pct)
        assert rt.rows() == rj.rows()
        assert str(rt) == str(rj)
        for p in st.policies:
            (ft, st_), (fj, sj_) = rt.worst_family(p), rj.worst_family(p)
            assert ft == fj
            assert dataclasses.asdict(st_) == dataclasses.asdict(sj_)
    assert not rt.has_measured and not rt.has_engine
    with pytest.raises(ValueError, match="dataplane"):
        rt.worst_divergence("lbcd")


def test_sweep_refusals():
    st = t_scen.suite(["steady_ar1", "camera_churn"], SWEEP_DIMS,
                      device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        t_scen.sweep(st, backend="vmap", device="cpu")
    with pytest.raises(ValueError, match="unknown dataplane_params"):
        t_scen.sweep(st, dataplane=True, dataplane_params=dict(epochs=2),
                     device="cpu")
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_scen.degradation(st, fault_kinds=("meteor",), device="cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        t_scen.sweep(st, policies=("lbcd", "best"), device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        t_scen.sweep(t_scen.build("steady_ar1", SWEEP_DIMS, device="cpu"),
                     device="cpu")


def test_sweep_isolates_a_failing_policy(monkeypatch):
    """The reference's behaviour: the failing policy's series are NaN, its
    error is recorded with a sweep.policy_failed event, the rest run; an
    explicit "cuda" with a churn mask fails its policy that way."""
    st = t_scen.suite(["camera_churn"], SWEEP_DIMS, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(t_runner.baselines, "rollout_dos", boom)
    t_obs.reset()
    res = t_scen.sweep(st, policies=("dos", "jcab"), device="cpu")
    assert res.errors == {"dos": "RuntimeError: injected"}
    assert np.isnan(res.aopi["dos"]).all()
    assert np.isfinite(res.aopi["jcab"]).all()
    assert t_obs.registry().total("sweep.policy_failed.count") == 1
    res = t_scen.sweep(st, policies=("lbcd",), solver_backend="cuda",
                       device="cpu")
    assert "mask" in res.errors["lbcd"]


def test_new_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.obs, repro_torch.obs.report, "
            "repro_torch.faults, repro_torch.scenarios; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_reference_obs_untouched_by_the_port():
    """The two packages keep separate registries."""
    j_obs.reset()
    t_obs.count_dispatch("config_argmin")
    assert j_obs.registry().collect("obs.dispatch.count") == []
