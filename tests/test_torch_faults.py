"""The port's fault plane (repro_torch.faults) held against the JAX
package's on the CPU: every draw bitwise, apply_plan's tables equal."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import faults as j_faults  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro_torch import faults as t_faults  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402

FIELDS = ("acc", "xi", "size", "eff", "budgets_b", "budgets_c")


def _plans(specs, seed):
    """The same plan in both packages."""
    return (j_faults.FaultPlan(tuple(j_faults.FaultSpec(*s) for s in specs),
                               seed=seed),
            t_faults.FaultPlan(tuple(t_faults.FaultSpec(*s) for s in specs),
                               seed=seed))


def _horizons(t=10, n=12, s=3):
    hj = j_prof.EdgeSystem(n_cameras=n, n_servers=s, n_slots=t).horizon(t)
    fields = {f: np.asarray(getattr(hj, f)) for f in FIELDS}
    return hj, t_prof.horizon_from_numpy(fields, "cpu")


def test_kinds_and_spec_checks_match_reference():
    assert t_faults.FAULT_KINDS == j_faults.FAULT_KINDS
    assert t_faults.STRUCTURAL_KINDS == j_faults.STRUCTURAL_KINDS
    assert t_faults.TELEMETRY_KINDS == j_faults.TELEMETRY_KINDS
    assert t_faults.SOLVER_KINDS == j_faults.SOLVER_KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_faults.FaultSpec("meteor")
    with pytest.raises(ValueError, match="duration"):
        t_faults.FaultSpec("camera_churn", duration=-1)
    spec = t_faults.FaultSpec("server_crash", t0=3, duration=4)
    assert spec.window(5) == (3, 5) and spec.active_at(6)
    assert not spec.active_at(7) and not spec.active_at(2)
    assert issubclass(t_faults.InjectedSolverFault, RuntimeError)


CHURN_SPECS = [
    [("camera_churn", 1, None,
      {"fraction": 0.4, "leave_prob": 0.1, "join_prob": 0.3})],
    [("camera_churn", 0, 3, {"fraction": 0.9}),
     ("camera_churn", 5, None, {"leave_prob": 0.5, "join_prob": 0.05})],
]


@pytest.mark.parametrize("specs", CHURN_SPECS)
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("t,n", [(12, 9), (20, 1), (6, 40)])
def test_camera_active_bitwise(specs, seed, t, n):
    pj, pt = _plans(specs, seed)
    mj, mt = pj.camera_active(t, n), pt.camera_active(t, n)
    assert mt.dtype == mj.dtype == np.float32
    np.testing.assert_array_equal(mt, mj)
    assert (mt.sum(axis=1) >= 1).all()       # a survivor in every slot


CAPACITY_SPECS = [
    [("server_crash", 2, 4, {"server": 1, "depth": 1.0})],
    [("server_crash", 0, None, {})],
    [("correlated_fade", 1, None,
      {"fraction": 0.5, "depth": 0.7, "corr": 0.9})],
    [("correlated_fade", 0, 5, {}), ("server_crash", 3, 2, {"depth": 0.5})],
]


@pytest.mark.parametrize("specs", CAPACITY_SPECS)
@pytest.mark.parametrize("seed", [0, 11])
def test_capacity_factor_bitwise(specs, seed):
    pj, pt = _plans(specs, seed)
    for t, s in ((10, 3), (7, 1), (12, 8)):
        np.testing.assert_array_equal(pt.capacity_factor(t, s),
                                      pj.capacity_factor(t, s))


@pytest.mark.parametrize("solver", [True, False])
@pytest.mark.parametrize("n_slots,seed", [(9, 0), (30, 5), (3, 1)])
def test_storm_plan_bitwise(solver, n_slots, seed):
    """Every kind's draws and every per-epoch consultation."""
    pj = j_faults.storm_plan(n_slots, seed=seed, solver=solver)
    pt = t_faults.storm_plan(n_slots, seed=seed, solver=solver)
    assert pt.kinds == pj.kinds
    assert [(s.kind, s.t0, s.duration, s.params) for s in pt.specs] == \
        [(s.kind, s.t0, s.duration, s.params) for s in pj.specs]
    np.testing.assert_array_equal(pt.camera_active(n_slots, 10),
                                  pj.camera_active(n_slots, 10))
    np.testing.assert_array_equal(pt.capacity_factor(n_slots, 3),
                                  pj.capacity_factor(n_slots, 3))
    for t in range(n_slots + 2):
        fj, ft = pj.telemetry_fault(t), pt.telemetry_fault(t)
        assert (ft is None) == (fj is None)
        if ft is not None:
            assert (ft.kind, ft.t0) == (fj.kind, fj.t0)
        for attempt in range(3):
            assert pt.solver_fault(t, attempt) == pj.solver_fault(t, attempt)


def test_telemetry_fault_coin_matches_reference():
    specs = [("telemetry_drop", 0, None, {"prob": 0.4})]
    pj, pt = _plans(specs, 3)
    hits_j = [pj.telemetry_fault(t) is not None for t in range(50)]
    hits_t = [pt.telemetry_fault(t) is not None for t in range(50)]
    assert hits_t == hits_j and 5 < sum(hits_t) < 45


@pytest.mark.parametrize("with_mask", [False, True])
def test_apply_plan_tables_equal(with_mask):
    """The storm plan's mask (intersected with an existing one) and its
    floored budgets, bitwise the reference's; tensors on the tables'
    device."""
    hj, ht = _horizons()
    if with_mask:
        base = np.ones((10, 12), np.float32)
        base[4:, 0] = 0.0
        hj = dataclasses.replace(hj, active=jnp.asarray(base))
        ht = dataclasses.replace(ht, active=torch.as_tensor(base))
    oj = j_faults.apply_plan(j_faults.storm_plan(10, seed=2), hj)
    ot = t_faults.apply_plan(t_faults.storm_plan(10, seed=2), ht)
    for f in FIELDS + ("active",):
        got = getattr(ot, f)
        assert isinstance(got, torch.Tensor) and got.device == ht.acc.device
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(oj, f)),
                                      err_msg=f)
    # The crash zeroes server 0 for a third of the horizon: floored, not 0.
    assert (ot.budgets_b > 0).all() and (ot.budgets_c > 0).all()


def test_apply_plan_none_is_the_same_object():
    _, ht = _horizons()
    assert t_faults.apply_plan(None, ht) is ht
    telemetry_only = t_faults.FaultPlan(
        (t_faults.FaultSpec("telemetry_drop", t0=1, duration=2),), seed=0)
    assert t_faults.apply_plan(telemetry_only, ht) is ht
    churn = t_faults.FaultPlan(
        (t_faults.FaultSpec("camera_churn", t0=1),), seed=0)
    out = t_faults.apply_plan(churn, ht)
    assert out is not ht and out.active is not None
    assert out.budgets_b is ht.budgets_b      # no capacity spec: untouched
