"""The port's scenario replay (``serving.replay``), the sweep's data-plane
replay (``scenarios.sweep(dataplane=True)``) and the degradation report
(``scenarios.degradation``) held against the JAX package on the CPU, with
the bars of test_torch_service.py: predicted AoPI within the rollout bars,
measured AoPI within the data plane's bars plus the gap the plans leave in
the plane's rates. On the card: tests/test_torch_gpu.py and phase 8 of
chip_smoke.py."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import faults as j_faults  # noqa: E402
from repro import scenarios as j_scen  # noqa: E402
from repro.core import queues as j_queues  # noqa: E402
from repro.serving import replay as j_replay  # noqa: E402
from repro_torch import faults as t_faults  # noqa: E402
from repro_torch import scenarios as t_scen  # noqa: E402
from repro_torch.core import baselines as t_bl  # noqa: E402
from repro_torch.core import lbcd as t_lbcd  # noqa: E402
from repro_torch.core import queues as t_queues  # noqa: E402
from repro_torch.serving import replay as t_replay  # noqa: E402

DIMS = dict(n_cameras=5, n_slots=6, n_servers=2, mean_bandwidth_hz=15e6,
            mean_compute_flops=20e12, seed=1)
MIX = ["steady_ar1", "camera_churn", "gilbert_elliott"]
RTOL = {np.float32: 1e-4, np.float64: 1e-9}
GAP_FACTOR = 10.0       # as in test_torch_service.py


def _record(monkeypatch, queues_mod, calls):
    """Record every window's rates, dtype and fleet-independent AoPI."""
    inner = queues_mod.gi_g1_window

    def wrapper(lam, mu, p, pol, **kw):
        out = inner(lam, mu, p, pol, **kw)
        dtype = (np.float64 if kw["n_frames"] > queues_mod.F32_MAX_FRAMES
                 or kw.get("delay_model", "mm1") in
                 queues_mod.HEAVY_TAIL_MODELS else np.float32)
        calls.append((np.atleast_2d(lam).copy(), np.atleast_2d(mu).copy(),
                      dtype, out["aopi"].copy()))
        return out

    monkeypatch.setattr(queues_mod, "gi_g1_window", wrapper)


def _window_bars(cj, ct):
    """Per recorded window pair: the measured AoPI within its bar, and the
    window's largest bar (what its fleet means may differ by)."""
    assert len(cj) == len(ct) > 0
    bars = []
    for (la, ma, da, aa), (lb, mb, db, ab) in zip(cj, ct):
        assert da == db and la.shape == lb.shape
        with np.errstate(invalid="ignore", divide="ignore"):
            g = np.nan_to_num(np.maximum(np.abs(lb / la - 1.0),
                                         np.abs(mb / ma - 1.0)))
        bar = RTOL[da] + GAP_FACTOR * g
        np.testing.assert_array_less(np.abs(ab - aa),
                                     bar * np.abs(aa) + 1e-300)
        bars.append(float(bar.max()))
    return max(bars)


def _suites():
    return (j_scen.suite(MIX, DIMS), t_scen.suite(MIX, DIMS, device="cpu"))


def test_table_system_and_controllers():
    tab = t_scen.build("steady_ar1", DIMS, device="cpu")
    sys_t = t_replay.TableSystem(tab)
    sys_j = j_replay.TableSystem(j_scen.build("steady_ar1", DIMS))
    assert (sys_t.n_cameras, sys_t.n_servers, sys_t.n_slots) == \
        (sys_j.n_cameras, sys_j.n_servers, sys_j.n_slots)
    for t in (0, 7):
        for x, y in zip(sys_t.capacities(t), sys_j.capacities(t)):
            np.testing.assert_array_equal(x, np.asarray(y))
        a, b = sys_t.tables(t), sys_j.tables(t)
        for f in ("acc", "xi", "size", "eff"):
            np.testing.assert_array_equal(getattr(a, f),
                                          np.asarray(getattr(b, f)))
    assert sys_t.horizon(4).n_slots == 4
    with pytest.raises(ValueError, match="exceeds"):
        sys_t.horizon(7)
    stacked = t_scen.suite(MIX, DIMS, device="cpu").tables
    with pytest.raises(ValueError, match="ONE scenario"):
        t_replay.TableSystem(stacked)
    kinds = {"lbcd": t_lbcd.LBCDController, "min": t_bl.MINController,
             "dos": t_bl.DOSController, "jcab": t_bl.JCABController}
    for policy, cls in kinds.items():
        ctrl = t_replay.make_controller(policy, sys_t, device="cpu",
                                        policy_params={"n_bcd_iters": 3})
        assert type(ctrl) is cls and ctrl.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        t_replay.make_controller("best", sys_t)


@pytest.mark.parametrize("policy", ["lbcd", "jcab"])
def test_replay_tables_matches_reference(monkeypatch, policy):
    """One scenario with telemetry feedback (gain 0.3) and the fitted
    selector, float32 windows."""
    cj, ct = [], []
    _record(monkeypatch, j_queues, cj)
    _record(monkeypatch, t_queues, ct)
    kw = dict(n_epochs=6, epoch_duration=4.0, telemetry_gain=0.3,
              delay_model="auto", seed=3)
    a = j_replay.replay_tables(j_scen.build("gilbert_elliott", DIMS), policy,
                               **kw)
    b = t_replay.replay_tables(
        t_scen.build("gilbert_elliott", DIMS, device="cpu"), policy,
        device="cpu", **kw)
    bar = _window_bars(cj, ct)
    np.testing.assert_allclose(b.predicted, a.predicted, rtol=5e-3)
    np.testing.assert_allclose(b.acc, a.acc, rtol=1e-3)
    np.testing.assert_allclose(b.measured, a.measured, rtol=bar)
    assert b.fitted == a.fitted and b.service.planner == "scan"
    assert b.service.plan_window == 6 == a.service.plan_window


def test_replay_suite_matches_reference(monkeypatch):
    """Every policy over a mixed suite with a churned scenario (the
    reference replays the other two with their all-ones masks, the port
    without: the same fleet means), float64 windows."""
    cj, ct = [], []
    _record(monkeypatch, j_queues, cj)
    _record(monkeypatch, t_queues, ct)
    sj, st = _suites()
    kw = dict(n_epochs=4, epoch_duration=8.0, seed=2)
    a = j_replay.replay_suite(sj, **kw)
    b = t_replay.replay_suite(st, device="cpu", **kw)
    bar = _window_bars(cj, ct)
    assert (b.names, b.families, b.policies) == (a.names, a.families,
                                                 a.policies)
    assert b.errors == {} == a.errors
    for p in b.policies:
        np.testing.assert_allclose(b.predicted[p], a.predicted[p],
                                   rtol=5e-3, err_msg=p)
        np.testing.assert_allclose(b.measured[p], a.measured[p], rtol=bar,
                                   err_msg=p)
        # The predicted bar (5e-3) and the measured one, on a ratio.
        np.testing.assert_allclose(b.divergence(p), a.divergence(p),
                                   rtol=0.0, atol=1e-2, err_msg=p)
        assert b.fallbacks[p] == a.fallbacks[p] == [[], [], []]


def test_replay_suite_isolates_a_failing_cell(monkeypatch):
    st = t_scen.suite(["steady_ar1"], DIMS, device="cpu")

    make = t_replay.make_controller

    def boom(policy, *a, **k):
        if policy == "dos":
            raise RuntimeError("injected")
        return make(policy, *a, **k)

    monkeypatch.setattr(t_replay, "make_controller", boom)
    res = t_replay.replay_suite(st, policies=("dos", "jcab"), n_epochs=2,
                                epoch_duration=2.0, device="cpu")
    assert res.errors == {("steady_ar1", "dos"): "RuntimeError: injected"}
    assert np.isnan(res.measured["dos"]).all()
    assert np.isfinite(res.measured["jcab"]).all()
    with pytest.raises(ValueError, match="stacked"):
        t_replay.replay_suite(t_scen.build("steady_ar1", DIMS, device="cpu"))
    with pytest.raises(ValueError, match="unknown policy"):
        t_replay.replay_suite(st, policies=("best",), device="cpu")


def test_sweep_dataplane_matches_reference(monkeypatch):
    """sweep(dataplane=True) with two delay models and the engine rung on
    the scan backend: every data-plane field, the divergences and the
    robustness report (measured and engine column sets) against the
    reference's."""
    cj, ct = [], []
    _record(monkeypatch, j_queues, cj)
    _record(monkeypatch, t_queues, ct)
    sj, st = _suites()
    dp = dict(n_epochs=3, epoch_duration=2.0, delay_model=("mm1", "uniform"),
              mode="engine", engine_params={"backend": "scan",
                                            "frames_cap": 256})
    a = j_scen.sweep(sj, devices=jax.devices()[:1], dataplane=True,
                     dataplane_params=dp)
    b = t_scen.sweep(st, dataplane=True, dataplane_params=dp, device="cpu")
    bar = _window_bars(cj, ct)
    assert b.delay_models == a.delay_models == ("mm1", "uniform")
    assert b.errors == {} == a.errors
    for dm in b.delay_models:
        for p in b.policies:
            for f, rtol in (("measured_by_model", bar),
                            ("predicted_by_model", 5e-3),
                            ("engine_by_model", bar)):
                got, want = getattr(b, f)[dm][p], getattr(a, f)[dm][p]
                assert got.shape == (3, 3)
                np.testing.assert_allclose(got, want, rtol=rtol,
                                           err_msg=f"{f} {dm} {p}")
            # The predicted bar (5e-3) and the measured one, on a ratio.
            np.testing.assert_allclose(b.divergence(p, dm),
                                       a.divergence(p, dm), atol=1e-2)
    for p in b.policies:
        np.testing.assert_array_equal(b.measured_aopi[p],
                                      b.measured_by_model["mm1"][p])
        np.testing.assert_array_equal(b.engine_aopi[p],
                                      b.engine_by_model["mm1"][p])
    with pytest.raises(ValueError, match="not replayed"):
        b.divergence("lbcd", "gamma")
    # The report, from the port's series through both packages.
    same = j_scen.runner.SweepResult(
        names=b.names, families=b.families, policies=b.policies, v=b.v,
        p_min=b.p_min, backend=b.backend, aopi=b.aopi, acc=b.acc, q=b.q,
        measured_aopi=b.measured_aopi, predicted_aopi=b.predicted_aopi,
        delay_models=b.delay_models, measured_by_model=b.measured_by_model,
        predicted_by_model=b.predicted_by_model, engine_aopi=b.engine_aopi,
        engine_by_model=b.engine_by_model)
    rt, rj = t_scen.robustness(b), j_scen.robustness(same)
    assert rt.has_measured and rt.has_engine
    assert rt.rows() == rj.rows() and str(rt) == str(rj)
    for p in b.policies:
        assert rt.worst_divergence(p) == rj.worst_divergence(p)


def test_sweep_dataplane_refusals():
    st = t_scen.suite(["steady_ar1"], {**DIMS, "n_slots": 2}, device="cpu")
    with pytest.raises(ValueError, match="unknown dataplane_params.*epochs"):
        t_scen.sweep(st, dataplane=True, dataplane_params=dict(epochs=2),
                     device="cpu")
    res = t_scen.sweep(st, policies=("jcab",), device="cpu")
    assert res.measured_aopi is None
    with pytest.raises(ValueError, match="dataplane"):
        res.divergence("jcab")


def test_degradation_matches_reference():
    """Clean and faulted replays of a churn window and a solver-NaN band:
    the report's rows (recovery, fallbacks, degraded epochs exactly; the
    AoPI means within the measured bars) and text layout."""
    kw = dict(fault_kinds=("camera_churn", "solver_nan"),
              policies=("lbcd", "dos"), n_epochs=6, plan_window=3,
              epoch_duration=4.0, seed=1)
    a = j_scen.degradation(j_scen.suite(["steady_ar1"], DIMS), **kw)
    b = t_scen.degradation(t_scen.suite(["steady_ar1"], DIMS, device="cpu"),
                           device="cpu", **kw)
    assert (b.policies, b.fault_kinds, b.fault_window, b.tolerance) == \
        (a.policies, a.fault_kinds, a.fault_window, a.tolerance)
    for p in b.policies:
        for k in b.fault_kinds:
            x, y = dataclasses.asdict(a.table[p][k]), \
                dataclasses.asdict(b.table[p][k])
            for f in ("clean_aopi", "faulted_aopi"):
                assert y[f] == pytest.approx(x[f], rel=2e-3), (p, k, f)
            for f in ("recovery_epochs", "fallbacks", "degraded_epochs",
                      "errors"):
                assert y[f] == x[f], (p, k, f)
    assert b.table["lbcd"]["solver_nan"].fallbacks > 0
    assert len(b.rows()) == len(a.rows()) == 4
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_scen.degradation(t_scen.suite(["steady_ar1"], DIMS, device="cpu"),
                           fault_kinds=("meteor",), device="cpu")


def test_fault_plans_agree():
    """The same one-kind plans in both packages (degradation's)."""
    from repro.scenarios import report as j_report
    from repro_torch.scenarios import report as t_report
    for kind in t_faults.FAULT_KINDS:
        a = j_report._plan_for_kind(kind, 2, 3, 5)
        b = t_report._plan_for_kind(kind, 2, 3, 5)
        assert [dataclasses.asdict(s) for s in b.specs] == \
            [dataclasses.asdict(s) for s in a.specs]
        assert b.seed == a.seed and isinstance(b, t_faults.FaultPlan)
    assert t_faults.FAULT_KINDS == j_faults.FAULT_KINDS
