"""The port's ``AnalyticsService`` held against the JAX package's on the
CPU: both planners, the GI/G/1 plane under "mm1" and the fitted selector,
the telemetry EWMA, divergence replanning, the telemetry and solver
faults through the degradation ladder, and the engine rung (DES and
scan). Decisions equal; q, predicted AoPI and accuracy within
tests/test_slot_solver.py's rollout bars; measured AoPI per stream within
the data plane's bars (test_torch_dataplane.py) plus the gap the plans
leave in the rates the plane is given. On the card:
tests/test_torch_gpu.py."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import faults as j_faults  # noqa: E402
from repro.core import lbcd as j_lbcd  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro.core import queues as j_queues  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch import faults as t_faults  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core import lbcd as t_lbcd  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402
from repro_torch.core import queues as t_queues  # noqa: E402
from repro_torch.serving import service as t_service  # noqa: E402

SYSTEM = dict(n_cameras=6, n_servers=2, n_slots=12, seed=3)
#: The data plane's bars (test_torch_dataplane.py) by window dtype, and
#: the factor on the plan's rate gap: a relative change of lam or mu moves
#: every delay of the lane by the same factor, and AoPI by at most a few
#: times that short of saturation (the planner keeps 5% stability margin).
RTOL = {np.float32: 1e-4, np.float64: 1e-9}
GAP_FACTOR = 10.0


def _record(monkeypatch, queues_mod, calls):
    """Wrap ``queues_mod.gi_g1_window`` to record every window's epochs,
    rates, dtype and measured AoPI."""
    inner = queues_mod.gi_g1_window

    def wrapper(lam, mu, p, pol, **kw):
        out = inner(lam, mu, p, pol, **kw)
        f = kw["n_frames"]
        dtype = (np.float64 if f > queues_mod.F32_MAX_FRAMES or
                 kw.get("delay_model", "mm1") in queues_mod.HEAVY_TAIL_MODELS
                 else np.float32)
        lam, mu = np.atleast_2d(lam), np.atleast_2d(mu)
        for e in range(lam.shape[0]):
            calls.append((kw["t0"] + e, lam[e].copy(), mu[e].copy(), dtype,
                          out["aopi"][e].copy()))
        return out

    monkeypatch.setattr(queues_mod, "gi_g1_window", wrapper)


def _decisions(monkeypatch, service_cls, out):
    inner = service_cls._slot_record

    def wrapper(self, t):
        rec = inner(self, t)
        d = rec.decision
        out.append((t, *(np.asarray(x).copy() for x in (
            d.r_idx, d.m_idx, d.pol, rec.assign))))
        return rec

    monkeypatch.setattr(service_cls, "_slot_record", wrapper)


def _plans(kind_specs):
    """The same fault plan in both packages."""
    if kind_specs is None:
        return None, None
    return tuple(mod.FaultPlan(tuple(mod.FaultSpec(k, **kw)
                                     for k, kw in kind_specs), seed=2)
                 for mod in (j_faults, t_faults))


def _run_pair(monkeypatch, n_epochs=6, faults=None, controllers=None,
              **kw):
    """The reference's and the port's service over the same system, with
    their windows and decisions recorded."""
    rec = {"j": [], "t": [], "dj": [], "dt": []}
    _record(monkeypatch, j_queues, rec["j"])
    _record(monkeypatch, t_queues, rec["t"])
    _decisions(monkeypatch, j_service.AnalyticsService, rec["dj"])
    _decisions(monkeypatch, t_service.AnalyticsService, rec["dt"])
    fj, ft = _plans(faults)
    if controllers is None:
        cj = j_lbcd.LBCDController(j_prof.EdgeSystem(**SYSTEM), v=10.0,
                                   p_min=0.6)
        ct = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM), v=10.0,
                                   p_min=0.6, device="cpu")
    else:
        cj, ct = controllers
    sj = j_service.AnalyticsService(cj, faults=fj, **kw)
    st = t_service.AnalyticsService(ct, faults=ft, **kw)
    assert st.device == torch.device("cpu")
    rj, rt = sj.run(n_epochs), st.run(n_epochs)
    return sj, st, rj, rt, rec


def _compare(sj, st, rj, rt, rec, engine=False):
    """The bars of the module docstring; returns the largest measured
    relative difference and the largest rate gap seen."""
    assert len(rec["dj"]) == len(rec["dt"])
    for a, b in zip(rec["dj"], rec["dt"]):
        assert a[0] == b[0]
        for x, y, name in zip(a[1:], b[1:], ("r_idx", "m_idx", "pol",
                                             "assign")):
            np.testing.assert_array_equal(y, x, err_msg=f"t={a[0]} {name}")
    assert len(rec["j"]) == len(rec["t"]) > 0
    gap, base = {}, {}
    worst = max_gap = 0.0
    for (ta, la, ma, da, aa), (tb, lb, mb, db, ab) in zip(rec["j"],
                                                          rec["t"]):
        assert ta == tb and da == db
        g = np.maximum(np.abs(lb / la - 1.0), np.abs(mb / ma - 1.0))
        gap[ta], base[ta] = g, RTOL[da]
        bar = RTOL[da] + GAP_FACTOR * g
        np.testing.assert_array_less(np.abs(ab - aa),
                                     bar * np.abs(aa) + 1e-300)
        live = aa > 0
        worst = max(worst, float(np.max(np.abs(ab[live] / aa[live] - 1))))
        max_gap = max(max_gap, float(g.max()))
    for a, b in zip(rj, rt):
        assert a.t == b.t
        np.testing.assert_allclose(b.q, a.q, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(b.accuracy, a.accuracy, rtol=1e-3)
        np.testing.assert_allclose(b.per_stream_predicted,
                                   a.per_stream_predicted, rtol=5e-3)
        np.testing.assert_allclose(b.predicted_aopi, a.predicted_aopi,
                                   rtol=5e-3)
        bar = base[a.t] + GAP_FACTOR * gap[a.t]
        if engine:
            # Measured is the engine rung (float64 host draws), its GI/G/1
            # rung the model column.
            np.testing.assert_array_less(
                np.abs(b.per_stream_model - a.per_stream_model),
                bar * np.abs(a.per_stream_model) + 1e-300)
            bar = RTOL[np.float64] + GAP_FACTOR * gap[a.t]
        np.testing.assert_array_less(
            np.abs(b.per_stream_measured - a.per_stream_measured),
            bar * np.abs(a.per_stream_measured) + 1e-300)
        assert b.fitted_model == a.fitted_model
        assert b.fitted_params == a.fitted_params
    for name in ("early_replans", "fallbacks", "degraded_epochs",
                 "telemetry_gaps", "fitted_models", "plan_failures"):
        assert getattr(st, name) == getattr(sj, name), name
    np.testing.assert_allclose(st._acc_scale, sj._acc_scale, rtol=1e-3)
    np.testing.assert_allclose(st._aopi_scale, sj._aopi_scale, rtol=1e-3)
    return worst, max_gap


CASES = {
    # scan planner, float64 windows (8 s epochs: 1,280 frames)
    "scan_mm1": dict(epoch_duration=8.0, plan_window=4),
    # the fitted selector and the telemetry EWMA
    "scan_auto_gain": dict(epoch_duration=8.0, plan_window=4,
                           delay_model="auto", telemetry_gain=0.3),
    # the step planner, float32 windows (4 s epochs: 640 frames)
    "step_f32": dict(epoch_duration=4.0, planner="step"),
    # divergence replanning cuts windows (gain 0.3, float32)
    "replan": dict(epoch_duration=4.0, plan_window=4, telemetry_gain=0.3,
                   replan_threshold=0.02),
    # a non-exponential world under gain 0
    "scan_gamma": dict(epoch_duration=8.0, plan_window=3,
                       delay_model="gamma"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_service_matches_reference(monkeypatch, case):
    sj, st, rj, rt, rec = _run_pair(monkeypatch, **CASES[case])
    worst, gap = _compare(sj, st, rj, rt, rec)
    print(f"{case}: max rel measured diff {worst:.3e}, max rate gap "
          f"{gap:.3e}")
    if case == "replan":
        assert st.early_replans, "no window was cut"
    if case == "scan_auto_gain":
        assert st.fitted_models[-1][1] == "mm1"
    if case == "step_f32":
        assert st.planner == "step"


TELEMETRY_AND_SOLVER = [
    ("telemetry_drop", dict(t0=1, duration=1)),
    ("telemetry_delay", dict(t0=2, duration=1, params={"delay": 1})),
    ("telemetry_corrupt", dict(t0=3, duration=1)),
    ("solver_nan", dict(t0=4, duration=2, params={"attempts": 64})),
]


def test_service_faults_match_reference(monkeypatch):
    """Telemetry drop, delay and corruption gate the EWMA; a
    retry-exhausting solver_nan at the second plan lands on the stale-plan
    rung."""
    sj, st, rj, rt, rec = _run_pair(
        monkeypatch, faults=TELEMETRY_AND_SOLVER, epoch_duration=8.0,
        plan_window=4, telemetry_gain=0.3)
    _compare(sj, st, rj, rt, rec)
    assert st.telemetry_gaps == [1, 2, 3]
    assert st.fallbacks == [(4, "stale_plan")]
    assert st.degraded_epochs == [4, 5]


def test_service_min_fallback_matches_reference(monkeypatch):
    """A retry-exhausting solver_timeout at the first plan: no good plan
    yet, so the ladder lands on the MIN rung (the plain solver)."""
    t_obs.reset()
    sj, st, rj, rt, rec = _run_pair(
        monkeypatch, n_epochs=4,
        faults=[("solver_timeout", dict(t0=0, duration=1,
                                        params={"attempts": 64}))],
        epoch_duration=8.0, plan_window=4, retry_backoff=0.0)
    _compare(sj, st, rj, rt, rec)
    assert st.fallbacks == [(0, "min_fallback")]
    assert len(st.plan_failures) == 3
    reg = t_obs.registry()
    assert reg.total("service.fallback.count") == 1
    assert reg.total("service.plan_retry.count") == 3
    assert reg.total("service.epochs") == 4


@pytest.mark.parametrize("fail_at", [0, 4])
def test_service_ladder_lets_kernel_errors_through(monkeypatch, fail_at):
    """A kernel that fails to build or launch (a RuntimeError out of the
    planner) is no planning fault: it propagates at once, with no retry,
    stale plan or MIN plan served in its place, before the first good plan
    and after it."""
    ctl = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM), v=10.0,
                                p_min=0.6, device="cpu")
    svc = t_service.AnalyticsService(ctl, epoch_duration=8.0,
                                     plan_window=4)
    inner = svc.plan_horizon
    calls = []

    def planner(k, t):
        calls.append(t)
        if t >= fail_at:
            raise RuntimeError("config_argmin launch failed: cudaError 209")
        return inner(k, t)

    monkeypatch.setattr(svc, "plan_horizon", planner)
    with pytest.raises(RuntimeError, match="launch failed"):
        svc.run(8)
    assert calls == list(range(0, fail_at + 1, 4))
    assert svc.plan_failures == [] and svc.fallbacks == []
    assert t_service.LADDER_FAULTS == (
        t_faults.InjectedSolverFault, TimeoutError, FloatingPointError)


@pytest.mark.parametrize("backend", ["des", "scan"])
def test_service_engine_mode_matches_reference(monkeypatch, backend):
    """The engine rung (the DES on the stub-model engine, or the tick
    scan) and the GI/G/1 rung of every epoch."""
    sj, st, rj, rt, rec = _run_pair(
        monkeypatch, n_epochs=3, mode="engine", engine_backend=backend,
        epoch_duration=2.0, plan_window=3, engine_frames_cap=64)
    assert st.engine_backend == backend
    _compare(sj, st, rj, rt, rec, engine=True)
    assert all(np.isfinite(r.model_aopi) for r in rt)


def test_service_measured_matches_closed_form():
    """The port's own run against Theorems 1-2 (the reference's bars)."""
    system = t_prof.EdgeSystem(n_cameras=8, n_servers=2, n_slots=10, seed=3)
    ctrl = t_lbcd.LBCDController(system, v=10.0, p_min=0.6, device="cpu")
    svc = t_service.AnalyticsService(ctrl, mode="mm1", epoch_duration=16.0,
                                     plan_window=3)
    reps = svc.run(3)
    for r in reps:
        assert r.measured_aopi == pytest.approx(r.predicted_aopi, rel=0.25)
    ratio = np.concatenate([r.per_stream_measured /
                            np.maximum(r.per_stream_predicted, 1e-9)
                            for r in reps])
    assert np.median(ratio) == pytest.approx(1.0, abs=0.15)


def test_service_options_and_refusals(monkeypatch):
    ctrl = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM), device="cpu")
    svc = t_service.AnalyticsService(ctrl, delay_model="auto")
    assert svc.true_delay_model == "mm1" and svc.planner == "scan"
    assert t_service.AnalyticsService(
        ctrl, delay_model="gamma").true_delay_model == "gamma"
    for bad in (dict(planner="loop"), dict(mode="des"),
                dict(delay_model="pareto"),
                dict(delay_model="auto", true_delay_model="auto")):
        with pytest.raises(ValueError):
            t_service.AnalyticsService(ctrl, **bad)
    custom = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM),
                                   assign_fn=lambda *a: np.zeros(6, np.int32),
                                   device="cpu")
    assert t_service.AnalyticsService(custom).planner == "step"
    assert t_service.MAX_BATCH_ELEMS == j_service.MAX_BATCH_ELEMS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_service.measure_mm1(np.ones(2), np.ones(2) * 3, np.ones(2) * 0.5,
                              np.zeros(2), epoch_duration=10.0)


def test_measure_window_chunks_along_epochs(monkeypatch):
    """Past MAX_BATCH_ELEMS the window is cut along epochs; the results
    do not depend on the cut (keys are per (t, i))."""
    rng = np.random.default_rng(1)
    lam = rng.uniform(3.0, 8.0, (4, 5))
    mu = rng.uniform(9.0, 14.0, (4, 5))
    p = rng.uniform(0.5, 0.9, (4, 5))
    pol = rng.integers(0, 2, (4, 5))
    kw = dict(epoch_duration=60.0, seed=2, t0=1, device="cpu")
    whole, tw = t_service.measure_window(lam, mu, p, pol, **kw)
    calls = []
    _record(monkeypatch, t_queues, calls)
    monkeypatch.setattr(t_service, "MAX_BATCH_ELEMS", 5 * 640)
    cut, tc = t_service.measure_window(lam, mu, p, pol, **kw)
    assert [c[0] for c in calls] == [1, 2, 3, 4]
    np.testing.assert_array_equal(cut, whole)
    for a, b in zip(tw, tc):
        np.testing.assert_array_equal(a.n_frames, b.n_frames)
