"""The AoPI-tracked analytics service: LBCD in the serving control plane
(the port of the JAX package's ``serving/service.py``).

Per controller epoch (the paper's 5-minute slot):
  1. the *planner* decides per stream the model, resolution, FCFS/LCFSP
     policy, server and bandwidth/compute shares by solving (P2);
  2. the data plane runs: frames arrive per the transmission model, are
     queued per policy and served at the allocated compute rate;
  3. measured AoPI and per-stream telemetry (accurate fraction, arrival
     and completion rates) feed the virtual queue and the next planning
     window's profiles.

Two planners:
  * ``planner="scan"`` (default): lookahead windows of ``plan_window``
    epochs are rolled in one call (``LBCDController.plan`` for LBCD, the
    baselines' ``_rollout``) over a ``profiles.HorizonTables`` window on
    the controller's device; the window's decisions move to the host once;
  * ``planner="step"``: the per-slot ``controller.step(t)`` path (custom
    ``assign_fn`` controllers, systems without a horizon).

Two data planes:
  * ``mode="mm1"``: the batched GI/G/1 window (``queues.gi_g1_window``),
    every stream of a plan window in one kernel launch on the card, under
    ``delay_model``'s delay family, against the *unscaled* scenario truth
    (raw accuracy table, true link efficiency) while the planner sees the
    telemetry-corrected beliefs. ``replan_threshold`` arms
    divergence-triggered replanning;
  * ``mode="engine"``: the engine rung, the real continuous-batching
    Engine event by event (``engine_backend="des"``) or its tick scan
    (``"scan"``, one kernel launch an epoch on the card), plus the GI/G/1
    rung of the same epoch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import faults as fault_plane
from .. import obs
from ..core import baselines, bcd, binpack, lbcd, queues
from ..core.lbcd import LBCDController
from ..core.profiles import HorizonTables
from ..device import DEFAULT_DEVICE, resolve_device
from .scheduler import StreamTelemetry


def _policy_label(controller) -> str:
    """Metric/span ``policy`` label for a controller (the sweep names
    where recognizable, the class name otherwise)."""
    names = {"LBCDController": "lbcd", "MINController": "min",
             "DOSController": "dos", "JCABController": "jcab"}
    cls = type(controller).__name__
    return names.get(cls, cls.lower())


def _map_plan(fn, plan: lbcd.RolloutResult) -> lbcd.RolloutResult:
    """``fn`` over every array of a rollout, its decision's included."""
    dec = bcd.SlotDecision(*(fn(x) for x in dataclasses.astuple(
        plan.decision)))
    return lbcd.RolloutResult(aopi=fn(plan.aopi), acc=fn(plan.acc),
                              q=fn(plan.q), assign=fn(plan.assign),
                              decision=dec)


def _to_host(plan: lbcd.RolloutResult) -> lbcd.RolloutResult:
    """A rollout's tensors as host numpy, one copy each."""
    return _map_plan(lambda x: x.cpu().numpy(), plan)


#: Element budget (epochs x streams x frames) of one data-plane window;
#: larger windows are cut along the epoch axis.
MAX_BATCH_ELEMS = 1 << 25

#: The planning failures the degradation ladder absorbs: a solver fault
#: (injected non-convergence or timeout), the watchdog deadline, a NaN
#: plan. The reference catches every exception there; the port lets any
#: other error through (a kernel that fails to build or launch on the card
#: must not be served by the plain MIN rung in its place).
LADDER_FAULTS = (fault_plane.InjectedSolverFault, TimeoutError,
                 FloatingPointError)


def measure_window(lam, mu, p, pol, *, epoch_duration: float = 300.0,
                   frames_cap: int = 200_000, frames_floor: int = 200,
                   seed: int = 0, t0: int = 0, delay_model: str = "mm1",
                   collect_samples: int = 0, device=DEFAULT_DEVICE
                   ) -> tuple[np.ndarray, list[StreamTelemetry]]:
    """Measure epochs ``[t0, t0+E)`` of an N-stream data plane as one
    ``queues.gi_g1_window`` on ``device`` (cut along the epoch axis only
    past ``MAX_BATCH_ELEMS``; the keys are per (t, i), so the cut changes
    nothing). ``lam``/``mu``/``p``/``pol`` are ``[E, N]``. Age is
    integrated up to ``epoch_duration``.

    Returns ``(measured_aopi[E, N], [StreamTelemetry] * E)``.
    """
    lam = np.atleast_2d(np.asarray(lam, np.float64))
    mu = np.atleast_2d(np.asarray(mu, np.float64))
    p = np.atleast_2d(np.asarray(p, np.float64))
    pol = np.atleast_2d(np.asarray(pol))
    n_epochs, n = lam.shape
    horizon = float(epoch_duration)
    n_frames = queues.frames_budget(max(lam.max(), 1e-6), horizon,
                                    frames_cap, frames_floor)
    e_chunk = max(int(MAX_BATCH_ELEMS // max(n * n_frames, 1)), 1)
    measured = np.zeros((n_epochs, n))
    tels: list[StreamTelemetry] = []
    for e0 in range(0, n_epochs, e_chunk):
        e1 = min(e0 + e_chunk, n_epochs)
        out = queues.gi_g1_window(
            lam[e0:e1], mu[e0:e1], p[e0:e1], pol[e0:e1],
            seed=seed, t0=t0 + e0, n_frames=n_frames, horizon=horizon,
            delay_model=delay_model, collect_samples=collect_samples,
            device=device)
        measured[e0:e1] = out["aopi"]
        samples = out.get("delay_samples")
        for j in range(e1 - e0):
            h_eff = np.maximum(out["horizon"][j], 1e-9)
            tels.append(StreamTelemetry(
                acc_hat=out["n_accurate"][j] /
                np.maximum(out["n_completed"][j], 1),
                lam_hat=out["n_frames"][j] / h_eff,
                mu_hat=out["n_completed"][j] / h_eff,
                n_frames=out["n_frames"][j].astype(np.float64),
                n_completed=out["n_completed"][j].astype(np.float64),
                aopi_hat=out["aopi"][j].copy(),
                delay_samples=(None if samples is None
                               else samples[j])))
    return measured, tels


def measure_mm1(lam, mu, p, pol, *, epoch_duration: float = 300.0,
                frames_cap: int = 200_000, frames_floor: int = 200,
                seed: int = 0, t: int = 0, delay_model: str = "mm1",
                device=DEFAULT_DEVICE) -> tuple[np.ndarray, StreamTelemetry]:
    """One epoch of the data plane for N streams (:func:`measure_window`
    at E = 1). Returns ``(measured_aopi[N], StreamTelemetry)``."""
    lam = np.asarray(lam, np.float64)
    measured, tels = measure_window(
        lam[None], np.asarray(mu, np.float64)[None],
        np.asarray(p, np.float64)[None], np.asarray(pol)[None],
        epoch_duration=epoch_duration, frames_cap=frames_cap,
        frames_floor=frames_floor, seed=seed, t0=t,
        delay_model=delay_model, device=device)
    return measured[0], tels[0]


def measure_mm1_loop(lam, mu, p, pol, *, epoch_duration: float = 300.0,
                     frames_cap: int = 200_000, frames_floor: int = 200,
                     seed: int = 0, t: int = 0, delay_model: str = "mm1"
                     ) -> tuple[np.ndarray, StreamTelemetry]:
    """The per-stream numpy loop over the oracle (host only), seeded with
    ``SeedSequence(entropy=seed, spawn_key=(t, i))``; it integrates age
    over the *simulated* horizon, not the truncated epoch."""
    lam = np.asarray(lam, np.float64)
    mu = np.asarray(mu, np.float64)
    p = np.asarray(p, np.float64)
    pol = np.asarray(pol)
    n = len(lam)
    measured = np.zeros(n)
    tel = StreamTelemetry.empty(n)
    for i in range(n):
        lam_i = max(float(lam[i]), 1e-6)
        mu_i = max(float(mu[i]), 1e-6)
        n_frames = int(min(lam_i * epoch_duration, frames_cap))
        n_frames = max(n_frames, frames_floor)
        samplers = queues.oracle_samplers(delay_model, lam_i, mu_i)
        sim = queues.simulate(
            lam_i, mu_i, float(np.clip(p[i], 1e-3, 1.0)),
            int(pol[i]), n_frames=n_frames,
            seed=queues.stream_seed_sequence(seed, t, i), **samplers)
        measured[i] = sim.mean_aopi
        horizon = max(sim.horizon, 1e-9)
        tel.acc_hat[i] = sim.n_accurate / max(sim.n_completed, 1)
        tel.lam_hat[i] = sim.n_frames / horizon
        tel.mu_hat[i] = sim.n_completed / horizon
        tel.n_frames[i] = sim.n_frames
        tel.n_completed[i] = sim.n_completed
        tel.aopi_hat[i] = sim.mean_aopi
    return measured, tel


@dataclasses.dataclass
class EpochReport:
    t: int
    predicted_aopi: float       # closed-form, from the planner
    measured_aopi: float        # data-plane measurement
    accuracy: float
    q: float
    per_stream_measured: np.ndarray
    per_stream_predicted: np.ndarray
    telemetry: Optional[StreamTelemetry] = None
    #: Engine mode only: the GI/G/1 rung of the same epoch (measured_aopi
    #: is then the engine rung's).
    model_aopi: Optional[float] = None
    per_stream_model: Optional[np.ndarray] = None
    #: Family the fitted selector chose for this epoch (delay_model="auto").
    fitted_model: Optional[str] = None
    #: Its fitted shape parameters (sigma/k), when the winner has any.
    fitted_params: Optional[dict] = None


class AnalyticsService:
    def __init__(self, controller, *, mode: str = "mm1",
                 epoch_duration: float = 300.0, engine=None,
                 frames_cap: int = 200_000, seed: int = 0,
                 planner: str = "scan", plan_window: int = 8,
                 tables: HorizonTables | None = None,
                 telemetry_gain: float = 0.0,
                 delay_model: str = "mm1",
                 true_delay_model: str | None = None,
                 engine_frames_cap: int | None = None,
                 engine_backend: str = "auto",
                 replan_threshold: float | None = None,
                 faults: "fault_plane.FaultPlan | None" = None,
                 plan_retries: int = 2,
                 retry_backoff: float = 0.0,
                 plan_deadline: float | None = None):
        """``controller`` is an ``LBCDController`` or a ``baselines``
        controller (``step(t)`` and ``plan(tables)`` or ``_rollout(tables)``).

        ``tables`` replays a prebuilt horizon instead of the controller's
        ``EdgeSystem``; ``telemetry_gain`` > 0 lets measured accuracy,
        arrival rates and AoPI correct the next window's beliefs (EWMA
        weight). ``delay_model`` is the data plane's family
        (``queues.DELAY_MODELS``) or ``"auto"``: fit the family from the
        observed transmission delays each epoch. ``true_delay_model`` pins
        the generating family (default: ``delay_model``, or "mm1" under
        "auto"). ``replan_threshold`` (relative divergence) cuts the plan
        window early. ``engine_backend`` picks the engine rung's plane in
        ``mode="engine"`` (``tick_plane.ENGINE_BACKENDS``);
        ``engine_frames_cap`` defaults to ``ENGINE_FRAMES_CAP`` on the DES
        and to ``frames_cap`` on the scan. ``faults`` arms the telemetry
        and solver injections and the degradation ladder (``plan_retries``
        retries with ``retry_backoff``, a ``plan_deadline`` watchdog, the
        last good plan, a MIN plan); ``faults=None`` changes nothing.
        The data plane runs on the controller's device.
        """
        if planner not in ("scan", "step"):
            raise ValueError(f"unknown planner {planner!r}; "
                             "known: ('scan', 'step')")
        if mode not in ("mm1", "engine"):
            raise ValueError(f"unknown mode {mode!r}; "
                             "known: ('mm1', 'engine')")
        queues.validate_delay_model(delay_model, allow_auto=True)
        if true_delay_model is None:
            true_delay_model = (delay_model
                                if delay_model != queues.AUTO_DELAY_MODEL
                                else "mm1")
        queues.validate_delay_model(true_delay_model)
        # Scan planning needs a whole-horizon rollout on the controller AND
        # a horizon source (replay tables, or a system with ``horizon``).
        if planner == "scan" and not (
                self._supports_scan(controller) and
                (tables is not None or
                 hasattr(controller.system, "horizon"))):
            planner = "step"
        self.controller = controller
        self.device = resolve_device(getattr(controller, "device",
                                             DEFAULT_DEVICE))
        self.mode = mode
        self.engine = engine
        self.epoch_duration = epoch_duration
        self.frames_cap = frames_cap
        self.seed = seed
        self.planner = planner
        self.plan_window = max(int(plan_window), 1)
        self.tables = tables
        self.telemetry_gain = float(telemetry_gain)
        self.delay_model = delay_model
        self.true_delay_model = true_delay_model
        self._auto = delay_model == queues.AUTO_DELAY_MODEL
        self._fitted_model: str | None = None
        self._fitted_params: dict = {}       # winner's shape, e.g. sigma/k
        self.fitted_models: list[tuple[int, str]] = []  # (t, fitted family)
        self._delay_buf: list[np.ndarray] = []  # unit-mean pooled samples
        self.replan_threshold = (None if replan_threshold is None
                                 else float(replan_threshold))
        self.reports: list = []
        # The list attributes and the obs series are written by the same
        # statements, so they reconcile exactly.
        self.divergences: list[float] = []   # per-epoch measured/pred - 1
        self.early_replans: list[int] = []   # epochs where a window was cut
        self.fallbacks: list[tuple[int, str]] = []   # (t, ladder rung)
        self.degraded_epochs: list[int] = []  # epochs run on a fallback plan
        self.telemetry_gaps: list[int] = []   # epochs whose telemetry held
        self.plan_failures: list[tuple[int, int, str]] = []  # (t, attempt, err)
        self.faults = faults
        self.plan_retries = max(int(plan_retries), 0)
        self.retry_backoff = float(retry_backoff)
        self.plan_deadline = (None if plan_deadline is None
                              else float(plan_deadline))
        self._policy = _policy_label(controller)
        self._replan_pending = False         # next plan is an early replan
        self._plan_degraded: str | None = None  # ladder rung of current plan
        self._last_plan = None               # last validated plan (stale src)
        self._gap_streak = 0                 # consecutive telemetry gaps
        self._delayed_tel: dict = {}         # arrival epoch -> [(dec, tel)]
        n = self._n_streams()
        self._acc_scale = np.ones(n)
        self._eff_scale = np.ones(n)
        self._aopi_scale = np.ones(n)        # measured/closed-form residual
        self._base_cache: HorizonTables | None = tables
        self._plan = None
        self._plan_t0 = 0
        self._plan_meas = None               # window-batched measurements
        from . import engine_plane, tick_plane
        # Resolve "auto" against the DES-sized budget, then default the
        # cap per backend.
        des_cap = int(engine_plane.ENGINE_FRAMES_CAP
                      if engine_frames_cap is None else engine_frames_cap)
        self.engine_backend = tick_plane.resolve_engine_backend(
            engine_backend, n_streams=n, frames_cap=des_cap)
        if engine_frames_cap is None and self.engine_backend == "scan":
            self.engine_frames_cap = int(frames_cap)
        else:
            self.engine_frames_cap = des_cap
        if (self.mode == "engine" and self.engine is None
                and self.engine_backend == "des"):
            # The deterministic stub-model engine, one lane per stream.
            from .engine import make_replay_engine
            self.engine = make_replay_engine(n, seed=seed,
                                             device=self.device)

    # ------------------------------------------------------------------
    # Planner
    # ------------------------------------------------------------------
    @staticmethod
    def _supports_scan(controller) -> bool:
        if isinstance(controller, LBCDController):
            # The rollout is specialized to first-fit placement.
            return controller.assign_fn is binpack.first_fit
        # A _rollout *override*: the abstract one raises.
        rollout = getattr(type(controller), "_rollout", None)
        return (rollout is not None and
                rollout is not baselines.BaselineController._rollout)

    def _n_streams(self) -> int:
        if self.tables is not None:
            return self.tables.n_cameras
        return self.controller.system.n_cameras

    def _base_window(self, t0: int, t1: int) -> HorizonTables:
        """Slots [t0, t1) of the *uncorrected* source horizon (the truth
        the data plane executes against)."""
        if self._base_cache is None or self._base_cache.n_slots < t1:
            # The horizon is prefix-stable in n_slots: grow the cache
            # geometrically; a bounded system rejects the over-request,
            # so retry with exactly what is needed.
            cur = 0 if self._base_cache is None else self._base_cache.n_slots
            system = self.controller.system
            try:
                self._base_cache = system.horizon(max(t1, 2 * cur),
                                                  device=self.device)
            except ValueError:
                self._base_cache = system.horizon(t1, device=self.device)
        return self._base_cache.window(t0, t1)

    def _window_tables(self, t0: int, t1: int) -> HorizonTables:
        """The planner's view: the source horizon with the telemetry
        corrections (accuracy / link-efficiency scales) applied."""
        base = self._base_window(t0, t1)
        if self.telemetry_gain <= 0.0:
            return base

        def scale(x):
            return torch.from_numpy(x).to(base.acc.device, base.acc.dtype)

        acc = torch.clamp(base.acc * scale(self._acc_scale)[None, :, None,
                                                            None],
                          1e-3, 1.0)
        eff = scale(self._eff_scale)
        if base.eff.ndim != 1:
            eff = eff[None, :]
        return dataclasses.replace(base, acc=acc, eff=base.eff * eff)

    def plan_horizon(self, k: int, t0: int = 0) -> lbcd.RolloutResult:
        """Plan epochs ``[t0, t0 + k)`` as one rollout over the
        (telemetry-corrected) horizon window. Pure lookahead: neither the
        controller's queue nor the data plane advances."""
        tables = self._window_tables(t0, t0 + k)
        ctrl = self.controller
        if isinstance(ctrl, LBCDController):
            return ctrl.plan(tables)
        return ctrl._rollout(tables)

    def _slot_record(self, t: int) -> lbcd.SlotRecord:
        if self.planner != "scan":
            with obs.span("service.plan_window", policy=self._policy,
                          reason="boundary", t0=t, k=1):
                return self.controller.step(t)
        if self._plan is None or not (
                self._plan_t0 <= t < self._plan_t0 + self._plan.q.shape[0]):
            k = self.plan_window
            if self.tables is not None:
                k = min(k, self.tables.n_slots - t)
            if k < 1:
                raise ValueError(
                    f"epoch {t} is past the replayed horizon of "
                    f"{self.tables.n_slots} slots")
            # The span covers the rollout AND its copy to the host (which
            # waits for the card): the end-to-end planning latency.
            reason = "early" if self._replan_pending else "boundary"
            self._replan_pending = False
            with obs.span("service.plan_window", policy=self._policy,
                          reason=reason, t0=t, k=k):
                self._plan = self._plan_with_ladder(t, k)
            self._plan_t0 = t
            self._plan_meas = None           # re-measure the new window
        j = t - self._plan_t0
        res = self._plan
        q = float(res.q[j])
        if isinstance(self.controller, LBCDController):
            self.controller.queue.q = q      # commit Eq. 44 for this epoch
        return lbcd.SlotRecord(
            t=t, aopi=res.aopi[j], acc=res.acc[j], q=q,
            assign=res.assign[j],
            decision=bcd.SlotDecision(*(x[j] for x in dataclasses.astuple(
                res.decision))))

    # ------------------------------------------------------------------
    # Graceful-degradation ladder (scan planner)
    # ------------------------------------------------------------------
    def _plan_attempt(self, t: int, k: int, attempt: int):
        """One planning attempt: the fault plan's solver injection, the
        scan planner under the watchdog deadline, and validation (NaN
        anywhere in the plan is a failure)."""
        kind = (None if self.faults is None
                else self.faults.solver_fault(t, attempt))
        if kind == "solver_nonconverge":
            raise fault_plane.InjectedSolverFault("solver_nonconverge")
        start = time.perf_counter()
        plan = _to_host(self.plan_horizon(k, t))
        elapsed = time.perf_counter() - start
        if kind == "solver_nan":
            plan = dataclasses.replace(
                plan, aopi=np.full_like(np.asarray(plan.aopi, float),
                                        np.nan))
        if kind == "solver_timeout":
            raise fault_plane.InjectedSolverFault("solver_timeout")
        if self.plan_deadline is not None and elapsed > self.plan_deadline:
            raise TimeoutError(
                f"plan window at t={t} took {elapsed:.3f}s "
                f"(deadline {self.plan_deadline:.3f}s)")
        for name in ("aopi", "q"):
            if np.isnan(np.asarray(getattr(plan, name), float)).any():
                raise FloatingPointError(f"plan.{name} contains NaN")
        for name in ("b", "c"):
            if np.isnan(np.asarray(getattr(plan.decision, name),
                                   float)).any():
                raise FloatingPointError(
                    f"plan.decision.{name} contains NaN")
        return plan

    def _plan_with_ladder(self, t: int, k: int):
        """Plan with retries, then degrade: (1) up to ``plan_retries``
        retries with exponential ``retry_backoff``; (2) the last good
        plan's final slot tiled over the window and re-projected onto the
        surviving fleet; (3) a MIN plan (plain solver) on the current
        window. Each failure and fallback appends to its list and emits
        its obs event in the same block. Only ``LADDER_FAULTS`` engage the
        ladder: any other error (a kernel that fails to build or launch)
        propagates, so no plan is ever served by the plain solver in its
        place."""
        for attempt in range(self.plan_retries + 1):
            try:
                plan = self._plan_attempt(t, k, attempt)
                self._plan_degraded = None
                self._last_plan = plan
                return plan
            except LADDER_FAULTS as e:
                err = f"{type(e).__name__}: {e}"
                self.plan_failures.append((t, attempt, err))
                obs.event("service.plan_retry", policy=self._policy,
                          t=t, attempt=attempt, error=err)
                if self.retry_backoff > 0.0 and attempt < self.plan_retries:
                    time.sleep(self.retry_backoff * (2.0 ** attempt))
        plan = self._stale_plan(t, k)
        reason = "stale_plan"
        if plan is None:
            plan = _to_host(baselines.rollout_min(
                self._window_tables(t, t + k), solver_backend="torch",
                device=self.device))
            reason = "min_fallback"
        self.fallbacks.append((t, reason))
        obs.event("service.fallback", policy=self._policy, t=t,
                  reason=reason)
        self._plan_degraded = reason
        return plan

    def _stale_plan(self, t: int, k: int):
        """Rung 2: the last good plan's final slot over ``[t, t+k)``, every
        per-camera quantity of cameras that have since churned out zeroed.
        ``None`` when no good plan exists yet."""
        if self._last_plan is None:
            return None
        res = _map_plan(lambda x: np.repeat(np.asarray(x)[-1:], k, axis=0),
                        self._last_plan)
        act = self._active_window(t, t + k)
        if act is not None:
            d = res.decision
            d = dataclasses.replace(
                d, b=d.b * act, c=d.c * act, lam=d.lam * act,
                mu=d.mu * act, acc=d.acc * act, aopi=d.aopi * act)
            res = dataclasses.replace(
                res, aopi=res.aopi * act, acc=res.acc * act, decision=d)
        return res

    def _active_window(self, t0: int, t1: int):
        """``[t1-t0, N]`` host fleet mask of the replayed horizon, or
        ``None`` when no churn mask is attached."""
        if self.tables is None or self.tables.active is None:
            return None
        return self.tables.active[t0:t1].cpu().numpy().astype(np.float64)

    def _active_at(self, t: int):
        act = self._active_window(t, t + 1)
        return None if act is None else act[0]

    # ------------------------------------------------------------------
    # Data plane
    # ------------------------------------------------------------------
    #: Per-stream delay samples surfaced per epoch / pooled for the fit.
    SAMPLE_CAP = 64
    SAMPLE_POOL = 8192

    def _obs_model(self) -> str:
        """The ``delay_model`` obs label: under "auto" the *fitted*
        family (or the sentinel until enough samples)."""
        if self._auto:
            return self._fitted_model or queues.AUTO_DELAY_MODEL
        return self.delay_model

    def _measure_model(self) -> str:
        """Family of the GI/G/1 rung in engine mode: the fitted one when
        the selector is armed."""
        if self._auto:
            return self._fitted_model or "mm1"
        return self.delay_model

    def _update_fit(self, t: int, tel: StreamTelemetry | None):
        """Fold this epoch's delay samples (per-stream mean-normalized)
        into the pooled buffer and re-fit the family."""
        if not self._auto or tel is None or tel.delay_samples is None:
            return
        for row in np.asarray(tel.delay_samples, np.float64):
            row = row[row > 0.0]
            if row.size >= 4:
                self._delay_buf.append(row / row.mean())
        while (sum(a.size for a in self._delay_buf) > self.SAMPLE_POOL
               and len(self._delay_buf) > 1):
            self._delay_buf.pop(0)
        pooled = (np.concatenate(self._delay_buf) if self._delay_buf
                  else np.empty(0))
        fit = queues.fit_delay_model(pooled)
        if fit.residuals:                 # enough samples to trust
            changed = (fit.model != self._fitted_model
                       or dict(fit.params) != self._fitted_params)
            self._fitted_model = fit.model
            self._fitted_params = dict(fit.params)
            if changed:
                # Seed the AoPI residual scale halfway toward the fitted
                # family's Kingman prior (exactly 1 for mm1).
                prior = queues.residual_prior(fit.model, fit.params)
                self._aopi_scale = np.clip(
                    0.5 * (self._aopi_scale + prior), 0.25, 4.0)
        self.fitted_models.append((t, self._fitted_model or "mm1"))
        obs.event("service.delay_fit", policy=self._policy, t=t,
                  model=self._fitted_model or "unfit",
                  n_samples=fit.n_samples,
                  **{k: float(v) for k, v in fit.params.items()})

    def _plane_rates(self, t: int, dec) -> tuple[np.ndarray, np.ndarray]:
        """True arrival rate and accuracy of the chosen configs, from the
        *uncorrected* tables (the plane executes against the world)."""
        n = len(dec.lam)
        r_idx = np.asarray(dec.r_idx)
        m_idx = np.asarray(dec.m_idx)
        try:
            base = self._base_window(t, t + 1)
        except AttributeError:
            # No horizon source: the planner's own beliefs. A ValueError
            # (epoch past a bounded horizon) propagates.
            return np.asarray(dec.lam), np.asarray(dec.acc)
        eff = (base.eff if base.eff.ndim == 1 else base.eff[0]).cpu().numpy()
        size = base.size.cpu().numpy()
        lam_true = np.asarray(dec.b) * eff / size[r_idx]
        p_true = base.acc[0].cpu().numpy()[np.arange(n), m_idx, r_idx]
        return lam_true, p_true

    def _plane_rates_window(self, t0: int, n_epochs: int,
                            dec) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`_plane_rates` for a whole plan window (``[E, N]``
        decision arrays)."""
        n = dec.lam.shape[-1]
        r_idx = np.asarray(dec.r_idx)
        m_idx = np.asarray(dec.m_idx)
        try:
            base = self._base_window(t0, t0 + n_epochs)
        except AttributeError:
            return np.asarray(dec.lam), np.asarray(dec.acc)
        eff = base.eff.cpu().numpy()
        if eff.ndim == 1:
            eff = np.broadcast_to(eff, (n_epochs, n))
        size = base.size.cpu().numpy()
        lam_true = np.asarray(dec.b) * eff / size[r_idx]
        acc = base.acc.cpu().numpy()                     # [E, N, M, R]
        p_true = acc[np.arange(n_epochs)[:, None],
                     np.arange(n)[None, :], m_idx, r_idx]
        return lam_true, p_true

    def _measure_plan_window(self):
        """Measure every epoch of the current plan window as one window:
        its inputs are known the moment the window is planned."""
        res, t0 = self._plan, self._plan_t0
        n_epochs = int(res.q.shape[0])
        dec = res.decision
        lam_true, p_true = self._plane_rates_window(t0, n_epochs, dec)
        with obs.span("service.measure_window", policy=self._policy,
                      delay_model=self._obs_model(), t0=t0,
                      epochs=n_epochs, streams=int(lam_true.shape[-1])):
            return measure_window(
                lam_true, np.asarray(dec.mu), p_true, np.asarray(dec.pol),
                epoch_duration=self.epoch_duration,
                frames_cap=self.frames_cap, seed=self.seed, t0=t0,
                delay_model=self.true_delay_model,
                collect_samples=self.SAMPLE_CAP if self._auto else 0,
                device=self.device)

    def _measure_epoch(self, t: int, dec):
        """Measured AoPI + telemetry for epoch ``t``: on the scan path the
        whole plan window is measured at once and cached; the step path,
        and armed divergence replanning (which may discard the rest of the
        window), measure one epoch."""
        if (self.planner == "scan" and self._plan is not None
                and self.replan_threshold is None):
            if self._plan_meas is None:
                self._plan_meas = self._measure_plan_window()
            measured_w, tels = self._plan_meas
            j = t - self._plan_t0
            return measured_w[j], tels[j]
        lam_true, p_true = self._plane_rates(t, dec)
        with obs.span("service.measure_window", policy=self._policy,
                      delay_model=self._obs_model(), t0=t, epochs=1,
                      streams=int(np.asarray(lam_true).shape[-1])):
            measured, tels = measure_window(
                lam_true[None], np.asarray(dec.mu)[None], p_true[None],
                np.asarray(dec.pol)[None],
                epoch_duration=self.epoch_duration,
                frames_cap=self.frames_cap, seed=self.seed, t0=t,
                delay_model=self.true_delay_model,
                collect_samples=self.SAMPLE_CAP if self._auto else 0,
                device=self.device)
            return measured[0], tels[0]

    def _ingest_telemetry(self, t: int, dec, tel: StreamTelemetry):
        """Gate the epoch's measurement through the fault plan before the
        EWMA: drops and corruption become telemetry gaps (the scales hold),
        delayed samples are folded in on arrival."""
        for d_dec, d_tel in self._delayed_tel.pop(t, ()):
            self._apply_telemetry(t, d_dec, d_tel)
        spec = (None if self.faults is None
                else self.faults.telemetry_fault(t))
        if spec is not None:
            if spec.kind == "telemetry_drop":
                self._telemetry_gap(t, "drop")
                return
            if spec.kind == "telemetry_delay":
                d = max(int(spec.params.get("delay", 1)), 1)
                self._delayed_tel.setdefault(t + d, []).append((dec, tel))
                self._telemetry_gap(t, "delay")
                return
            if spec.kind == "telemetry_corrupt":
                tel = dataclasses.replace(
                    tel, acc_hat=np.full_like(
                        np.asarray(tel.acc_hat, np.float64), np.nan))
        self._apply_telemetry(t, dec, tel)

    def _apply_telemetry(self, t: int, dec, tel: StreamTelemetry):
        """Validated EWMA ingest: a non-finite measurement is a gap."""
        finite = all(
            np.isfinite(np.asarray(x, np.float64)).all()
            for x in (tel.acc_hat, tel.lam_hat, tel.mu_hat, tel.aopi_hat))
        if not finite:
            self._telemetry_gap(t, "corrupt")
            return
        self._update_telemetry(dec, tel)
        self._gap_streak = 0

    def _telemetry_gap(self, t: int, why: str):
        self.telemetry_gaps.append(t)
        self._gap_streak += 1
        obs.event("service.telemetry_gap", policy=self._policy, t=t,
                  reason=why)

    def _update_telemetry(self, dec, tel: StreamTelemetry):
        """EWMA of the belief scales toward measured/believed (clipped to
        [0.5, 2]) and of the AoPI residual scale toward measured/closed
        form (clipped to [0.25, 4])."""
        g = self.telemetry_gain
        if g <= 0.0:
            return
        seen = tel.n_completed > 0
        ratio_acc = np.where(
            seen, tel.acc_hat / np.maximum(np.asarray(dec.acc), 1e-3), 1.0)
        ratio_lam = np.where(
            tel.n_frames > 0,
            tel.lam_hat / np.maximum(np.asarray(dec.lam), 1e-9), 1.0)
        # Residual of the *calibrated* prediction.
        pred = self._aopi_scale * np.asarray(dec.aopi)
        ratio_aopi = np.where(
            (tel.aopi_hat > 0) & np.isfinite(pred) & (pred > 0),
            tel.aopi_hat / np.maximum(pred, 1e-9), 1.0)
        self._acc_scale = np.clip(
            (1 - g) * self._acc_scale + g * self._acc_scale * ratio_acc,
            0.5, 2.0)
        self._eff_scale = np.clip(
            (1 - g) * self._eff_scale + g * self._eff_scale * ratio_lam,
            0.5, 2.0)
        self._aopi_scale = np.clip(
            (1 - g) * self._aopi_scale + g * self._aopi_scale * ratio_aopi,
            0.25, 4.0)

    def run_epoch(self, t: int) -> EpochReport:
        with obs.span("service.run_epoch", policy=self._policy, t=t):
            return self._run_epoch(t)

    def _run_epoch(self, t: int) -> EpochReport:
        rec = self._slot_record(t)
        dec = rec.decision
        if self._plan_degraded is not None and self.planner == "scan":
            self.degraded_epochs.append(t)
            obs.event("service.degraded_epoch", policy=self._policy,
                      t=t, reason=self._plan_degraded)
        # The calibrated prediction, taken BEFORE this epoch's telemetry
        # folds in: the divergence is out of sample.
        predicted = self._aopi_scale * np.asarray(dec.aopi)
        model_meas = None
        if self.mode == "mm1":
            measured, tel = self._measure_epoch(t, dec)
            self._ingest_telemetry(t, dec, tel)
            self._update_fit(t, tel)
        else:
            measured, tel = self._run_engine_epoch(rec)
            self._ingest_telemetry(t, dec, tel)
            self._update_fit(t, tel)
            model_meas = self._measure_model_rung(t, dec)
        act = self._active_at(t)
        if act is None:
            pred_mean = float(np.mean(predicted))
            meas_mean = float(np.mean(measured))
            acc_mean = float(np.mean(dec.acc))
            model_mean = (None if model_meas is None
                          else float(np.mean(model_meas)))
        else:
            # Fleet means over the surviving cameras only.
            n_live = max(float(act.sum()), 1.0)
            pred_mean = float(np.sum(predicted * act) / n_live)
            meas_mean = float(np.sum(measured * act) / n_live)
            acc_mean = float(np.sum(np.asarray(dec.acc) * act) / n_live)
            model_mean = (None if model_meas is None else float(
                np.sum(model_meas * act) / n_live))
        rep = EpochReport(
            t=t, predicted_aopi=pred_mean,
            measured_aopi=meas_mean,
            accuracy=acc_mean, q=rec.q,
            per_stream_measured=measured,
            per_stream_predicted=predicted,
            telemetry=tel,
            model_aopi=model_mean,
            per_stream_model=model_meas,
            fitted_model=self._fitted_model if self._auto else None,
            fitted_params=(dict(self._fitted_params)
                           if self._auto and self._fitted_params else None))
        self.reports.append(rep)
        div = rep.measured_aopi / max(rep.predicted_aopi, 1e-12) - 1.0
        self.divergences.append(div)
        obs.gauge("service.divergence", policy=self._policy).set(div)
        obs.histogram("service.divergence.abs",
                      policy=self._policy).observe(abs(div))
        obs.counter("service.epochs", policy=self._policy).inc()
        self._maybe_replan(t, div)
        return rep

    def _effective_replan_threshold(self) -> float | None:
        """Consecutive telemetry gaps widen the threshold by 50% each."""
        if self.replan_threshold is None:
            return None
        return self.replan_threshold * (1.0 + 0.5 * self._gap_streak)

    def _maybe_replan(self, t: int, div: float):
        """Cut the rest of the plan window when the plane drifted past the
        threshold, so the planner re-runs at ``t + 1``."""
        threshold = self._effective_replan_threshold()
        if (threshold is None or self.mode != "mm1"
                or self.planner != "scan" or self._plan is None
                or abs(div) <= threshold):
            return
        remaining = self._plan_t0 + int(self._plan.q.shape[0]) - (t + 1)
        if remaining > 0:
            self._plan = None
            self._plan_meas = None
            self.early_replans.append(t + 1)
            self._replan_pending = True
            obs.event("service.early_replan", policy=self._policy,
                      t=t + 1, divergence=float(div))

    # ------------------------------------------------------------------
    def _run_engine_epoch(self, rec
                          ) -> tuple[np.ndarray, StreamTelemetry]:
        """The engine rung at the *unscaled* truth rates: the DES on the
        real Engine, or the tick scan on the service's device."""
        from . import engine_plane, tick_plane
        dec = rec.decision
        t = rec.t
        lam_true, p_true = self._plane_rates(t, dec)
        act = self._active_at(t)
        max_lam = float(np.max(lam_true)) if np.size(lam_true) else 1.0
        if not np.isfinite(max_lam):
            max_lam = 1.0
        frames = queues.frames_budget(max_lam, self.epoch_duration,
                                      self.engine_frames_cap)
        kw = dict(epoch_duration=self.epoch_duration, seed=self.seed,
                  t=t, delay_model=self.true_delay_model, active=act,
                  frames_cap=frames,
                  collect_samples=self.SAMPLE_CAP if self._auto else 0)
        with obs.span("service.measure_engine", policy=self._policy,
                      delay_model=self._obs_model(), t0=t,
                      backend=self.engine_backend,
                      streams=int(np.asarray(lam_true).shape[-1])):
            if self.engine_backend == "scan":
                out = tick_plane.measure_engine_epoch_scan(
                    lam_true, np.asarray(dec.mu), p_true,
                    np.asarray(dec.pol), device=self.device, **kw)
            else:
                assert self.engine is not None
                out = engine_plane.measure_engine_epoch(
                    self.engine, lam_true, np.asarray(dec.mu), p_true,
                    np.asarray(dec.pol), **kw)
        h_eff = np.maximum(out["horizon"], 1e-9)
        tel = StreamTelemetry(
            acc_hat=out["n_accurate"] / np.maximum(out["n_completed"], 1),
            lam_hat=out["n_frames"] / h_eff,
            mu_hat=out["n_completed"] / h_eff,
            n_frames=out["n_frames"].astype(np.float64),
            n_completed=out["n_completed"].astype(np.float64),
            aopi_hat=out["aopi"].copy(),
            delay_samples=out.get("delay_samples"))
        return out["aopi"], tel

    def _measure_model_rung(self, t: int, dec) -> np.ndarray:
        """The GI/G/1 rung in engine mode, at the same truth rates, under
        the measurement family."""
        lam_true, p_true = self._plane_rates(t, dec)
        with obs.span("service.measure_window", policy=self._policy,
                      delay_model=self._obs_model(), t0=t, epochs=1,
                      streams=int(np.asarray(lam_true).shape[-1])):
            measured, _ = measure_mm1(
                lam_true, np.asarray(dec.mu), p_true, np.asarray(dec.pol),
                epoch_duration=self.epoch_duration,
                frames_cap=self.frames_cap, seed=self.seed, t=t,
                delay_model=self._measure_model(), device=self.device)
        return measured

    def run(self, n_epochs: int):
        return [self.run_epoch(t) for t in range(n_epochs)]

    @property
    def mean_measured(self) -> float:
        return float(np.mean([r.measured_aopi for r in self.reports]))

    @property
    def mean_predicted(self) -> float:
        return float(np.mean([r.predicted_aopi for r in self.reports]))
