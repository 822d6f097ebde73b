"""Data-plane scenario replay: measured AoPI for every scenario family (the
port of the JAX package's ``serving/replay.py``).

``scenarios.sweep`` scores policies with the Theorem 1/2 closed forms.
This module replays a scenario's ``HorizonTables`` through
``AnalyticsService`` so every (policy, scenario) pair also yields
*measured* per-epoch AoPI next to the closed-form prediction:

  * :class:`TableSystem`: an ``EdgeSystem`` facade over prebuilt
    ``HorizonTables``, so the controllers and the service's scan planner
    consume scenario data;
  * :func:`replay_tables`: one (policy, scenario) replay, the planner the
    policy's rollout over whole windows, the data plane one
    ``service.measure_window`` per plan window (or, with
    ``mode="engine"``, the engine rung as well);
  * :func:`replay_suite`: the stacked suite -> :class:`ReplayResult` with
    ``[K, T]`` predicted and measured fleet-mean AoPI per policy.

``scenarios.sweep(..., dataplane=True)`` calls :func:`replay_suite`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .. import faults as fault_plane
from .. import obs
from ..core import baselines, profiles
from ..core.lbcd import LBCDController
from ..core.profiles import HorizonTables
from ..device import DEFAULT_DEVICE, resolve_device
# The policy roster and the divergence definition are the sweep runner's
# (which imports this module only inside sweep(), so this is acyclic).
from ..scenarios.runner import POLICIES, divergence_series
from .service import AnalyticsService


class TableSystem:
    """``EdgeSystem`` facade over one scenario's prebuilt ``HorizonTables``:
    ``capacities(t)`` / ``tables(t)`` for the per-slot path and
    ``horizon(n)`` for the rollouts."""

    def __init__(self, tables: HorizonTables):
        if tables.acc.ndim != 4:
            raise ValueError(
                f"TableSystem wraps ONE scenario's horizon (acc rank 4, "
                f"[T, N, M, R]); got acc{tuple(tables.acc.shape)}. Index "
                f"a stacked suite first (scenarios.runner.scenario)")
        self._tables = tables
        self.n_cameras = tables.n_cameras
        self.n_servers = tables.n_servers
        self.n_slots = tables.n_slots

    def capacities(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        t = t % self.n_slots
        return (self._tables.budgets_b[t].cpu().numpy(),
                self._tables.budgets_c[t].cpu().numpy())

    def tables(self, t: int) -> profiles.SlotTables:
        t = t % self.n_slots
        eff = self._tables.eff
        return profiles.SlotTables(
            acc=self._tables.acc[t].cpu().numpy(),
            xi=self._tables.xi.cpu().numpy(),
            size=self._tables.size.cpu().numpy(),
            eff=(eff if eff.ndim == 1 else eff[t]).cpu().numpy())

    def horizon(self, n_slots: int | None = None,
                device=None) -> HorizonTables:
        n = self.n_slots if n_slots is None else n_slots
        if n > self.n_slots:
            raise ValueError(f"replay horizon {n} exceeds the scenario's "
                             f"{self.n_slots} slots")
        out = self._tables.window(0, n)
        return out if device is None else out.to(resolve_device(device))


def make_controller(policy: str, system, *, v: float = 10.0,
                    p_min: float = 0.7,
                    policy_params: Mapping | None = None,
                    solver_backend: str = "auto", device=DEFAULT_DEVICE):
    """The sweep-aligned controller for ``policy`` over ``system``."""
    params = dict(policy_params or {})
    n_bcd_iters = int(params.get("n_bcd_iters", 4))
    if policy == "lbcd":
        return LBCDController(system, v=v, p_min=p_min,
                              n_bcd_iters=n_bcd_iters,
                              solver_backend=solver_backend, device=device)
    if policy == "min":
        return baselines.MINController(system, v=v, n_iters=n_bcd_iters,
                                       solver_backend=solver_backend,
                                       device=device)
    if policy == "dos":
        return baselines.DOSController(
            system, weight=float(params.get("dos_weight", 1.0)),
            solver_backend=solver_backend, device=device)
    if policy == "jcab":
        return baselines.JCABController(
            system, latency_cap=float(params.get("jcab_latency_cap", 0.5)),
            solver_backend=solver_backend, device=device)
    raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")


@dataclasses.dataclass
class ScenarioReplay:
    """One (policy, scenario) replay: per-epoch fleet means and the service
    (whose ``reports`` hold per-stream detail). ``measured`` is the GI/G/1
    rung; under ``mode="engine"`` ``engine`` is the engine rung; under
    ``delay_model="auto"`` ``fitted`` the family fitted per epoch."""
    predicted: np.ndarray     # [T] fleet-mean calibrated-prediction AoPI
    measured: np.ndarray      # [T] fleet-mean measured AoPI per epoch
    acc: np.ndarray           # [T] fleet-mean planned accuracy
    service: AnalyticsService
    delay_model: str = "mm1"
    engine: np.ndarray | None = None   # [T] engine-rung AoPI
    fitted: list | None = None         # [T] fitted family per epoch


def replay_tables(tables: HorizonTables, policy: str = "lbcd", *,
                  n_epochs: int | None = None, v: float = 10.0,
                  p_min: float = 0.7, policy_params: Mapping | None = None,
                  epoch_duration: float = 300.0, frames_cap: int = 200_000,
                  seed: int = 0, plan_window: int | None = None,
                  solver_backend: str = "auto",
                  telemetry_gain: float = 0.0,
                  delay_model: str = "mm1",
                  true_delay_model: str | None = None,
                  mode: str = "mm1",
                  engine_params: Mapping | None = None,
                  replan_threshold: float | None = None,
                  faults: "fault_plane.FaultPlan | None" = None,
                  plan_retries: int = 2,
                  plan_deadline: float | None = None,
                  device=DEFAULT_DEVICE) -> ScenarioReplay:
    """Replay one scenario's horizon through the data plane on ``device``.

    ``plan_window=None`` is the whole horizon (one plan) at
    ``telemetry_gain`` 0, else ``min(8, n_epochs)`` (telemetry re-enters
    the planner only at window boundaries). ``delay_model`` picks the
    family (or ``"auto"``; ``true_delay_model`` then pins the world's),
    ``replan_threshold`` arms early replanning, ``mode="engine"`` adds the
    engine rung (``engine_params``: ``{"backend": "des"|"scan"|"auto",
    "frames_cap": int}``). ``faults`` applies the plan's structural faults
    to the tables first and arms the service's injections and ladder
    (``faults=None`` leaves the tables untouched). ``solver_backend`` is
    the rollouts' (``"auto"``: the kernels on the card). Bitwise
    deterministic in ``(seed, tables, n_epochs)``.
    """
    dev = resolve_device(device)
    tables = fault_plane.apply_plan(faults, tables.to(dev))
    system = TableSystem(tables)
    n_epochs = system.n_slots if n_epochs is None else n_epochs
    if n_epochs > system.n_slots:
        raise ValueError(f"n_epochs={n_epochs} exceeds the scenario's "
                         f"{system.n_slots} slots")
    if plan_window is None:
        plan_window = (n_epochs if telemetry_gain <= 0.0
                       else min(8, n_epochs))
    ctrl = make_controller(policy, system, v=v, p_min=p_min,
                           policy_params=policy_params,
                           solver_backend=solver_backend, device=dev)
    engine_params = dict(engine_params or {})
    svc = AnalyticsService(
        ctrl, mode=mode, epoch_duration=epoch_duration,
        frames_cap=frames_cap, seed=seed, plan_window=plan_window,
        tables=system.horizon(n_epochs), telemetry_gain=telemetry_gain,
        delay_model=delay_model, true_delay_model=true_delay_model,
        engine_frames_cap=engine_params.get("frames_cap"),
        engine_backend=engine_params.get("backend", "auto"),
        replan_threshold=replan_threshold,
        faults=faults, plan_retries=plan_retries,
        plan_deadline=plan_deadline)
    # Every span/metric below carries the policy and delay-model labels.
    with obs.label_context(policy=policy, delay_model=delay_model), \
            obs.span("replay.scenario", n_epochs=n_epochs, mode=mode):
        reps = svc.run(n_epochs)
    if mode == "engine":
        measured = np.array([r.model_aopi for r in reps])
        engine_series = np.array([r.measured_aopi for r in reps])
    else:
        measured = np.array([r.measured_aopi for r in reps])
        engine_series = None
    return ScenarioReplay(
        predicted=np.array([r.predicted_aopi for r in reps]),
        measured=measured,
        acc=np.array([r.accuracy for r in reps]),
        service=svc, delay_model=delay_model, engine=engine_series,
        fitted=([r.fitted_model for r in reps]
                if delay_model == "auto" else None))


@dataclasses.dataclass
class ReplayResult:
    """Suite-wide replay: ``predicted``/``measured``/``acc`` map policy ->
    ``[K, T]`` arrays aligned with ``names``/``families``."""
    names: list[str]
    families: list[str]
    policies: list[str]
    v: float
    p_min: float
    epoch_duration: float
    predicted: dict[str, np.ndarray]
    measured: dict[str, np.ndarray]
    acc: dict[str, np.ndarray]
    delay_model: str = "mm1"
    mode: str = "mm1"
    #: policy -> [K, T] engine-rung series; empty unless mode="engine".
    engine: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    #: policy -> [K] lists of the service's (t, reason) fallbacks /
    #: degraded epochs (empty without a fault plan).
    fallbacks: dict[str, list] = dataclasses.field(default_factory=dict)
    degraded: dict[str, list] = dataclasses.field(default_factory=dict)
    #: (scenario name, policy) -> repr of the exception that killed that
    #: cell; its series are NaN.
    errors: dict[tuple, str] = dataclasses.field(default_factory=dict)

    def divergence(self, policy: str) -> np.ndarray:
        """Per-scenario divergence of horizon-mean measured vs predicted
        AoPI (``runner.divergence_series``). [K]"""
        return divergence_series(self.measured[policy],
                                 self.predicted[policy])

    def engine_divergence(self, policy: str,
                          against: str = "measured") -> np.ndarray:
        """Per-scenario divergence of the engine rung vs ``against``
        ("measured": the GI/G/1 rung, "predicted": the closed form). [K]"""
        ref = (self.measured if against == "measured"
               else self.predicted)[policy]
        return divergence_series(self.engine[policy], ref)


def replay_suite(suite_or_tables, policies: Sequence[str] = POLICIES, *,
                 v: float = 10.0, p_min: float = 0.7,
                 policy_params: Mapping | None = None,
                 n_epochs: int | None = None,
                 epoch_duration: float = 300.0, frames_cap: int = 200_000,
                 seed: int = 0, plan_window: int | None = None,
                 solver_backend: str = "auto",
                 telemetry_gain: float = 0.0,
                 delay_model: str = "mm1",
                 true_delay_model: str | None = None,
                 mode: str = "mm1",
                 engine_params: Mapping | None = None,
                 replan_threshold: float | None = None,
                 faults: "fault_plane.FaultPlan | None" = None,
                 plan_retries: int = 2,
                 plan_deadline: float | None = None,
                 device=DEFAULT_DEVICE) -> ReplayResult:
    """Replay every scenario of a suite (a ``scenarios.Suite`` or stacked
    ``HorizonTables``) for every policy: the measured counterpart of
    ``scenarios.sweep``. ``faults`` applies to every cell. A cell that
    raises is recorded in ``ReplayResult.errors`` with NaN series."""
    from ..scenarios.runner import scenario
    if hasattr(suite_or_tables, "tables"):
        tables = suite_or_tables.tables
        names = list(suite_or_tables.names)
        fams = list(suite_or_tables.families)
    else:
        tables = suite_or_tables
        if tables.acc.ndim != 5:
            raise ValueError(
                f"replay_suite needs a stacked scenario axis (acc rank 5); "
                f"got acc{tuple(tables.acc.shape)} — use replay_tables for "
                f"a single scenario")
        k = int(tables.acc.shape[0])
        names = [f"scenario_{i}" for i in range(k)]
        fams = ["unknown"] * k
    k = int(tables.acc.shape[0])
    for policy in policies:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")

    predicted: dict[str, list] = {p: [] for p in policies}
    measured: dict[str, list] = {p: [] for p in policies}
    acc: dict[str, list] = {p: [] for p in policies}
    engine: dict[str, list] = {p: [] for p in policies}
    fallbacks: dict[str, list] = {p: [] for p in policies}
    degraded: dict[str, list] = {p: [] for p in policies}
    errors: dict[tuple, str] = {}
    for i in range(k):
        # As in the sweep, a scenario whose mask is all ones replays
        # unmasked (on the kernels); its fleet means are the same.
        one = scenario(tables, i)
        t_len = int(one.acc.shape[0]) if n_epochs is None else int(n_epochs)
        for policy in policies:
            try:
                with obs.label_context(family=fams[i], scenario=names[i]):
                    rep = replay_tables(
                        one, policy, n_epochs=n_epochs, v=v, p_min=p_min,
                        policy_params=policy_params,
                        epoch_duration=epoch_duration,
                        frames_cap=frames_cap, seed=seed,
                        plan_window=plan_window,
                        solver_backend=solver_backend,
                        telemetry_gain=telemetry_gain,
                        delay_model=delay_model,
                        true_delay_model=true_delay_model,
                        mode=mode, engine_params=engine_params,
                        replan_threshold=replan_threshold,
                        faults=faults, plan_retries=plan_retries,
                        plan_deadline=plan_deadline, device=device)
            except Exception as e:  # noqa: BLE001 — isolate the cell
                errors[(names[i], policy)] = f"{type(e).__name__}: {e}"
                obs.event("replay.cell_failed", policy=policy,
                          scenario=names[i], family=fams[i])
                nan = np.full(t_len, np.nan)
                predicted[policy].append(nan)
                measured[policy].append(nan.copy())
                acc[policy].append(nan.copy())
                if mode == "engine":
                    engine[policy].append(nan.copy())
                fallbacks[policy].append([])
                degraded[policy].append([])
                continue
            predicted[policy].append(rep.predicted)
            measured[policy].append(rep.measured)
            acc[policy].append(rep.acc)
            if mode == "engine":
                engine[policy].append(rep.engine)
            fallbacks[policy].append(list(rep.service.fallbacks))
            degraded[policy].append(list(rep.service.degraded_epochs))
    return ReplayResult(
        names=names, families=fams, policies=list(policies),
        v=v, p_min=p_min, epoch_duration=epoch_duration,
        predicted={p: np.stack(s) for p, s in predicted.items()},
        measured={p: np.stack(s) for p, s in measured.items()},
        acc={p: np.stack(s) for p, s in acc.items()},
        delay_model=delay_model, mode=mode,
        engine=({p: np.stack(s) for p, s in engine.items()}
                if mode == "engine" else {}),
        fallbacks=fallbacks, degraded=degraded,
        errors=errors)
