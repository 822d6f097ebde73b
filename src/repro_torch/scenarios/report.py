"""Robustness reporting: per-policy, per-family tail behaviour.

The port of ``repro.scenarios.report``: :func:`robustness` and
:func:`degradation` are the reference's, number for number, on the same
series.

The headline claims of the paper are means over one trace; what a
deployment cares about is how each policy degrades under each *kind* of
dynamics. :func:`robustness` folds a :class:`runner.SweepResult` into a
per-(policy, family) table of mean / tail-percentile / worst-case AoPI
(aggregated over the family's scenarios and slots), plus the policy's
worst family — the number a capacity planner would provision against.

When the sweep ran with ``dataplane=True`` the table grows a second
column set: the *measured* AoPI from the M/M/1 data-plane replay
(``serving.replay``) with the same mean/percentile/worst
aggregation, and the relative divergence ``measured/predicted - 1`` —
the model-vs-measurement gap where config-adaptation policies break.
With ``dataplane_params={"mode": "engine"}`` a third column set appears:
the real continuous-batching engine's AoPI (the truth ladder's third
rung) with per-rung divergences against both the GI/G/1 plane
(``div:gi``) and the closed forms (``div:cf``).

:func:`degradation` is the fault-plane counterpart: it replays a suite
clean and once per fault kind (``faults``) and tabulates, per
(policy, fault kind), measured AoPI under faults vs fault-free, the
recovery time in epochs after the fault window clears, and the fallback /
degraded-epoch counts from the service's graceful-degradation ladder.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .. import faults as fault_plane
from .runner import POLICIES, SweepResult


@dataclasses.dataclass
class FamilyStats:
    mean_aopi: float          # mean over the family's scenarios x slots
    pct_aopi: float           # tail percentile of slot-mean AoPI
    worst_aopi: float         # worst slot across the family
    mean_acc: float
    # Data-plane (measured) columns — None unless dataplane=True replayed
    # the sweep. ``mean_predicted`` is the planner prediction over the
    # *replayed* epochs (the replay may cover fewer slots than the
    # closed-form sweep), so divergence compares like with like.
    measured_mean: Optional[float] = None
    measured_pct: Optional[float] = None
    measured_worst: Optional[float] = None
    mean_predicted: Optional[float] = None
    # model name -> family-mean divergence, one entry per replayed delay
    # family (the primary model's entry equals ``divergence``).
    divergence_models: Optional[dict] = None
    # Rung-3 (real continuous-batching engine) columns — None unless the
    # replay ran with ``mode="engine"``. In that mode the ``measured_*``
    # block is the rung-2 GI/G/1 plane at the same truth rates, so the
    # three rungs of the truth ladder sit side by side per family.
    engine_mean: Optional[float] = None
    engine_pct: Optional[float] = None
    engine_worst: Optional[float] = None

    @property
    def divergence(self) -> Optional[float]:
        """Relative measured-vs-predicted gap of the family mean
        (``measured/predicted - 1``); None without a data-plane replay."""
        if self.measured_mean is None:
            return None
        return self.measured_mean / max(self.mean_predicted, 1e-12) - 1.0

    @property
    def engine_vs_gi(self) -> Optional[float]:
        """Rung 3 vs rung 2: ``engine/measured - 1`` (real engine against
        the GI/G/1 plane); None without an engine replay."""
        if self.engine_mean is None or self.measured_mean is None:
            return None
        return self.engine_mean / max(self.measured_mean, 1e-12) - 1.0

    @property
    def engine_vs_predicted(self) -> Optional[float]:
        """Rung 3 vs rung 1: ``engine/predicted - 1`` (real engine against
        the closed-form AoPI); None without an engine replay."""
        if self.engine_mean is None or self.mean_predicted is None:
            return None
        return self.engine_mean / max(self.mean_predicted, 1e-12) - 1.0


@dataclasses.dataclass
class RobustnessReport:
    policies: list[str]
    families: list[str]
    pct: float
    table: dict            # policy -> family -> FamilyStats
    # Slot coverage: the closed-form columns always span ``total_slots``;
    # the measured block spans the first ``replay_slots`` of them (a
    # truncated replay is flagged in ``__str__`` — compare truncated
    # measured columns only through ``divergence``, which is computed
    # against the predictions of the *same* epochs).
    total_slots: int = 0
    replay_slots: int = 0
    # Replayed delay families (first = primary, backing the ``diverge``
    # column); extra models add one ``div:<model>`` column each.
    delay_models: tuple = ()

    @property
    def has_measured(self) -> bool:
        return any(s.measured_mean is not None
                   for row in self.table.values() for s in row.values())

    @property
    def has_engine(self) -> bool:
        """True when the replay climbed to the truth ladder's third rung
        (``dataplane_params={"mode": "engine"}``)."""
        return any(s.engine_mean is not None
                   for row in self.table.values() for s in row.values())

    def worst_family(self, policy: str) -> tuple[str, FamilyStats]:
        fam = max(self.families,
                  key=lambda f: self.table[policy][f].worst_aopi)
        return fam, self.table[policy][fam]

    def worst_divergence(self, policy: str) -> tuple[str, float]:
        """The family where the data plane diverges most from the model
        (largest absolute relative gap). Requires a dataplane sweep."""
        if not self.has_measured:
            raise ValueError("report has no measured columns; run "
                             "sweep(..., dataplane=True)")
        fam = max(self.families,
                  key=lambda f: abs(self.table[policy][f].divergence))
        return fam, self.table[policy][fam].divergence

    @property
    def _extra_models(self) -> tuple:
        """Replayed delay families beyond the primary one."""
        return tuple(self.delay_models[1:]) if self.delay_models else ()

    def rows(self) -> list[list]:
        """Flat rows (benchmarks): [policy, family, mean, pXX, worst, acc]
        plus [measured_mean, measured_pXX, measured_worst, divergence]
        when the sweep was replayed through the data plane, plus one
        divergence per extra replayed delay model, plus
        [engine_mean, engine_pXX, engine_worst, engine_vs_gi,
        engine_vs_predicted] when the replay ran ``mode="engine"``."""
        out = []
        for p in self.policies:
            for f in self.families:
                s = self.table[p][f]
                row = [p, f, s.mean_aopi, s.pct_aopi, s.worst_aopi,
                       s.mean_acc]
                if self.has_measured:
                    row += [s.measured_mean, s.measured_pct,
                            s.measured_worst, s.divergence]
                    row += [s.divergence_models[dm]
                            for dm in self._extra_models]
                if self.has_engine:
                    row += [s.engine_mean, s.engine_pct, s.engine_worst,
                            s.engine_vs_gi, s.engine_vs_predicted]
                out.append(row)
        return out

    def __str__(self) -> str:
        w = max(len(f) for f in self.families)
        head = (f"{'policy':<6} {'family':<{w}} {'mean':>9} "
                f"{f'p{self.pct:.0f}':>9} {'worst':>9} {'acc':>6}")
        measured = self.has_measured
        engine = self.has_engine
        extra = self._extra_models
        lines = []
        if measured:
            head += (f" | {'measured':>9} {f'p{self.pct:.0f}':>9} "
                     f"{'worst':>9} {'diverge':>8}")
            for dm in extra:
                head += f" {'div:' + dm:>12}"
            if len(self.delay_models) > 1 or (
                    self.delay_models and self.delay_models[0] != "mm1"):
                lines.append("# data plane delay model(s): "
                             + ", ".join(self.delay_models)
                             + " (measured block = "
                             + self.delay_models[0] + ")")
            if 0 < self.replay_slots < self.total_slots:
                lines.append(
                    f"# measured block covers the first {self.replay_slots}"
                    f"/{self.total_slots} slots; 'diverge' compares those "
                    f"same slots' predictions")
        if engine:
            head += (f" | {'engine':>9} {f'p{self.pct:.0f}':>9} "
                     f"{'worst':>9} {'div:gi':>8} {'div:cf':>8}")
            lines.append("# truth ladder: closed-form (rung 1) | GI/G/1 "
                         "measured (rung 2) | real engine (rung 3); "
                         "div:gi = engine vs GI/G/1, div:cf = engine vs "
                         "closed form")
        lines.append(head)
        for p in self.policies:
            for f in self.families:
                s = self.table[p][f]
                line = (f"{p:<6} {f:<{w}} {s.mean_aopi:>9.4f} "
                        f"{s.pct_aopi:>9.4f} {s.worst_aopi:>9.4f} "
                        f"{s.mean_acc:>6.3f}")
                if measured:
                    line += (f" | {s.measured_mean:>9.4f} "
                             f"{s.measured_pct:>9.4f} "
                             f"{s.measured_worst:>9.4f} "
                             f"{s.divergence:>+8.2%}")
                    for dm in extra:
                        line += f" {s.divergence_models[dm]:>+12.2%}"
                if engine:
                    line += (f" | {s.engine_mean:>9.4f} "
                             f"{s.engine_pct:>9.4f} "
                             f"{s.engine_worst:>9.4f} "
                             f"{s.engine_vs_gi:>+8.2%} "
                             f"{s.engine_vs_predicted:>+8.2%}")
                lines.append(line)
        return "\n".join(lines)


def robustness(result: SweepResult, pct: float = 95.0) -> RobustnessReport:
    """Aggregate a sweep into per-(policy, family) AoPI robustness stats.

    Predicted (closed-form) columns always; measured columns when the
    sweep carries a data-plane replay (``dataplane=True``)."""
    fams = sorted(set(result.families))
    measured_aopi = getattr(result, "measured_aopi", None)
    predicted_aopi = getattr(result, "predicted_aopi", None)
    delay_models = getattr(result, "delay_models", None) or ()
    measured_by_model = getattr(result, "measured_by_model", None) or {}
    predicted_by_model = getattr(result, "predicted_by_model", None) or {}
    engine_aopi = getattr(result, "engine_aopi", None)
    total_slots = next(iter(result.aopi.values())).shape[1]
    replay_slots = (next(iter(measured_aopi.values())).shape[1]
                    if measured_aopi else 0)
    table = {}
    for policy in result.policies:
        aopi = result.aopi[policy]                       # [K, T]
        acc = result.acc[policy]
        table[policy] = {}
        for fam in fams:
            idx = [i for i, f in enumerate(result.families) if f == fam]
            a = aopi[idx]
            stats = FamilyStats(
                mean_aopi=float(a.mean()),
                pct_aopi=float(np.percentile(a, pct)),
                worst_aopi=float(a.max()),
                mean_acc=float(acc[idx].mean()))
            if measured_aopi is not None:
                m = measured_aopi[policy][idx]
                pr = (predicted_aopi[policy][idx]
                      if predicted_aopi is not None else a)
                stats.measured_mean = float(m.mean())
                stats.measured_pct = float(np.percentile(m, pct))
                stats.measured_worst = float(m.max())
                stats.mean_predicted = float(pr.mean())
                stats.divergence_models = {
                    dm: float(measured_by_model[dm][policy][idx].mean() /
                              max(predicted_by_model[dm][policy][idx]
                                  .mean(), 1e-12) - 1.0)
                    for dm in delay_models}
            if engine_aopi is not None and policy in engine_aopi:
                e = engine_aopi[policy][idx]
                stats.engine_mean = float(np.nanmean(e))
                stats.engine_pct = float(np.nanpercentile(e, pct))
                stats.engine_worst = float(np.nanmax(e))
            table[policy][fam] = stats
    return RobustnessReport(policies=list(result.policies), families=fams,
                            pct=pct, table=table, total_slots=total_slots,
                            replay_slots=replay_slots,
                            delay_models=tuple(delay_models))


# ---------------------------------------------------------------------------
# Degraded-mode report (fault plane)
# ---------------------------------------------------------------------------

#: Fault kinds :func:`degradation` replays by default — one structural,
#: one capacity, one correlated, one telemetry, one solver kind.
DEFAULT_FAULT_KINDS = ("camera_churn", "server_crash", "correlated_fade",
                       "telemetry_drop", "solver_nonconverge")


@dataclasses.dataclass
class DegradedStats:
    """One (policy, fault kind) cell of the degradation table."""
    clean_aopi: float         # fault-free measured mean AoPI
    faulted_aopi: float       # measured mean AoPI under the injection
    recovery_epochs: float    # mean epochs to re-converge after clearing
    fallbacks: int            # ladder engagements across the suite
    degraded_epochs: int      # epochs run on a fallback plan
    errors: int = 0           # cells that failed outright

    @property
    def ratio(self) -> float:
        """Faulted / clean measured AoPI (1.0 = no degradation)."""
        return self.faulted_aopi / max(self.clean_aopi, 1e-12)


@dataclasses.dataclass
class DegradationReport:
    policies: list[str]
    fault_kinds: list[str]
    table: dict               # policy -> kind -> DegradedStats
    fault_window: tuple[int, int]
    tolerance: float

    def rows(self) -> list[list]:
        """Flat rows (benchmarks/CI): [policy, kind, clean, faulted,
        ratio, recovery_epochs, fallbacks, degraded_epochs, errors]."""
        out = []
        for p in self.policies:
            for k in self.fault_kinds:
                s = self.table[p][k]
                out.append([p, k, s.clean_aopi, s.faulted_aopi, s.ratio,
                            s.recovery_epochs, s.fallbacks,
                            s.degraded_epochs, s.errors])
        return out

    def __str__(self) -> str:
        w = max(len(k) for k in self.fault_kinds)
        lines = [f"# fault window: slots [{self.fault_window[0]}, "
                 f"{self.fault_window[1]}); recovery tolerance "
                 f"{self.tolerance:.0%}",
                 f"{'policy':<6} {'fault':<{w}} {'clean':>9} "
                 f"{'faulted':>9} {'ratio':>7} {'recov':>6} "
                 f"{'fallbk':>6} {'degr':>5}"]
        for p in self.policies:
            for k in self.fault_kinds:
                s = self.table[p][k]
                lines.append(
                    f"{p:<6} {k:<{w}} {s.clean_aopi:>9.4f} "
                    f"{s.faulted_aopi:>9.4f} {s.ratio:>7.3f} "
                    f"{s.recovery_epochs:>6.1f} {s.fallbacks:>6d} "
                    f"{s.degraded_epochs:>5d}")
        return "\n".join(lines)


def _plan_for_kind(kind: str, t0: int, length: int,
                   seed: int) -> fault_plane.FaultPlan:
    """One-kind plan with parameters strong enough that the injection is
    visible (solver kinds exhaust the retry budget so the ladder's
    fallback rungs — not just retries — engage)."""
    params: dict = {}
    if kind == "camera_churn":
        params = {"fraction": 0.4, "leave_prob": 0.1, "join_prob": 0.3}
    elif kind == "server_crash":
        params = {"server": 0, "depth": 1.0}
    elif kind == "correlated_fade":
        params = {"fraction": 1.0, "depth": 0.7, "corr": 0.9}
    elif kind in fault_plane.SOLVER_KINDS:
        params = {"attempts": 64}
    return fault_plane.FaultPlan(
        (fault_plane.FaultSpec(kind, t0=t0, duration=length,
                               params=params),), seed=seed)


def degradation(suite_or_tables,
                fault_kinds: Sequence[str] = DEFAULT_FAULT_KINDS,
                policies: Sequence[str] = POLICIES, *,
                n_epochs: int | None = None, fault_t0: int | None = None,
                fault_len: int | None = None, seed: int = 0,
                tolerance: float = 0.10,
                **replay_kw) -> DegradationReport:
    """Measured AoPI under faults vs fault-free, per (policy, fault kind).

    Replays the suite once clean and once per fault kind (same seeds, so
    the clean run is the exact counterfactual), injecting that kind over
    slots ``[fault_t0, fault_t0 + fault_len)`` (defaults: the middle
    third). Recovery time is the number of epochs after the window clears
    until the faulted measured series re-enters ``tolerance`` of the
    clean series (per scenario, then averaged; the remaining horizon
    counts in full when a scenario never recovers). Plans that fail
    planning exercise the service ladder, so fallback / degraded-epoch
    counts come straight from ``ReplayResult``. Extra ``replay_kw``
    (``plan_window``, ``telemetry_gain``, ...) forward to
    ``replay_suite``.
    """
    from ..serving import replay as _replay  # lazy: keep deps one-way
    for kind in fault_kinds:
        if kind not in fault_plane.FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; known: "
                             f"{fault_plane.FAULT_KINDS}")
    clean = _replay.replay_suite(suite_or_tables, policies=list(policies),
                                 n_epochs=n_epochs, seed=seed, **replay_kw)
    t_len = next(iter(clean.measured.values())).shape[1]
    t0 = max(1, t_len // 3) if fault_t0 is None else int(fault_t0)
    length = max(1, t_len // 3) if fault_len is None else int(fault_len)
    t1 = min(t0 + length, t_len)
    table: dict = {p: {} for p in policies}
    for kind in fault_kinds:
        # Solver faults only bite at planning epochs; by default start
        # their window at slot 0 so the guaranteed first plan (and every
        # replan before ``t1``) falls inside it regardless of how the
        # plan-window boundaries align with the middle third.
        k_t0 = (0 if fault_t0 is None and kind in fault_plane.SOLVER_KINDS
                else t0)
        plan = _plan_for_kind(kind, k_t0, t1 - k_t0, seed)
        faulted = _replay.replay_suite(
            suite_or_tables, policies=list(policies), n_epochs=n_epochs,
            seed=seed, faults=plan, **replay_kw)
        for p in policies:
            c = clean.measured[p]                         # [K, T]
            f = faulted.measured[p]
            rec = []
            for k in range(c.shape[0]):
                tail = np.abs(f[k, t1:] - c[k, t1:]) <= \
                    tolerance * np.maximum(c[k, t1:], 1e-12)
                hit = np.flatnonzero(tail)
                rec.append(float(hit[0]) if hit.size else float(t_len - t1))
            n_fb = sum(len(x) for x in faulted.fallbacks.get(p, []))
            n_dg = sum(len(x) for x in faulted.degraded.get(p, []))
            n_err = sum(1 for (_, pol) in faulted.errors if pol == p)
            table[p][kind] = DegradedStats(
                clean_aopi=float(np.nanmean(c)),
                faulted_aopi=float(np.nanmean(f)),
                recovery_epochs=float(np.mean(rec)) if rec else 0.0,
                fallbacks=int(n_fb), degraded_epochs=int(n_dg),
                errors=int(n_err))
    return DegradationReport(policies=list(policies),
                             fault_kinds=list(fault_kinds), table=table,
                             fault_window=(t0, t1), tolerance=tolerance)
