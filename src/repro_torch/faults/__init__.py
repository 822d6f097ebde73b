"""Declarative fault-injection plane for the plan/measure/replan loop.

The port of ``repro.faults``. Every draw is host numpy from the same
``zlib``-derived seeds, so each mask and capacity factor is bitwise the
reference's; :func:`apply_plan` builds torch tensors on the tables'
device. The telemetry and solver kinds are consulted by the serving
service (``serving.AnalyticsService``).

A :class:`FaultPlan` is a tuple of timed :class:`FaultSpec` injections plus a
seed; every fault kind draws from its own deterministic RNG stream
(``default_rng([seed, crc32(kind), index])``), so adding a fade never
perturbs the churn trajectory and a plan is fully reproducible from
``(specs, seed)``.

Fault kinds split into three delivery mechanisms:

* **structural** (``camera_churn``, ``server_crash``, ``correlated_fade``)
  are baked into :class:`~repro_torch.core.profiles.HorizonTables` by
  :func:`apply_plan` *before* the controller ever sees them — churn becomes
  the ``active[T, N]`` fleet mask threaded through the rollout engines and
  the water-fill, capacity faults scale ``budgets_b``/``budgets_c`` (floored
  at ``1e-6 x`` the mean so the solvers stay finite);
* **telemetry** (``telemetry_drop``/``delay``/``corrupt``) are consulted by
  the serving service (``AnalyticsService``) per
  measurement epoch and gate what the EWMA telemetry filter is allowed to
  ingest;
* **solver** (``solver_nan``/``nonconverge``/``timeout``) are consulted per
  planning *attempt* and drive the graceful-degradation ladder
  (retry -> stale plan -> MIN fallback).

``faults=None`` everywhere is the bitwise no-op path: no ``active`` leaf is
attached, no budget is touched, and every downstream trace is byte-identical
to a pre-fault-plane build (pinned by ``tests/test_torch_faults.py``).
"""
from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

#: Every injectable fault kind, grouped by delivery mechanism below.
FAULT_KINDS = (
    "camera_churn",        # cameras leave/join mid-horizon (active mask)
    "server_crash",        # one server loses its budgets for a window
    "correlated_fade",     # correlated multi-server capacity fade
    "telemetry_drop",      # a measurement epoch is lost entirely
    "telemetry_delay",     # a measurement arrives k epochs late
    "telemetry_corrupt",   # a measurement arrives non-finite
    "solver_nan",          # planner output poisoned with NaN
    "solver_nonconverge",  # planner raises (non-convergence)
    "solver_timeout",      # planner blows its watchdog deadline
)

STRUCTURAL_KINDS = ("camera_churn", "server_crash", "correlated_fade")
TELEMETRY_KINDS = ("telemetry_drop", "telemetry_delay", "telemetry_corrupt")
SOLVER_KINDS = ("solver_nan", "solver_nonconverge", "solver_timeout")


class InjectedSolverFault(RuntimeError):
    """Raised (or synthesized) by the service when a ``solver_*`` injection
    fires on a planning attempt; carries the fault kind as ``args[0]``."""


@dataclass(frozen=True)
class FaultSpec:
    """One timed injection: ``kind`` active on slots ``[t0, t0+duration)``
    (``duration=None`` = until the end of the horizon), with kind-specific
    ``params`` (see :func:`storm_plan` for the full vocabulary)."""

    kind: str
    t0: int = 0
    duration: int | None = None
    params: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if self.duration is not None and self.duration < 0:
            raise ValueError(f"duration must be >= 0, got {self.duration}")

    def window(self, n_slots: int) -> tuple[int, int]:
        """Clipped ``[t0, t1)`` slot window within an ``n_slots`` horizon."""
        t0 = max(int(self.t0), 0)
        t1 = n_slots if self.duration is None else min(
            int(self.t0) + int(self.duration), n_slots)
        return t0, max(t1, t0)

    def active_at(self, t: int) -> bool:
        if t < self.t0:
            return False
        return self.duration is None or t < self.t0 + self.duration


@dataclass(frozen=True)
class FaultPlan:
    """A reproducible set of timed injections over one replay horizon."""

    specs: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    @property
    def kinds(self) -> tuple:
        return tuple(dict.fromkeys(s.kind for s in self.specs))

    def by_kind(self, *kinds: str) -> tuple:
        return tuple(s for s in self.specs if s.kind in kinds)

    def _rng(self, kind: str, index: int = 0) -> np.random.Generator:
        """Per-(kind, index) RNG stream; independent across kinds so one
        injection never perturbs another's trajectory."""
        return np.random.default_rng(
            [int(self.seed), zlib.crc32(kind.encode()), int(index)])

    # -- structural faults --------------------------------------------------

    def camera_active(self, n_slots: int, n_cameras: int):
        """``[T, N]`` fleet mask from the plan's ``camera_churn`` specs, or
        ``None`` when the plan has no churn (the bitwise no-op path).

        Inside each churn window a two-state Markov chain drives every
        camera: at ``t0`` a ``fraction`` of the fleet drops out, then each
        slot a live camera leaves w.p. ``leave_prob`` and a dead one
        rejoins w.p. ``join_prob``. At least one camera is guaranteed live
        in every slot (a rotating survivor) so fleet reductions and the
        water-fill always have a live member.
        """
        specs = self.by_kind("camera_churn")
        if not specs:
            return None
        mask = np.ones((n_slots, n_cameras), np.float32)
        for idx, spec in enumerate(specs):
            rng = self._rng("camera_churn", idx)
            frac = float(spec.params.get("fraction", 0.3))
            p_leave = float(spec.params.get("leave_prob", 0.05))
            p_join = float(spec.params.get("join_prob", 0.1))
            t0, t1 = spec.window(n_slots)
            if t1 <= t0 or n_cameras < 1:
                continue
            gone = np.zeros(n_cameras, bool)
            n_out = min(n_cameras - 1,
                        max(1, int(round(frac * n_cameras)))) \
                if n_cameras > 1 else 0
            if n_out > 0:
                gone[rng.choice(n_cameras, size=n_out, replace=False)] = True
            for t in range(t0, t1):
                mask[t] *= ~gone
                u = rng.random(n_cameras)
                gone = np.where(gone, u >= p_join, u < p_leave)
        for t in range(n_slots):
            if mask[t].sum() == 0:
                mask[t, t % n_cameras] = 1.0
        return mask

    def capacity_factor(self, n_slots: int, n_servers: int):
        """``[T, S]`` multiplicative capacity factor from ``server_crash``
        and ``correlated_fade`` specs, or ``None`` when there are none.

        A crash zeroes one server's factor (``depth=1``) for its window; a
        fade draws a Gaussian factor model — one shared shock plus per-
        server idiosyncratic noise mixed by ``corr`` — squashed through a
        logistic into ``(1 - depth, 1)`` across a ``fraction`` of servers.
        """
        specs = self.by_kind("server_crash", "correlated_fade")
        if not specs:
            return None
        factor = np.ones((n_slots, n_servers), np.float64)
        for idx, spec in enumerate(specs):
            rng = self._rng(spec.kind, idx)
            t0, t1 = spec.window(n_slots)
            if t1 <= t0 or n_servers < 1:
                continue
            if spec.kind == "server_crash":
                server = int(spec.params.get(
                    "server", rng.integers(n_servers))) % n_servers
                depth = float(spec.params.get("depth", 1.0))
                factor[t0:t1, server] *= 1.0 - depth
            else:
                frac = float(spec.params.get("fraction", 0.5))
                depth = float(spec.params.get("depth", 0.7))
                corr = min(max(float(spec.params.get("corr", 0.8)), 0.0), 1.0)
                k = min(n_servers, max(1, int(round(frac * n_servers))))
                hit = rng.choice(n_servers, size=k, replace=False)
                shared = rng.standard_normal((t1 - t0, 1))
                own = rng.standard_normal((t1 - t0, k))
                z = np.sqrt(corr) * shared + np.sqrt(1.0 - corr) * own
                fade = 1.0 - depth / (1.0 + np.exp(-z))
                factor[t0:t1, hit] *= fade
        return factor

    # -- behavioral faults (consulted by the service at runtime) ------------

    def telemetry_fault(self, t: int):
        """The :class:`FaultSpec` hitting measurement epoch ``t`` (first
        match wins), or ``None``. ``prob`` params fire the fault on an
        independent per-epoch coin from the kind's RNG stream."""
        for idx, spec in enumerate(self.by_kind(*TELEMETRY_KINDS)):
            if not spec.active_at(t):
                continue
            prob = float(spec.params.get("prob", 1.0))
            if prob >= 1.0 or \
                    self._rng(spec.kind, (idx + 1) * 1_000_003 + t).random() < prob:
                return spec
        return None

    def solver_fault(self, t: int, attempt: int = 0):
        """Fault kind to inject into planning attempt ``attempt`` of the
        window planned at epoch ``t``, or ``None``. A spec fails the first
        ``params['attempts']`` attempts (default 1), so a lone injection
        exercises the retry path while ``attempts >= plan_retries + 1``
        pushes the service down the fallback ladder."""
        for spec in self.by_kind(*SOLVER_KINDS):
            if spec.active_at(t) and attempt < int(spec.params.get("attempts", 1)):
                return spec.kind
        return None


def _from_host(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``x`` cast on the host to ``like``'s dtype, on ``like``'s device."""
    np_dtype = torch.empty((), dtype=like.dtype).numpy().dtype
    return torch.from_numpy(np.asarray(x, np_dtype)).to(like.device)


def apply_plan(plan, tables):
    """Bake a plan's *structural* faults into ``tables``.

    Returns ``tables`` unchanged (same object) when ``plan`` is ``None`` or
    carries no structural specs — the bitwise no-op guarantee. Otherwise a
    copy with the churn ``active`` mask attached (intersected with any
    existing mask) and capacity factors multiplied into the budgets, floored
    at ``1e-6 x`` the pre-fault mean so zeroed servers stay solver-safe.
    The new leaves are torch tensors on the tables' device, cast from the
    host draws as the reference casts them.
    """
    if plan is None:
        return tables
    n_slots, n_cameras = int(tables.n_slots), int(tables.n_cameras)
    n_servers = int(tables.budgets_b.shape[-1])
    out = tables
    dev = tables.acc.device
    act = plan.camera_active(n_slots, n_cameras)
    if act is not None:
        active = torch.as_tensor(act, dtype=tables.acc.dtype, device=dev)
        if tables.active is not None:
            active = active * tables.active.to(tables.acc.dtype)
        out = dataclasses.replace(out, active=active)
    factor = plan.capacity_factor(n_slots, n_servers)
    if factor is not None:
        bb = out.budgets_b.cpu().numpy().astype(np.float64)
        bc = out.budgets_c.cpu().numpy().astype(np.float64)
        bb = np.maximum(bb * factor, 1e-6 * max(float(bb.mean()), 1e-30))
        bc = np.maximum(bc * factor, 1e-6 * max(float(bc.mean()), 1e-30))
        out = dataclasses.replace(
            out,
            budgets_b=_from_host(bb, tables.budgets_b),
            budgets_c=_from_host(bc, tables.budgets_c))
    return out


def storm_plan(n_slots: int, *, seed: int = 0,
               solver: bool = True) -> FaultPlan:
    """Every fault kind at once over an ``n_slots`` horizon — the CI
    fault-storm preset. The solver faults are staged so every rung of the
    degradation ladder engages on the default ``plan_retries=2``: a
    retry-exhausting ``solver_timeout`` at ``t=0`` (no good plan exists
    yet, so the service lands on the MIN-fallback rung), a single-attempt
    ``solver_nonconverge`` band over the middle third (retry succeeds),
    and a retry-exhausting ``solver_nan`` band over the final third
    (stale-plan rung, re-projected on the churned fleet)."""
    third = max(1, n_slots // 3)
    specs = [
        FaultSpec("camera_churn", t0=1, duration=max(2, n_slots - 2),
                  params={"fraction": 0.4, "leave_prob": 0.1,
                          "join_prob": 0.3}),
        FaultSpec("server_crash", t0=third, duration=third,
                  params={"server": 0, "depth": 1.0}),
        FaultSpec("correlated_fade", t0=0, duration=None,
                  params={"fraction": 1.0, "depth": 0.6, "corr": 0.9}),
        FaultSpec("telemetry_drop", t0=1, duration=2),
        FaultSpec("telemetry_corrupt", t0=2 * third, duration=1),
        FaultSpec("telemetry_delay", t0=2 * third + 1, duration=1,
                  params={"delay": 1}),
    ]
    if solver:
        specs += [
            FaultSpec("solver_timeout", t0=0, duration=1,
                      params={"attempts": 8}),
            FaultSpec("solver_nonconverge", t0=third, duration=third),
            FaultSpec("solver_nan", t0=2 * third, duration=None,
                      params={"attempts": 8}),
        ]
    return FaultPlan(tuple(specs), seed=seed)
