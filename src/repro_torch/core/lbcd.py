"""Algorithm 3 — the LBCD online controller and its rollout.

Per slot t (paper §V-D):
  1. observe capacities (B_t^s, C_t^s) and profile zeta_n^t;
  2. solve (P2): Algorithm 2 (virtual server -> Algorithm 1 -> first-fit ->
     Algorithm 1 per real server);
  3. update the virtual accuracy queue q(t+1) (Eq. 44).

``rollout`` runs all T slots over a pregenerated ``HorizonTables`` on its
device, the queue carried as a device tensor, with no host round trip
between slots. A horizon with a fleet-churn mask (``tables.active``) runs
its solves masked (on the plain path: ``bcd.solve_slot``) and Eq. 44 over
the live cameras, as the reference's rollout does. ``rollout_grid`` and
``rollout_scenarios`` loop it over a hyperparameter grid or a stack of
scenarios and stack the results.
``LBCDController`` is the stateful wrapper (``plan``, ``step``, ``run``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import bcd, binpack, lyapunov, profiles
from ..device import DEFAULT_DEVICE, resolve_device
from .lyapunov import VirtualQueue
from .profiles import EdgeSystem, HorizonTables


@dataclasses.dataclass
class SlotRecord:
    t: int
    aopi: np.ndarray          # per-camera closed-form AoPI
    acc: np.ndarray           # per-camera accuracy
    q: float
    assign: np.ndarray        # camera -> server
    decision: bcd.SlotDecision

    @property
    def mean_aopi(self) -> float:
        return float(np.mean(self.aopi))

    @property
    def mean_acc(self) -> float:
        return float(np.mean(self.acc))


@dataclasses.dataclass
class RunSummary:
    records: list
    v: float
    p_min: float

    @property
    def mean_aopi(self) -> float:
        return float(np.mean([r.mean_aopi for r in self.records]))

    @property
    def mean_acc(self) -> float:
        return float(np.mean([r.mean_acc for r in self.records]))

    @property
    def aopi_series(self) -> np.ndarray:
        return np.array([r.mean_aopi for r in self.records])

    @property
    def acc_series(self) -> np.ndarray:
        return np.array([r.mean_acc for r in self.records])

    @property
    def q_series(self) -> np.ndarray:
        return np.array([r.q for r in self.records])


@dataclasses.dataclass
class RolloutResult:
    """Stacked per-slot outputs of one rollout (leading axis = slot; one
    more leading axis for a grid or a stack of scenarios)."""
    aopi: torch.Tensor        # [T, N] per-camera closed-form AoPI
    acc: torch.Tensor         # [T, N] per-camera accuracy
    q: torch.Tensor           # [T]    virtual queue after the Eq. 44 update
    assign: torch.Tensor      # [T, N] camera -> server
    decision: bcd.SlotDecision  # all fields stacked [T, ...]

    @property
    def mean_aopi(self) -> float:
        return float(torch.mean(self.aopi))

    @property
    def mean_acc(self) -> float:
        return float(torch.mean(self.acc))

    @property
    def aopi_series(self) -> np.ndarray:
        return self.aopi.mean(dim=-1).cpu().numpy()

    @property
    def acc_series(self) -> np.ndarray:
        return self.acc.mean(dim=-1).cpu().numpy()

    @property
    def q_series(self) -> np.ndarray:
        return self.q.cpu().numpy()

    @staticmethod
    def stack(results) -> "RolloutResult":
        results = list(results)
        return RolloutResult(
            aopi=torch.stack([r.aopi for r in results]),
            acc=torch.stack([r.acc for r in results]),
            q=torch.stack([r.q for r in results]),
            assign=torch.stack([r.assign for r in results]),
            decision=bcd.SlotDecision.stack([r.decision for r in results]))


def rollout(tables: HorizonTables, v, p_min, q0=0.0,
            n_bcd_iters: int = 4, method: str = "waterfill",
            solver_effort: str = "fast", solver_backend: str = "auto",
            device=DEFAULT_DEVICE) -> RolloutResult:
    """Run Algorithm 3 for all T slots of ``tables`` on ``device``.

    ``v`` and ``p_min`` are Python numbers, ``q0`` the initial virtual
    queue. ``solver_backend`` is as in ``bcd.solve_slot`` (``"auto"``: the
    CUDA kernels on the card, the plain versions on the CPU and for a
    masked horizon; ``"cuda"`` refuses a mask). ``tables`` is moved to
    ``device`` if it lives elsewhere.
    """
    dev = resolve_device(device)
    tables = tables.to(dev)
    n = tables.n_cameras
    n_servers = tables.n_servers
    virt_id = torch.zeros(n, dtype=torch.int32, device=dev)
    q = torch.as_tensor(q0, dtype=torch.float32).to(dev)
    effs = profiles.eff_sequence(tables)
    kw = dict(n_iters=n_bcd_iters, method=method,
              solver_effort=solver_effort, solver_backend=solver_backend)
    decs, assigns, qs = [], [], []
    for t in range(tables.n_slots):
        acc_t, eff_t = tables.acc[t], effs[t]
        bb, bc = tables.budgets_b[t], tables.budgets_c[t]
        act_t = None if tables.active is None else tables.active[t]
        # Algorithm 2 lines 1-2: virtual-server ideal demands.
        virt = bcd.solve_slot(acc_t, tables.xi, tables.size, eff_t, virt_id,
                              bb.sum().reshape(1), bc.sum().reshape(1), q, v,
                              n_servers=1, active=act_t, **kw)
        # Algorithm 2 lines 3-9: first-fit placement.
        assign = binpack.first_fit_torch(virt.b, virt.c, bb, bc)
        # Algorithm 2 line 10: re-solve per real server.
        dec = bcd.solve_slot(acc_t, tables.xi, tables.size, eff_t, assign,
                             bb, bc, q, v, n_servers=n_servers, active=act_t,
                             **kw)
        if act_t is None:
            acc_mean = torch.mean(dec.acc)
        else:
            # Eq. 44 over the live fleet only: churned-out cameras must not
            # drag the accuracy constraint toward zero.
            acc_mean = torch.sum(dec.acc) / torch.clamp_min(torch.sum(act_t),
                                                            1.0)
        q = lyapunov.queue_update(q, acc_mean, p_min)       # Eq. 44
        decs.append(dec)
        assigns.append(assign)
        qs.append(q)
    stacked = bcd.SlotDecision.stack(decs)
    return RolloutResult(aopi=stacked.aopi, acc=stacked.acc,
                         q=torch.stack(qs), assign=torch.stack(assigns),
                         decision=stacked)


def rollout_grid(tables: HorizonTables, v, p_min, q0=0.0,
                 n_bcd_iters: int = 4, method: str = "waterfill",
                 solver_backend: str = "auto",
                 device=DEFAULT_DEVICE) -> RolloutResult:
    """One rollout per (V, P_min) pair of two equal-length sequences,
    stacked along a leading axis G."""
    v, p_min = list(np.asarray(v).ravel()), list(np.asarray(p_min).ravel())
    if len(v) != len(p_min):
        raise ValueError(f"rollout_grid: {len(v)} values of v, "
                         f"{len(p_min)} of p_min")
    return RolloutResult.stack(
        rollout(tables, float(vi), float(pi), q0, n_bcd_iters=n_bcd_iters,
                method=method, solver_backend=solver_backend, device=device)
        for vi, pi in zip(v, p_min))


def rollout_scenarios(tables: HorizonTables, v, p_min, q0=0.0,
                      n_bcd_iters: int = 4, method: str = "waterfill",
                      solver_backend: str = "auto",
                      device=DEFAULT_DEVICE) -> RolloutResult:
    """One rollout per scenario of a stack (``profiles.stack_horizons``),
    with shared hyperparameters, stacked along a leading axis K."""
    n_scen = tables.acc.shape[0]
    return RolloutResult.stack(
        rollout(HorizonTables(**{
            f: None if getattr(tables, f) is None else getattr(tables, f)[i]
            for f in profiles.HORIZON_FIELDS}),
            v, p_min, q0, n_bcd_iters=n_bcd_iters, method=method,
            solver_backend=solver_backend, device=device)
        for i in range(n_scen))


def summarize(res: RolloutResult, v: float, p_min: float) -> RunSummary:
    """Materialize a rollout into RunSummary/SlotRecord views (one host
    transfer for the whole horizon)."""
    dec = res.decision.as_numpy()
    aopi, acc = res.aopi.cpu().numpy(), res.acc.cpu().numpy()
    q, assign = res.q.cpu().numpy(), res.assign.cpu().numpy()
    records = [
        SlotRecord(t=t, aopi=aopi[t], acc=acc[t], q=float(q[t]),
                   assign=assign[t],
                   decision=bcd.SlotDecision(*(x[t] for x in
                                               dataclasses.astuple(dec))))
        for t in range(aopi.shape[0])
    ]
    return RunSummary(records, v, p_min)


class LBCDController:
    """The paper's controller (Algorithm 3) on one device."""

    def __init__(self, system: EdgeSystem, v: float = 10.0,
                 p_min: float = 0.7, n_bcd_iters: int = 4,
                 method: str = "waterfill",
                 assign_fn: Optional[Callable] = None,
                 solver_effort: str = "fast",
                 solver_backend: str = "auto", device=DEFAULT_DEVICE):
        self.system = system
        self.v = v
        self.queue = VirtualQueue(p_min=p_min)
        self.n_bcd_iters = n_bcd_iters
        self.method = method
        self.assign_fn = assign_fn or binpack.first_fit
        self.solver_effort = solver_effort
        self.solver_backend = solver_backend
        self.device = resolve_device(device)

    def _kw(self) -> dict:
        return dict(n_bcd_iters=self.n_bcd_iters, method=self.method,
                    solver_effort=self.solver_effort,
                    solver_backend=self.solver_backend, device=self.device)

    def plan(self, tables: HorizonTables, q0: float | None = None
             ) -> RolloutResult:
        """Roll the controller's hyperparameters over ``tables`` from the
        live queue state, without advancing the queue."""
        return rollout(tables, self.v, self.queue.p_min,
                       q0=self.queue.q if q0 is None else q0, **self._kw())

    def step(self, t: int, tables=None) -> SlotRecord:
        """One slot on the host-driven path (custom ``assign_fn``)."""
        sys = self.system
        budgets_b, budgets_c = sys.capacities(t)          # Alg. 3 line 2
        tables = tables if tables is not None else sys.tables(t)  # line 3
        n = tables.n_cameras
        kw = dict(n_iters=self.n_bcd_iters, method=self.method,
                  solver_effort=self.solver_effort,
                  solver_backend=self.solver_backend, device=self.device)
        virt = bcd.solve_slot_np(
            tables, np.zeros(n, np.int32), np.array([budgets_b.sum()]),
            np.array([budgets_c.sum()]), self.queue.q, self.v, n_servers=1,
            **kw)
        assign = self.assign_fn(virt.b, virt.c, budgets_b, budgets_c)
        dec = bcd.solve_slot_np(
            tables, assign, budgets_b, budgets_c, self.queue.q, self.v,
            n_servers=len(budgets_b), **kw)
        q = self.queue.update(float(np.mean(dec.acc)))    # Alg. 3 line 5
        return SlotRecord(t=t, aopi=dec.aopi, acc=dec.acc, q=q,
                          assign=assign, decision=dec)

    def run(self, n_slots: int, engine: str = "rollout") -> RunSummary:
        """Roll the controller forward ``n_slots`` slots.

        ``engine="rollout"`` (default) pregenerates the horizon on the
        controller's device and runs :func:`rollout`; ``engine="legacy"``
        runs the per-slot ``step`` loop. A custom ``assign_fn`` forces the
        legacy path (the rollout is specialized to first-fit)."""
        if engine == "rollout" and self.assign_fn is binpack.first_fit:
            tables = self.system.horizon(n_slots, device=self.device)
            res = rollout(tables, self.v, self.queue.p_min,
                          q0=self.queue.q, **self._kw())
            self.queue.q = float(res.q[-1])
            return summarize(res, self.v, self.queue.p_min)
        records = [self.step(t) for t in range(n_slots)]
        return RunSummary(records, self.v, self.queue.p_min)
