"""The paper's baselines (§VI-A): MIN, DOS and JCAB.

The PyTorch counterpart of ``repro.core.baselines``. Every baseline shares
LBCD's profiles and closed forms, and picks each camera's queueing policy
by Theorem 3 given its own configuration and allocation, so a comparison
isolates the quality of the decision.

  * MIN  - lower bound: Algorithm 1 on one pooled virtual server with no
    accuracy queue (q = 0);
  * DOS  - the configuration maximizing ``accuracy - w * latency`` under an
    equal split, latency-optimal allocation (b ~ sqrt(size/eff),
    c ~ sqrt(xi)), servers by first-fit;
  * JCAB - the most accurate configuration meeting a latency cap,
    bandwidth ~ frame size and compute ~ xi, round-robin servers.

``rollout_min`` / ``rollout_dos`` / ``rollout_jcab`` run all T slots of a
``HorizonTables`` on its device as a Python loop over slots, with no host
round trip between slots (DOS's first-fit is ``first_fit_torch``). Their
``solver_backend`` is as in ``bcd.solve_slot``: on ``"auto"`` the DOS/JCAB
configuration scans launch the ``baseline_argmax`` kernel on the card and
take its plain version on the CPU. Per-server float sums are pairwise
trees (``allocate.tree_segment_sum``), so a run is deterministic on the
card and a ``cuda`` run equals a ``torch`` run. A horizon with a
fleet-churn mask (``tables.active``) runs as the reference's does: MIN's
solves masked, on the plain path (``"cuda"`` refuses the mask); DOS and
JCAB scan every camera with ``baseline_argmax``, kernel included, and apply
the mask after the scan (zero weights and shares for dead cameras, sums
guarded at 1e-30, first-fit over the weighted shares). ``MINController``,
``DOSController`` and ``JCABController`` wrap them: ``run`` rolls a whole
horizon, ``step`` one slot of host profiles, both on the controller's
device.
"""
from __future__ import annotations

import dataclasses

import torch

from . import aopi, bcd, binpack, profiles
from .allocate import segment_sum, segment_tree, tree_segment_sum
from .lbcd import RolloutResult, RunSummary, SlotRecord, summarize
from .profiles import EdgeSystem, HorizonTables
from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.slot_solver import ops, ref


# ---------------------------------------------------------------------------
# Device rollouts (a Python loop over slots)
# ---------------------------------------------------------------------------

def _eval_decision(acc_t, xi, size, eff, r_idx, m_idx, b, c, active=None):
    """Theorem-3 policy and closed-form AoPI of a fixed configuration and
    allocation, as a ``bcd.SlotDecision`` (score = mean AoPI). Under a
    churn mask (0/1 floats) dead cameras give exactly 0 and the score is
    the live mean."""
    n = acc_t.shape[0]
    r, m = r_idx.long(), m_idx.long()
    lam = b * eff / size[r]
    mu = c / xi[m, r]
    p = acc_t[torch.arange(n, device=acc_t.device), m, r]
    if active is not None:
        lam = lam * active
        mu = mu * active
        pol = aopi.optimal_policy(torch.clamp_min(lam, 1e-9),
                                  torch.clamp_min(mu, 1e-9), p)
        a = aopi.aopi_masked(lam, mu, p, pol, active=active)
        n_live = torch.clamp_min(torch.sum(active), 1.0)
        return bcd.SlotDecision(r_idx, m_idx, pol, b * active, c * active,
                                lam, mu, p * active, a,
                                torch.sum(a) / n_live)
    pol = aopi.optimal_policy(lam, mu, p)
    lam_e = torch.clamp_min(lam, 1e-9)
    mu_e = torch.clamp_min(mu, 1e-9)
    a = torch.where(pol == aopi.LCFSP, aopi.aopi_lcfsp(lam_e, mu_e, p),
                    aopi.aopi_fcfs(lam_e, mu_e, p))
    return bcd.SlotDecision(r_idx, m_idx, pol, b, c, lam, mu, p, a,
                            torch.mean(a))


def _result(decs, assigns) -> RolloutResult:
    """Stack per-slot decisions; the baselines carry no queue (q = 0)."""
    stacked = bcd.SlotDecision.stack(decs)
    return RolloutResult(aopi=stacked.aopi, acc=stacked.acc,
                         q=torch.zeros(len(decs), device=stacked.aopi.device),
                         assign=torch.stack(assigns), decision=stacked)


def _prepare(tables: HorizonTables, device):
    dev = resolve_device(device)
    return tables.to(dev), dev


def _live(tables: HorizonTables, t: int, dtype):
    """Slot ``t``'s churn mask as 0/1 floats, or None without a mask."""
    if tables.active is None:
        return None
    return (tables.active[t] > 0).to(dtype)


_EPS = 1e-30    # the reference's guard on masked sums (all-dead servers)


def rollout_min(tables: HorizonTables, v=10.0, n_bcd_iters: int = 4,
                method: str = "waterfill", solver_effort: str = "fast",
                solver_backend: str = "auto",
                device=DEFAULT_DEVICE) -> RolloutResult:
    """MIN over the whole horizon: Algorithm 1 on one pooled virtual
    server, q = 0. At ``AUTO_TILE_MIN_CAMERAS`` cameras and more, ``auto``
    runs the virtual server's water-fills on the tiled kernel. A masked
    horizon's solves run on the plain path."""
    tables, dev = _prepare(tables, device)
    n = tables.n_cameras
    virt_id = torch.zeros(n, dtype=torch.int32, device=dev)
    q = torch.zeros((), device=dev)
    effs = profiles.eff_sequence(tables)
    decs, assigns = [], []
    for t in range(tables.n_slots):
        dec = bcd.solve_slot(tables.acc[t], tables.xi, tables.size, effs[t],
                             virt_id, tables.budgets_b[t].sum().reshape(1),
                             tables.budgets_c[t].sum().reshape(1), q, v,
                             n_servers=1, n_iters=n_bcd_iters, method=method,
                             solver_effort=solver_effort,
                             solver_backend=solver_backend,
                             active=None if tables.active is None
                             else tables.active[t])
        decs.append(dec)
        assigns.append(virt_id)
    return _result(decs, assigns)


def _baseline_scan(solver_backend, device, n: int):
    """The DOS/JCAB configuration scan of a resolved backend: the
    ``baseline_argmax`` kernel on ``cuda``, its plain version on
    ``torch``."""
    spec = bcd.resolve_spec(solver_backend, device, n)
    return ops.baseline_argmax if spec.backend == "cuda" \
        else ref.baseline_argmax_ref


def _per_camera(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` for every camera, divided by a device tensor (a host
    scalar divides as a multiplication by its reciprocal on the card)."""
    share = total / torch.full((), float(n), device=total.device)
    return share.expand(n).contiguous()


def rollout_dos(tables: HorizonTables, weight=1.0,
                solver_backend: str = "auto",
                device=DEFAULT_DEVICE) -> RolloutResult:
    """DOS over the whole horizon (the per-slot math of
    ``DOSController.step`` with the device first-fit). One
    ``baseline_argmax`` launch per slot on the cuda backend."""
    tables, dev = _prepare(tables, device)
    n, s = tables.n_cameras, tables.n_servers
    xi, size = tables.xi, tables.size
    scan = _baseline_scan(solver_backend, dev, n)
    effs = profiles.eff_sequence(tables)
    decs, assigns = [], []
    for t in range(tables.n_slots):
        acc_t, eff_t = tables.acc[t], effs[t]
        bb, bc = tables.budgets_b[t], tables.budgets_c[t]
        sum_b, sum_c = bb.sum(), bc.sum()
        m_idx, r_idx = scan(_per_camera(sum_b, n), _per_camera(sum_c, n),
                            acc_t, xi, size, eff_t, mode="dos",
                            threshold=weight)
        # Latency-minimizing allocation: b ~ sqrt(size/eff), c ~ sqrt(xi).
        w_b = torch.sqrt(size[r_idx.long()] / eff_t)
        w_c = torch.sqrt(xi[m_idx.long(), r_idx.long()])
        act = _live(tables, t, w_b.dtype)
        if act is None:
            tot_b, tot_c = w_b.sum(), w_c.sum()
        else:
            # Dead cameras weigh 0, so their shares flow to the survivors;
            # the guards keep an all-dead server at 0/eps = 0, not NaN.
            w_b, w_c = w_b * act, w_c * act
            tot_b = torch.clamp_min(w_b.sum(), _EPS)
            tot_c = torch.clamp_min(w_c.sum(), _EPS)
        assign = binpack.first_fit_torch(w_b / tot_b * sum_b,
                                         w_c / tot_c * sum_c, bb, bc)
        tree = segment_tree(assign, s)
        a = assign.long()
        den_b = tree_segment_sum(w_b, tree)
        den_c = tree_segment_sum(w_c, tree)
        if act is not None:
            den_b = torch.clamp_min(den_b, _EPS)
            den_c = torch.clamp_min(den_c, _EPS)
        b = bb[a] * w_b / den_b[a]
        c = bc[a] * w_c / den_c[a]
        decs.append(_eval_decision(acc_t, xi, size, eff_t, r_idx, m_idx, b,
                                   c, active=act))
        assigns.append(assign)
    return _result(decs, assigns)


def rollout_jcab(tables: HorizonTables, latency_cap=0.5, n_rounds: int = 3,
                 solver_backend: str = "auto",
                 device=DEFAULT_DEVICE) -> RolloutResult:
    """JCAB over the whole horizon (the per-slot math of
    ``JCABController.step``; the round-robin assignment is static).
    ``n_rounds`` ``baseline_argmax`` launches per slot on the cuda
    backend."""
    tables, dev = _prepare(tables, device)
    n, s = tables.n_cameras, tables.n_servers
    xi, size = tables.xi, tables.size
    scan = _baseline_scan(solver_backend, dev, n)
    effs = profiles.eff_sequence(tables)
    assign = (torch.arange(n, device=dev) % s).to(torch.int32)
    a = assign.long()
    tree = segment_tree(assign, s)
    counts = segment_sum(torch.ones(n, device=dev), a, s)
    share = (1.0 / torch.clamp_min(counts, 1.0))[a]
    decs, assigns = [], []
    for t in range(tables.n_slots):
        acc_t, eff_t = tables.acc[t], effs[t]
        bb, bc = tables.budgets_b[t], tables.budgets_c[t]
        act = _live(tables, t, bb.dtype)
        if act is None:
            share_t = share
        else:
            # The round-robin assignment stays; a server splits its
            # budget over its live members.
            counts_t = segment_sum(act, a, s)
            share_t = act * (1.0 / torch.clamp_min(counts_t, 1.0))[a]
        b = bb[a] * share_t
        c = bc[a] * share_t
        m_idx = r_idx = torch.zeros(n, dtype=torch.int32, device=dev)
        for _ in range(n_rounds):
            m_idx, r_idx = scan(b, c, acc_t, xi, size, eff_t, mode="jcab",
                                threshold=latency_cap)
            # Re-allocate: bandwidth ~ frame size (equalizes lam), compute
            # ~ xi (per [48]).
            size_n = size[r_idx.long()]
            xi_n = xi[m_idx.long(), r_idx.long()]
            if act is not None:
                size_n, xi_n = size_n * act, xi_n * act
            den_b = tree_segment_sum(size_n, tree)
            den_c = tree_segment_sum(xi_n, tree)
            if act is not None:
                den_b = torch.clamp_min(den_b, _EPS)
                den_c = torch.clamp_min(den_c, _EPS)
            b = bb[a] * size_n / den_b[a]
            c = bc[a] * xi_n / den_c[a]
        decs.append(_eval_decision(acc_t, xi, size, eff_t, r_idx, m_idx, b,
                                   c, active=act))
        assigns.append(assign)
    return _result(decs, assigns)


# ---------------------------------------------------------------------------
# Controllers
# ---------------------------------------------------------------------------

class BaselineController:
    """A baseline on one device: ``run`` and ``step`` over the subclass's
    ``_rollout``."""

    def __init__(self, system: EdgeSystem, name: str,
                 device=DEFAULT_DEVICE):
        self.system = system
        self.name = name
        self.device = resolve_device(device)

    def run(self, n_slots: int, engine: str = "rollout") -> RunSummary:
        """``engine="rollout"`` (default) pregenerates the horizon on the
        controller's device and rolls it; ``engine="legacy"`` loops
        ``step`` over the system's per-slot host profiles."""
        if engine == "rollout":
            tables = self.system.horizon(n_slots, device=self.device)
            return summarize(self._rollout(tables), v=0.0, p_min=0.0)
        records = [self.step(t) for t in range(n_slots)]
        return RunSummary(records, v=0.0, p_min=0.0)

    def step(self, t: int, tables=None) -> SlotRecord:
        """Slot ``t``: the rollout over a one-slot horizon of ``tables``
        (default ``system.tables(t)``) and the slot's capacities."""
        budgets_b, budgets_c = self.system.capacities(t)
        tables = tables if tables is not None else self.system.tables(t)
        horizon = profiles.slot_horizon(tables, budgets_b, budgets_c,
                                        self.device)
        rec = summarize(self._rollout(horizon), v=0.0, p_min=0.0).records[0]
        return dataclasses.replace(rec, t=t)

    def _rollout(self, tables: HorizonTables) -> RolloutResult:
        raise NotImplementedError


class MINController(BaselineController):
    """Lower bound: one virtual server, no accuracy requirement (q == 0).
    ``kw`` are ``rollout_min``'s solver options: ``n_iters``, ``method``,
    ``solver_effort`` and ``solver_backend``."""

    OPTIONS = ("n_iters", "method", "solver_effort", "solver_backend")

    def __init__(self, system: EdgeSystem, v: float = 10.0,
                 device=DEFAULT_DEVICE, **kw):
        unknown = set(kw) - set(self.OPTIONS)
        if unknown:
            raise TypeError(f"MINController: unknown options "
                            f"{sorted(unknown)}; known: {self.OPTIONS}")
        super().__init__(system, "MIN", device)
        self.v = v
        self.kw = kw

    def _rollout(self, tables: HorizonTables) -> RolloutResult:
        return rollout_min(tables, self.v,
                           n_bcd_iters=self.kw.get("n_iters", 4),
                           method=self.kw.get("method", "waterfill"),
                           solver_effort=self.kw.get("solver_effort",
                                                     "fast"),
                           solver_backend=self.kw.get("solver_backend",
                                                      "auto"),
                           device=self.device)


class DOSController(BaselineController):
    """DOS [47]: maximize (accuracy - latency).

    Per camera it picks the (r, m) maximizing ``zeta - (1/lam + 1/mu)``
    under an equal split, then allocates to minimize total expected latency
    (sqrt water-filling: latency-optimal but AoPI-blind, which is why
    §VI-B2 sees it collapse to the lightest configuration). Server
    selection is first-fit on its demands, as LBCD's (§VI-A).
    """

    def __init__(self, system: EdgeSystem, weight: float = 1.0,
                 solver_backend: str = "auto", device=DEFAULT_DEVICE):
        super().__init__(system, "DOS", device)
        self.weight = weight
        self.solver_backend = solver_backend

    def _rollout(self, tables: HorizonTables) -> RolloutResult:
        return rollout_dos(tables, self.weight,
                           solver_backend=self.solver_backend,
                           device=self.device)


class JCABController(BaselineController):
    """JCAB [3]: maximize accuracy s.t. total latency <= latency_cap, with
    computation allocated proportional to the configuration's xi [48]."""

    def __init__(self, system: EdgeSystem, latency_cap: float = 0.5,
                 n_rounds: int = 3, solver_backend: str = "auto",
                 device=DEFAULT_DEVICE):
        super().__init__(system, "JCAB", device)
        self.latency_cap = latency_cap
        self.n_rounds = n_rounds
        self.solver_backend = solver_backend

    def _rollout(self, tables: HorizonTables) -> RolloutResult:
        return rollout_jcab(tables, self.latency_cap,
                            n_rounds=self.n_rounds,
                            solver_backend=self.solver_backend,
                            device=self.device)


def make(name: str, system: EdgeSystem, **kw):
    """A baseline controller by name (``MIN``, ``DOS`` or ``JCAB``)."""
    name = name.upper()
    if name == "MIN":
        return MINController(system, **kw)
    if name == "DOS":
        return DOSController(system, **kw)
    if name == "JCAB":
        return JCABController(system, **kw)
    raise ValueError(f"unknown baseline {name!r}")
