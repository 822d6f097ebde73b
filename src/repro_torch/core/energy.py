"""Energy-aware LBCD, the paper's §VII future-work item.

The PyTorch counterpart of ``repro.core.energy``. Per-camera power is
linear in the allocated resources, ``e_n = kappa_tx * b_n + kappa_c * c_n``;
the long-term constraint ``lim (1/T) sum_t mean_n e_{n,t} <= E_max`` gets
its own virtual queue ``z(t+1) = max(z(t) - E_max + e_bar_t, 0)`` and the
drift-plus-penalty objective gains ``+ z(t) * e_bar_t``. While z > 0 each
Algorithm-1 solve runs over a ladder of budget scales and keeps the scale
of least energy-augmented score.

``rollout_energy`` runs the two-queue controller over a ``HorizonTables``
on its device, a Python loop over slots; ``EnergyAwareLBCD`` wraps it:
``run`` rolls a whole horizon, ``step`` one slot of host profiles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bcd, binpack, lyapunov, profiles
from .lbcd import (LBCDController, RolloutResult, RunSummary, SlotRecord,
                   summarize)
from .lyapunov import VirtualQueue
from .profiles import HorizonTables
from ..device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class EnergyModel:
    kappa_tx: float = 2e-8     # W per Hz of occupied bandwidth
    kappa_c: float = 2e-12     # W per FLOPS allocated
    e_max: float = 1.0         # long-term average W per camera

    def power(self, b, c) -> np.ndarray:
        return self.kappa_tx * np.asarray(b) + self.kappa_c * np.asarray(c)


def rollout_energy(tables: HorizonTables, v, p_min, kappa_tx, kappa_c,
                   e_max, q0=0.0, z0=0.0, n_scales: int = 13,
                   scale_base: float = 0.75, n_bcd_iters: int = 4,
                   method: str = "waterfill", solver_effort: str = "fast",
                   solver_backend: str = "auto", assign_fn=None,
                   device=DEFAULT_DEVICE):
    """Two-queue (accuracy + energy) LBCD over all T slots of ``tables``.

    Per slot, while the energy queue z is positive, both Algorithm-1
    solves (virtual server, then per real server) run at every budget
    scale ``scale_base ** [0..n_scales)`` and the least ``dec.score + z *
    power`` wins, ties to the first (largest) scale; at z == 0 each is the
    single full-budget solve. Every ladder solve takes ``solver_backend``
    as given, tiled specs included. ``assign_fn(b, c, budgets_b,
    budgets_c)`` places the cameras between the two solves (default
    ``binpack.first_fit_torch``).

    A fleet-churn mask (``tables.active``) raises ``NotImplementedError``:
    the reference's ``rollout_energy`` takes no mask and ignores one
    silently (its solves and power means run over every camera), a fault
    the port does not copy (ROADMAP section 3).

    Returns ``(RolloutResult, power[T], z[T])``.
    """
    dev = resolve_device(device)
    tables = tables.to(dev)
    if tables.active is not None:
        raise NotImplementedError(
            "energy-aware LBCD with a fleet-churn mask (active): the "
            "reference ignores the mask silently; the port refuses it "
            "until a masked energy ladder is specified")
    n, n_servers = tables.n_cameras, tables.n_servers
    place = assign_fn or binpack.first_fit_torch
    virt_id = torch.zeros(n, dtype=torch.int32, device=dev)
    scales = scale_base ** torch.arange(n_scales, dtype=torch.float32,
                                        device=dev)
    kw = dict(n_iters=n_bcd_iters, method=method,
              solver_effort=solver_effort, solver_backend=solver_backend)

    def solve_scaled(acc_t, eff_t, assign, bb, bc, q, z, ladder, n_srv):
        def at_scale(s):
            dec = bcd.solve_slot(acc_t, tables.xi, tables.size, eff_t,
                                 assign, bb * s, bc * s, q, v,
                                 n_servers=n_srv, **kw)
            power = torch.mean(kappa_tx * dec.b + kappa_c * dec.c)
            return dec, power, dec.score + z * power

        if not ladder:
            dec, power, _ = at_scale(torch.ones((), device=dev))
            return dec, power
        decs, powers, scores = zip(*(at_scale(scales[i])
                                     for i in range(n_scales)))
        i = torch.argmin(torch.stack(scores))    # first minimum
        stacked = bcd.SlotDecision.stack(decs)
        return (bcd.SlotDecision(*(getattr(stacked, f.name)[i] for f in
                                   dataclasses.fields(bcd.SlotDecision))),
                torch.stack(powers)[i])

    q = torch.as_tensor(q0, dtype=torch.float32).to(dev)
    z = torch.as_tensor(z0, dtype=torch.float32).to(dev)
    effs = profiles.eff_sequence(tables)
    decs, assigns, qs, zs, powers = [], [], [], [], []
    for t in range(tables.n_slots):
        acc_t, eff_t = tables.acc[t], effs[t]
        bb, bc = tables.budgets_b[t], tables.budgets_c[t]
        # The reference branches on the device (lax.cond(z > 0, ...)); here
        # the branch reads z on the host, once per slot.
        ladder = float(z) > 0.0
        virt, _ = solve_scaled(acc_t, eff_t, virt_id, bb.sum().reshape(1),
                               bc.sum().reshape(1), q, z, ladder, 1)
        assign = place(virt.b, virt.c, bb, bc)
        dec, power = solve_scaled(acc_t, eff_t, assign, bb, bc, q, z, ladder,
                                  n_servers)
        q = lyapunov.queue_update(q, torch.mean(dec.acc), p_min)
        z = torch.clamp_min(z - e_max + power, 0.0)
        decs.append(dec)
        assigns.append(assign)
        qs.append(q)
        zs.append(z)
        powers.append(power)
    stacked = bcd.SlotDecision.stack(decs)
    res = RolloutResult(aopi=stacked.aopi, acc=stacked.acc, q=torch.stack(qs),
                        assign=torch.stack(assigns), decision=stacked)
    return res, torch.stack(powers), torch.stack(zs)


class EnergyAwareLBCD(LBCDController):
    """LBCD with a second (energy) virtual queue.

    The energy price z(t) shrinks the effective budgets the allocator
    water-fills into: with objective V*A + z*(k_tx*b + k_c*c), marginal
    utility must exceed the energy price, which caps each server's fill
    where -dA/db == z*k_tx/(V/N). A ladder of budget scales realizes it
    with the production solver unchanged.
    """

    def __init__(self, system, energy: EnergyModel | None = None, **kw):
        super().__init__(system, **kw)
        self.energy = energy or EnergyModel()
        self.z_queue = VirtualQueue(p_min=0.0)      # reused as energy queue

    def _place(self):
        """``rollout_energy``'s placement: the device first-fit, or the
        controller's own host ``assign_fn`` around it."""
        if self.assign_fn is binpack.first_fit:
            return None

        def place(b, c, budgets_b, budgets_c):
            out = self.assign_fn(*(x.cpu().numpy()
                                   for x in (b, c, budgets_b, budgets_c)))
            return torch.as_tensor(np.asarray(out, np.int32),
                                   device=b.device)
        return place

    def _roll(self, tables: HorizonTables) -> RunSummary:
        """``rollout_energy`` over ``tables`` from the live queue states,
        which it advances. Records gain ``.power`` and ``.z``."""
        e = self.energy
        res, powers, zs = rollout_energy(
            tables, self.v, self.queue.p_min, e.kappa_tx, e.kappa_c,
            e.e_max, q0=self.queue.q, z0=self.z_queue.q,
            assign_fn=self._place(), **self._kw())
        self.queue.q = float(res.q[-1])
        self.z_queue.q = float(zs[-1])
        summary = summarize(res, self.v, self.queue.p_min)
        for rec, power, z in zip(summary.records, powers.cpu().numpy(),
                                 zs.cpu().numpy()):
            rec.power = float(power)
            rec.z = float(z)
        return summary

    def step(self, t: int, tables=None) -> SlotRecord:
        """Slot ``t``: the rollout over a one-slot horizon of ``tables``
        (default ``system.tables(t)``) and the slot's capacities."""
        budgets_b, budgets_c = self.system.capacities(t)
        tables = tables if tables is not None else self.system.tables(t)
        rec = self._roll(profiles.slot_horizon(tables, budgets_b, budgets_c,
                                               self.device)).records[0]
        rec.t = t
        return rec

    def run(self, n_slots: int, engine: str = "rollout") -> RunSummary:
        """Roll forward ``n_slots`` slots: ``engine="rollout"`` (default)
        over a pregenerated horizon on the device, ``engine="legacy"`` by
        ``step`` over the system's per-slot host profiles."""
        if engine != "rollout":
            records = [self.step(t) for t in range(n_slots)]
            return RunSummary(records, self.v, self.queue.p_min)
        return self._roll(self.system.horizon(n_slots, device=self.device))
