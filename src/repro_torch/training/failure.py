"""Fault tolerance: straggler detection and island failover.

The paper's edge-server selection doubles as failover at pod scale: an
island (a model-parallel group of devices) that dies is an edge server
whose capacity dropped to zero, and LBCD's first-fit re-solve moves its
streams on the next controller epoch (Algorithm 2).

``StragglerMonitor`` is the step-time EWMA outlier detector of a training
loop: a worker whose mean step time exceeds the population's mean by
``k_sigma`` standard deviations is flagged; the response is first a
smaller microbatch share (``rebalance_weights``), then failover. All of it
runs on the host in numpy; the re-solve runs on the controller's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    """Per-worker EWMA step-time tracker."""
    n_workers: int
    alpha: float = 0.1
    k_sigma: float = 3.0
    warmup: int = 8

    def __post_init__(self):
        self.mean = np.zeros(self.n_workers)
        self.var = np.zeros(self.n_workers)
        self.count = 0

    def observe(self, step_times) -> np.ndarray:
        """Record one step's per-worker times; returns the bool straggler
        mask (all False during the first ``warmup`` steps)."""
        t = np.asarray(step_times, np.float64)
        if self.count == 0:
            self.mean[:] = t
        d = t - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.count += 1
        if self.count < self.warmup:
            return np.zeros(self.n_workers, bool)
        pop_mean = self.mean.mean()
        pop_std = max(np.sqrt(self.var.mean()), 1e-9)
        return self.mean > pop_mean + self.k_sigma * pop_std

    def rebalance_weights(self) -> np.ndarray:
        """Microbatch shares proportional to measured speed (1 / EWMA)."""
        inv = 1.0 / np.maximum(self.mean, 1e-9)
        return inv / inv.sum()


def fail_islands(budgets_b: np.ndarray, budgets_c: np.ndarray,
                 dead: np.ndarray):
    """The capacities with the dead islands' zeroed (float64 copies)."""
    b = np.asarray(budgets_b, np.float64).copy()
    c = np.asarray(budgets_c, np.float64).copy()
    b[dead] = 0.0
    c[dead] = 0.0
    return b, c


def failover_assignment(controller, t: int, dead: np.ndarray):
    """One controller epoch with the ``dead`` islands' capacities zeroed.

    ``controller`` is a ``repro_torch.core.lbcd.LBCDController``; its
    ``step(t)`` re-places the streams by first-fit (Algorithm 2) and
    re-solves Algorithm 1 on its device. The system's ``capacities`` is
    restored afterwards, also when the step raises. Returns the
    ``SlotRecord``."""
    sys = controller.system
    orig = sys.capacities

    def masked(tt):
        b, c = orig(tt)
        return fail_islands(b, c, dead)

    sys.capacities = masked
    try:
        rec = controller.step(t)
    finally:
        sys.capacities = orig
    assert not np.asarray(dead)[rec.assign].any(), \
        "failover left a stream on a dead island"
    return rec
