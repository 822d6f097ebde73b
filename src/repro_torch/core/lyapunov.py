"""Lyapunov framework for the long-term accuracy constraint (paper §V-A).

The virtual accuracy-debt queue ``q(t+1) = max(q(t) - Pbar_t + P_min, 0)``
(Eq. 44) and the drift-plus-penalty objective of problem (P2) (Eq. 51).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class VirtualQueue:
    """Host-side accuracy-debt queue q(t) (Eq. 44)."""
    p_min: float
    q: float = 0.0

    def update(self, p_bar: float) -> float:
        self.q = max(self.q - float(p_bar) + self.p_min, 0.0)
        return self.q


def queue_update(q, p_bar, p_min):
    """Tensor form of Eq. 44 (no host synchronisation)."""
    return torch.clamp_min(q - p_bar + p_min, 0.0)


def drift_plus_penalty(aopi, acc, q, V):
    """Per-slot objective of problem (P2), Eq. (51)."""
    return -q * torch.mean(acc) + V * torch.mean(aopi)
