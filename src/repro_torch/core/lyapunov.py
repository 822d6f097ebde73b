"""Lyapunov framework for the long-term accuracy constraint (paper §V-A).

The virtual accuracy-debt queue ``q(t+1) = max(q(t) - Pbar_t + P_min, 0)``
(Eq. 44), the drift-plus-penalty objective of problem (P2) (Eq. 51), its
per-camera part, and the right-hand side of Lemma 1.
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


def per_camera_score(aopi, acc, q, V, n):
    """Separable per-camera part of Eq. (51): the configuration step of
    Algorithm 1 minimizes it camera by camera."""
    return (-q * acc + V * aopi) / n


def drift_bound(q, p_bar, p_min):
    """Right-hand side of Lemma 1, ``1/2 + q * (P_min - Pbar)``: the
    one-slot drift of ``q^2 / 2`` never exceeds it."""
    return 0.5 + q * (p_min - p_bar)
