"""repro_torch.scenarios — workload diversity at fleet scale.

The port of ``repro.scenarios``: the same registry of composable,
adversarial scenario generators (Markov-modulated channels, diurnal +
flash-crowd load, server outages, camera mobility, content bursts, fleet
churn, correlated fades), each emitting the port's
``profiles.HorizonTables`` on the chosen device, bitwise the reference's,
plus a sweep runner that executes LBCD/MIN/DOS/JCAB over a stacked suite
on one card.

Quickstart::

    from repro_torch import scenarios
    s = scenarios.suite(n_cameras=16, n_slots=60, n_servers=3)
    result = scenarios.sweep(s, v=10.0, p_min=0.7)
    print(scenarios.robustness(result))
"""
from . import generators  # noqa: F401  (populates the registry on import)
from .base import Components, ScenarioSpec, assemble
from .registry import (Suite, build, families, family_of, names, register,
                       spec_for, suite)
from .report import (DegradationReport, DegradedStats, FamilyStats,
                     RobustnessReport, degradation, robustness)
from .runner import BACKENDS, POLICIES, SweepResult, sweep

__all__ = [
    "Components", "ScenarioSpec", "assemble",
    "Suite", "build", "families", "family_of", "names", "register",
    "spec_for", "suite",
    "DegradationReport", "DegradedStats", "FamilyStats",
    "RobustnessReport", "degradation", "robustness",
    "BACKENDS", "POLICIES", "SweepResult", "sweep",
]
