"""Scenario registry: named generators -> built horizons -> stacked suites.

The port of ``repro.scenarios.registry``; ``build`` and ``suite`` take
``device=`` (default ``"cuda"``).

  register(name, family=..., **defaults)   decorator used by generators.py
  names() / families()                     what is registered
  spec_for(name, overrides)                the resolved ScenarioSpec
  build(name, overrides)                   one ``HorizonTables``
  suite(names=None, ...)                   a :class:`Suite` — all (or the
                                           named) scenarios built with
                                           shared dimensions and stacked
                                           via ``profiles.stack_horizons``
                                           for ``runner.sweep``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from ..core import profiles
from ..core.profiles import HorizonTables
from ..device import DEFAULT_DEVICE
from .base import Components, ScenarioSpec, assemble

_REGISTRY: dict[str, tuple[Callable[[ScenarioSpec], Components],
                           str, dict]] = {}


def register(name: str, family: str | None = None, **defaults):
    """Register ``fn(spec) -> Components`` under ``name``; stackable to
    register one generator under several names with different defaults."""
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = (fn, family or name, dict(defaults))
        return fn
    return deco


def _ensure_loaded() -> None:
    if not _REGISTRY:                     # pragma: no cover - import order
        from . import generators          # noqa: F401  (registers on import)


def names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def families() -> list[str]:
    _ensure_loaded()
    return sorted({fam for _, fam, _ in _REGISTRY.values()})


def family_of(name: str) -> str:
    _ensure_loaded()
    return _REGISTRY[name][1]


def spec_for(name: str, overrides: Mapping | None = None,
             **kw) -> ScenarioSpec:
    """The fully-resolved spec ``build(name, ...)`` would use."""
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; registered: {names()}")
    _, family, defaults = _REGISTRY[name]
    spec = ScenarioSpec(name=name, family=family, params=dict(defaults))
    return spec.with_overrides(overrides, **kw)


def build(name: str, overrides: Mapping | None = None, *,
          device=DEFAULT_DEVICE, **kw) -> HorizonTables:
    """Build one scenario's ``HorizonTables``.

    ``overrides``/keyword args may set any ``ScenarioSpec`` field
    (``n_cameras``, ``n_slots``, ``seed``, ...); unknown keys become
    generator params (e.g. ``flash_depth``). Deterministic: the same
    ``(name, overrides)`` rebuilds bitwise-identical tables, on
    ``device``.
    """
    spec = spec_for(name, overrides, **kw)
    fn = _REGISTRY[name][0]
    return assemble(spec, fn(spec), device=device)


@dataclasses.dataclass
class Suite:
    """A stacked scenario suite: ``tables`` has a leading scenario axis K
    aligned with ``names``/``families``."""
    tables: HorizonTables
    names: list[str]
    families: list[str]
    specs: list[ScenarioSpec]

    @property
    def n_scenarios(self) -> int:
        return len(self.names)


def suite(scenario_names: Sequence[str] | None = None,
          overrides: Mapping | None = None, *, device=DEFAULT_DEVICE,
          **kw) -> Suite:
    """Build every (or the named) registered scenario with shared
    dimensions on ``device`` and stack them for one sweep. As in the
    reference, a suite in which any scenario carries a churn mask gives
    every scenario one (all ones where it had none)."""
    scenario_names = list(scenario_names or names())
    specs = [spec_for(n, overrides, **kw) for n in scenario_names]
    tables = [build(n, overrides, device=device, **kw)
              for n in scenario_names]
    return Suite(tables=profiles.stack_horizons(tables),
                 names=scenario_names,
                 families=[s.family for s in specs],
                 specs=specs)
