"""Scenario assembly: pure trace components -> ``HorizonTables``.

The port of ``repro.scenarios.base``: every component is host numpy,
drawn as the reference draws it, and :func:`assemble` casts it on the host
to the port's ``HorizonTables`` on ``device``, so the tables are bitwise
the reference's.

A scenario is a :class:`ScenarioSpec` (dimensions + seed + free-form
``params``) plus a *generator* — a pure function ``spec -> Components``
that produces the four time-varying ingredients of a horizon:

  bandwidth[T, S]   per-server bandwidth capacity trace (Hz)
  compute[T, S]     per-server compute capacity trace (FLOPS)
  snr_db[T, N]      per-camera uplink SNR path (dB)
  drift[T, N]       per-camera content-difficulty multiplier in (0, 1]

:func:`assemble` folds these with the model pool's accuracy/FLOPs profiles
into the same ``profiles.HorizonTables`` the rollouts consume
(``lbcd.rollout``, ``baselines.rollout_*``), with a time-varying
``eff[T, N]`` so SNR-mobility scenarios ride the unchanged rollouts.

Determinism: every random draw comes from ``rng(spec, tag)`` — a
``numpy`` Generator keyed by ``(spec.seed, crc32(spec.name), crc32(tag))``
— so the same registry name + seed rebuilds bitwise-identical tables, and
distinct components (bandwidth vs drift vs SNR) never share a stream.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core import profiles
from ..core.profiles import HorizonTables
from ..device import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Dimensions + seed + per-family knobs for one scenario instance."""
    name: str
    family: str
    n_cameras: int = 30
    n_servers: int = 3
    n_slots: int = 200
    mean_bandwidth_hz: float = 30e6
    mean_compute_flops: float = 50e12
    seed: int = 0
    pool: str = "paper"                  # "paper" | "lm"
    resolutions: Sequence[int] = profiles.RESOLUTIONS
    alpha: float = profiles.ALPHA_BITS_PER_PIXEL
    params: Mapping = dataclasses.field(default_factory=dict)

    def param(self, key: str, default):
        return self.params.get(key, default)

    def with_overrides(self, overrides: Mapping | None = None,
                       **kw) -> "ScenarioSpec":
        """New spec with field overrides; unknown keys land in ``params``."""
        merged = dict(overrides or {}, **kw)
        fields = {f.name for f in dataclasses.fields(ScenarioSpec)}
        field_kw = {k: v for k, v in merged.items()
                    if k in fields and k != "params"}
        params = dict(self.params)
        params.update({k: v for k, v in merged.items() if k not in fields})
        params.update(merged.get("params", {}))
        return dataclasses.replace(self, params=params, **field_kw)


@dataclasses.dataclass
class Components:
    """The four time-varying ingredients a generator emits (plus the
    optional fleet-churn mask of the ``camera_churn`` family)."""
    bandwidth: np.ndarray        # [T, S] Hz
    compute: np.ndarray          # [T, S] FLOPS
    snr_db: np.ndarray           # [T, N] dB
    drift: np.ndarray            # [T, N] in (0, 1]
    #: Optional [T, N] fleet mask (1 live / 0 churned out). ``None`` — the
    #: default for every non-churn family — assembles tables WITHOUT an
    #: ``active`` leaf, keeping existing scenarios bitwise unchanged.
    active: np.ndarray | None = None


def rng(spec: ScenarioSpec, tag: str) -> np.random.Generator:
    """Independent, reproducible stream per (scenario, component)."""
    return np.random.default_rng(
        [spec.seed, zlib.crc32(spec.name.encode()),
         zlib.crc32(tag.encode())])


# ---------------------------------------------------------------------------
# Shared building blocks (the EdgeSystem defaults, in pure form)
# ---------------------------------------------------------------------------

def default_capacity(spec: ScenarioSpec, mean: float, tag: str,
                     rho: float = 0.85, sigma: float = 0.25) -> np.ndarray:
    """The seed scenario family's lognormal AR(1) capacity trace [T, S]."""
    return profiles.lognormal_ar1_trace(
        rng(spec, tag), mean, (spec.n_slots, spec.n_servers),
        rho=rho, sigma=sigma)


def base_snr(spec: ScenarioSpec) -> np.ndarray:
    """Static per-camera SNR draw (12..22 dB), tiled to [T, N]."""
    snr0 = rng(spec, "snr0").uniform(12.0, 22.0, spec.n_cameras)
    return np.broadcast_to(snr0, (spec.n_slots, spec.n_cameras)).copy()


def base_drift(spec: ScenarioSpec) -> np.ndarray:
    """Mild clipped-AR(1) content drift [T, N] (the EdgeSystem default)."""
    return profiles.drift_path(
        int(rng(spec, "drift").integers(0, 2**31)),
        spec.n_slots, spec.n_cameras)


def default_components(spec: ScenarioSpec) -> Components:
    """The steady AR(1) world every family perturbs along one axis."""
    return Components(
        bandwidth=default_capacity(spec, spec.mean_bandwidth_hz, "bw"),
        compute=default_capacity(spec, spec.mean_compute_flops, "comp"),
        snr_db=base_snr(spec),
        drift=base_drift(spec))


def pool_for(spec: ScenarioSpec) -> list[profiles.ModelCandidate]:
    if spec.pool == "paper":
        return profiles.paper_pool()
    if spec.pool == "lm":
        return profiles.lm_pool()
    raise ValueError(f"unknown pool {spec.pool!r} (expected 'paper'|'lm')")


def assemble(spec: ScenarioSpec, comps: Components, dtype=torch.float32,
             device=DEFAULT_DEVICE) -> HorizonTables:
    """Fold components + model-pool profiles into one ``HorizonTables``.

    Mirrors ``EdgeSystem.horizon`` (per-camera difficulty baseline x drift
    x pool accuracy ladder), but with a time-varying ``eff[T, N]`` from the
    SNR path so mobility scenarios work with the unchanged rollouts. The
    tables land on ``device`` (default ``"cuda"``).
    """
    t_len, n = comps.snr_db.shape
    if comps.drift.shape != (t_len, n):
        raise ValueError(f"drift shape {comps.drift.shape} != snr shape "
                         f"{comps.snr_db.shape}")
    if comps.bandwidth.shape != (t_len, spec.n_servers):
        raise ValueError(f"bandwidth shape {comps.bandwidth.shape} != "
                         f"(T={t_len}, S={spec.n_servers})")
    if comps.compute.shape != (t_len, spec.n_servers):
        raise ValueError(f"compute shape {comps.compute.shape} != "
                         f"(T={t_len}, S={spec.n_servers})")
    if comps.active is not None and comps.active.shape != (t_len, n):
        raise ValueError(f"active shape {comps.active.shape} != "
                         f"(T={t_len}, N={n})")
    pool = pool_for(spec)
    res = np.asarray(spec.resolutions, np.float64)
    difficulty = rng(spec, "difficulty").uniform(0.88, 1.0, n)
    zr = np.stack([m.zeta(res) for m in pool])              # [M, R]
    xi = np.stack([m.xi(res) for m in pool])                # [M, R]
    acc = (difficulty[None, :] * comps.drift)[:, :, None, None] * \
        zr[None, None, :, :]                                # [T, N, M, R]
    fields = dict(acc=np.clip(acc, 1e-3, 1.0), xi=xi,
                  size=spec.alpha * res**2,
                  eff=profiles.shannon_efficiency(comps.snr_db),
                  budgets_b=comps.bandwidth, budgets_c=comps.compute,
                  active=comps.active)
    return profiles.horizon_from_numpy(fields, device, dtype=dtype)
