"""The scenario families: adversarial/diverse dynamics for the suite.

The port of ``repro.scenarios.generators``, unchanged: host numpy from the
same streams, so every component is bitwise the reference's.

Each generator is a pure function ``ScenarioSpec -> Components`` registered
under a family name. All start from the steady AR(1) world
(``base.default_components`` — the seed ``EdgeSystem`` scenario) and
perturb one axis, so sweeps isolate which *kind* of dynamics breaks a
policy:

  steady_ar1       the seed world — lognormal AR(1) capacity, mild drift;
  gilbert_elliott  Markov-modulated (good/bad) bandwidth channels, the
                   classic bursty-wireless model;
  diurnal_flash    diurnal sinusoid capacity + flash-crowd depressions
                   (background load spikes steal backhaul and compute);
  server_outage    per-server hard-degradation windows (failures/maintenance);
  snr_mobility     per-camera random-walk SNR with handover jumps
                   (time-varying link efficiency);
  content_burst    content-difficulty bursts (scene changes crush accuracy,
                   then recover);
  camera_churn     fleet churn — cameras leave/join mid-horizon via the
                   ``active[T, N]`` mask (``repro_torch.faults`` Markov chain);
  correlated_fade  correlated multi-server bandwidth fades (one shared
                   shock + idiosyncratic noise), generalizing
                   server_outage beyond independent single-server windows.

Knobs ride ``spec.params`` with the defaults below; ``registry.build``
merges per-call overrides in.
"""
from __future__ import annotations

import numpy as np

from ..faults import FaultPlan, FaultSpec
from .base import (Components, ScenarioSpec, base_drift, base_snr,
                   default_capacity, default_components, rng)
from .registry import register


@register("steady_ar1", family="steady")
def steady_ar1(spec: ScenarioSpec) -> Components:
    """The seed EdgeSystem world, unperturbed (calibration anchor)."""
    return default_components(spec)


def _gilbert_elliott_states(spec: ScenarioSpec, p_gb: float,
                            p_bg: float) -> np.ndarray:
    """Two-state Markov chain per server: 1 = good, 0 = bad. [T, S]."""
    u = rng(spec, "ge_chain").uniform(size=(spec.n_slots, spec.n_servers))
    state = np.ones(spec.n_servers, bool)
    out = np.empty((spec.n_slots, spec.n_servers), bool)
    for t in range(spec.n_slots):
        flip = np.where(state, u[t] < p_gb, u[t] < p_bg)
        state = state ^ flip
        out[t] = state
    return out


@register("gilbert_elliott", family="gilbert_elliott")
@register("gilbert_elliott_harsh", family="gilbert_elliott",
          p_gb=0.15, p_bg=0.12, bad_gain=0.15)
def gilbert_elliott(spec: ScenarioSpec) -> Components:
    """Markov-modulated bandwidth: each server's backhaul flips between a
    good state (~``good_gain`` x mean) and a deep-fade bad state
    (~``bad_gain`` x mean), with small AR(1) jitter on top."""
    p_gb = spec.param("p_gb", 0.08)          # good -> bad per slot
    p_bg = spec.param("p_bg", 0.25)          # bad -> good per slot
    good = spec.param("good_gain", 1.15)
    bad = spec.param("bad_gain", 0.30)
    states = _gilbert_elliott_states(spec, p_gb, p_bg)
    gain = np.where(states, good, bad)
    jitter = default_capacity(spec, 1.0, "ge_jitter", rho=0.6, sigma=0.08)
    return Components(
        bandwidth=spec.mean_bandwidth_hz * gain * jitter,
        compute=default_capacity(spec, spec.mean_compute_flops, "comp"),
        snr_db=base_snr(spec),
        drift=base_drift(spec))


@register("diurnal_flash", family="diurnal_flash")
def diurnal_flash(spec: ScenarioSpec) -> Components:
    """Diurnal sinusoid on both capacities + flash-crowd windows where
    background demand steals a ``flash_depth`` fraction of capacity, with
    linear recovery over ``flash_len`` slots."""
    period = spec.param("period", 96)
    amp = spec.param("amp", 0.35)
    n_flash = spec.param("n_flash", 3)
    depth = spec.param("flash_depth", 0.55)
    length = spec.param("flash_len", 8)
    comps = default_components(spec)
    r = rng(spec, "flash")
    phase = r.uniform(0.0, 2 * np.pi, spec.n_servers)
    t = np.arange(spec.n_slots)[:, None]
    diurnal = 1.0 + amp * np.sin(2 * np.pi * t / period + phase[None, :])
    env = np.ones(spec.n_slots)
    for t0 in r.integers(0, max(spec.n_slots - length, 1), n_flash):
        dip = 1.0 - depth * (1.0 - np.arange(length) / length)
        env[t0:t0 + length] = np.minimum(env[t0:t0 + length],
                                         dip[:spec.n_slots - t0])
    shape = diurnal * env[:, None]
    comps.bandwidth = comps.bandwidth * shape
    comps.compute = comps.compute * shape
    return comps


@register("server_outage", family="server_outage")
def server_outage(spec: ScenarioSpec) -> Components:
    """Per-server outage/degradation windows: a random server keeps only a
    ``degrade`` fraction of both capacities for ``outage_len`` slots
    (floored at 1e-6 x mean so allocators never see a zero budget)."""
    n_outages = spec.param("n_outages", 2)
    length = spec.param("outage_len", 12)
    degrade = spec.param("degrade", 0.05)
    comps = default_components(spec)
    r = rng(spec, "outage")
    factor = np.ones((spec.n_slots, spec.n_servers))
    for _ in range(n_outages):
        s = int(r.integers(0, spec.n_servers))
        t0 = int(r.integers(0, max(spec.n_slots - length, 1)))
        factor[t0:t0 + length, s] = degrade
    comps.bandwidth = np.maximum(comps.bandwidth * factor,
                                 spec.mean_bandwidth_hz * 1e-6)
    comps.compute = np.maximum(comps.compute * factor,
                               spec.mean_compute_flops * 1e-6)
    return comps


@register("snr_mobility", family="snr_mobility")
def snr_mobility(spec: ScenarioSpec) -> Components:
    """Camera mobility: per-camera SNR random walk (``walk_sigma`` dB/slot)
    with Bernoulli handover jumps of +-``handover_jump`` dB, clipped to
    [``snr_lo``, ``snr_hi``] — a time-varying ``eff[t, n]``."""
    walk = spec.param("walk_sigma", 0.4)
    rate = spec.param("handover_rate", 0.02)
    jump = spec.param("handover_jump", 6.0)
    lo = spec.param("snr_lo", 5.0)
    hi = spec.param("snr_hi", 25.0)
    r = rng(spec, "mobility")
    steps = r.normal(0.0, walk, (spec.n_slots, spec.n_cameras))
    jumps = (r.uniform(size=(spec.n_slots, spec.n_cameras)) < rate)
    signs = np.where(r.uniform(size=jumps.shape) < 0.5, -1.0, 1.0)
    snr = np.empty((spec.n_slots, spec.n_cameras))
    # same "snr0" stream as base_snr, so the walk starts from the static
    # draw the other families use
    state = rng(spec, "snr0").uniform(12.0, 22.0, spec.n_cameras)
    for t in range(spec.n_slots):
        state = np.clip(state + steps[t] + jump * jumps[t] * signs[t],
                        lo, hi)
        snr[t] = state
    return Components(
        bandwidth=default_capacity(spec, spec.mean_bandwidth_hz, "bw"),
        compute=default_capacity(spec, spec.mean_compute_flops, "comp"),
        snr_db=snr,
        drift=base_drift(spec))


@register("content_burst", family="content_burst")
def content_burst(spec: ScenarioSpec) -> Components:
    """Content-difficulty bursts: scene changes drop the per-camera drift
    multiplier by ``burst_depth`` and recover linearly over ``burst_len``
    slots, on top of the mild baseline drift."""
    n_bursts = spec.param("n_bursts",
                          max(3, spec.n_slots * spec.n_cameras // 400))
    depth = spec.param("burst_depth", 0.45)
    length = spec.param("burst_len", 12)
    comps = default_components(spec)
    r = rng(spec, "burst")
    env = np.ones((spec.n_slots, spec.n_cameras))
    t0s = r.integers(0, max(spec.n_slots - 1, 1), n_bursts)
    cams = r.integers(0, spec.n_cameras, n_bursts)
    ramp = 1.0 - depth * (1.0 - np.arange(length) / length)
    for t0, cam in zip(t0s, cams):
        seg = min(length, spec.n_slots - t0)
        env[t0:t0 + seg, cam] = np.minimum(env[t0:t0 + seg, cam],
                                           ramp[:seg])
    comps.drift = np.clip(comps.drift * env, 0.05, 1.0)
    return comps


@register("camera_churn", family="camera_churn")
@register("camera_churn_heavy", family="camera_churn",
          churn_fraction=0.6, leave_prob=0.15, join_prob=0.15)
def camera_churn(spec: ScenarioSpec) -> Components:
    """Fleet churn: cameras leave and rejoin mid-horizon.

    The steady AR(1) world plus an ``active[T, N]`` mask from the
    ``repro_torch.faults`` churn chain — at ``churn_t0`` a
    ``churn_fraction`` of the fleet drops out, then per slot live cameras leave w.p.
    ``leave_prob`` and dead ones rejoin w.p. ``join_prob`` (at least one
    camera is always live). Inactive cameras get exactly zero allocation;
    their bandwidth/compute shares water-fill to the survivors.
    """
    comps = default_components(spec)
    plan = FaultPlan(
        (FaultSpec(
            "camera_churn",
            t0=int(spec.param("churn_t0", max(1, spec.n_slots // 10))),
            duration=spec.param("churn_len", None),
            params={"fraction": spec.param("churn_fraction", 0.3),
                    "leave_prob": spec.param("leave_prob", 0.05),
                    "join_prob": spec.param("join_prob", 0.1)}),),
        seed=int(rng(spec, "churn").integers(2**31)))
    comps.active = plan.camera_active(spec.n_slots, spec.n_cameras)
    return comps


@register("correlated_fade", family="correlated_fade")
@register("correlated_fade_deep", family="correlated_fade",
          fade_depth=0.85, fade_corr=0.95)
def correlated_fade(spec: ScenarioSpec) -> Components:
    """Correlated multi-server bandwidth fades (generalizing
    ``server_outage``): a shared Gaussian shock plus per-server noise,
    mixed by ``fade_corr`` and squashed into ``(1 - fade_depth, 1)``,
    multiplies the backhaul of a ``fade_fraction`` of servers at once —
    the weather-front / backhaul-congestion regime where per-server
    independence assumptions fail. Floored at 1e-6 x mean like
    ``server_outage`` so allocators never see a zero budget.
    """
    comps = default_components(spec)
    plan = FaultPlan(
        (FaultSpec(
            "correlated_fade",
            t0=int(spec.param("fade_t0", 0)),
            duration=spec.param("fade_len", None),
            params={"fraction": spec.param("fade_fraction", 1.0),
                    "depth": spec.param("fade_depth", 0.6),
                    "corr": spec.param("fade_corr", 0.8)}),),
        seed=int(rng(spec, "fade").integers(2**31)))
    factor = plan.capacity_factor(spec.n_slots, spec.n_servers)
    comps.bandwidth = np.maximum(comps.bandwidth * factor,
                                 spec.mean_bandwidth_hz * 1e-6)
    return comps
