"""Fleet sweep runner: all policies x all scenarios, on one card or many.

The port of ``repro.scenarios.runner``. ``sweep`` runs the LBCD controller
and the MIN/DOS/JCAB baselines over a stacked scenario axis (a
:class:`registry.Suite` or raw stacked ``HorizonTables``). Each scenario's
rollout is reduced on its device to per-slot fleet means (AoPI, accuracy,
queue), so the host only sees ``[K, T]`` summaries. Backends:

  loop       every scenario in turn on ``device``;
  shard_map  the scenario axis split over the ranks of a process group
             (each rank runs its block on its own card), padded by
             repeating the last scenario so K divides the ranks, the
             ``[K, T]`` series all-gathered;
  fleet      one block per device of ``devices``, every block launched
             before any is read.

Each scenario runs the same code on every backend, so all three give the
same series bitwise. ``backend=None`` picks ``"shard_map"`` when the
default group has two or more ranks, else ``"loop"``, as the reference
picks by its device count.
``dataplane=True`` also replays every cell through the GI/G/1 data plane
(``serving.replay.replay_suite``) for measured AoPI beside the closed form.

**The mask dispatch.** Stacking gives every scenario of a mixed suite an
``active`` mask, all ones where the scenario had none
(``profiles.stack_horizons``). The reference then runs every LBCD and MIN
solve of the sweep on its masked jnp path, since no kernel takes a mask.
Here a scenario whose mask is all ones reaches its rollout with
``active=None``, so it runs on the kernels; only a scenario with a real
churn mask (``camera_churn``, ``camera_churn_heavy``) takes the masked
path: the plain solves for LBCD and MIN, ``baseline_argmax`` with the mask
applied after the scan for DOS and JCAB. The fleet means still divide by
the live count wherever the suite carries a mask, as the reference's do.
``SweepResult.masked`` names the scenarios that took the masked path.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..core import baselines, lbcd, profiles
from ..core.profiles import HorizonTables
from ..device import DEFAULT_DEVICE, resolve_device
from .registry import Suite

POLICIES = ("lbcd", "min", "dos", "jcab")
BACKENDS = ("loop", "shard_map", "fleet")
SERIES = ("aopi", "acc", "q")


def divergence_series(measured: np.ndarray,
                      predicted: np.ndarray) -> np.ndarray:
    """Per-scenario relative divergence of horizon-mean measured vs
    predicted AoPI (``measured/predicted - 1`` over matched epochs).
    [K, T] x [K, T] -> [K]."""
    return (measured.mean(axis=1) /
            np.maximum(predicted.mean(axis=1), 1e-12) - 1.0)


@dataclasses.dataclass
class SweepResult:
    """Per-scenario per-policy slot series (fleet means) + metadata.

    ``aopi``/``acc``/``q`` map policy name -> ``[K, T]`` numpy arrays
    aligned with ``names``/``families``. ``masked`` lists the scenarios
    that carried a real churn mask and took the masked path. With
    ``dataplane=True``, ``measured_aopi`` holds the data-plane measurement
    per epoch (``[K, T_replay]``, possibly fewer slots than the closed-form
    series) and ``predicted_aopi`` the matching planner prediction, both
    for the *primary* (first) delay model; ``delay_models`` lists every
    replayed family and ``measured_by_model``/``predicted_by_model`` map
    model -> policy -> ``[K, T_replay]`` for all of them.
    """
    names: list[str]
    families: list[str]
    policies: list[str]
    v: float
    p_min: float
    backend: str
    aopi: dict[str, np.ndarray]
    acc: dict[str, np.ndarray]
    q: dict[str, np.ndarray]
    measured_aopi: dict[str, np.ndarray] | None = None
    predicted_aopi: dict[str, np.ndarray] | None = None
    delay_models: tuple[str, ...] | None = None
    measured_by_model: dict[str, dict[str, np.ndarray]] | None = None
    predicted_by_model: dict[str, dict[str, np.ndarray]] | None = None
    #: Engine-rung series of the primary delay model (replay with
    #: ``dataplane_params={"mode": "engine"}``): policy -> [K, T_replay].
    engine_aopi: dict[str, np.ndarray] | None = None
    engine_by_model: dict[str, dict[str, np.ndarray]] | None = None
    #: policy -> repr of the exception that killed its sweep (series
    #: NaN-filled), merged with the replay's per-cell errors under
    #: (scenario, policy) keys when dataplane=True.
    errors: dict = dataclasses.field(default_factory=dict)
    #: The primary-model replay's fault records (dataplane=True with a
    #: fault plan): policy -> [K] lists, as on ReplayResult.
    fallbacks: dict | None = None
    degraded: dict | None = None
    masked: list[str] = dataclasses.field(default_factory=list)

    def mean_aopi(self, policy: str) -> np.ndarray:
        """Per-scenario mean AoPI over the horizon. [K]"""
        return self.aopi[policy].mean(axis=1)

    def pct_aopi(self, policy: str, pct: float = 95.0) -> np.ndarray:
        """Per-scenario tail (percentile over slots) AoPI. [K]"""
        return np.percentile(self.aopi[policy], pct, axis=1)

    def worst_aopi(self, policy: str) -> np.ndarray:
        """Per-scenario worst slot AoPI. [K]"""
        return self.aopi[policy].max(axis=1)

    def mean_acc(self, policy: str) -> np.ndarray:
        return self.acc[policy].mean(axis=1)

    def divergence(self, policy: str,
                   delay_model: str | None = None) -> np.ndarray:
        """Per-scenario measured/predicted - 1 over the replayed epochs
        (requires ``dataplane=True``); ``delay_model=None`` is the primary
        model. [K]"""
        if self.measured_aopi is None:
            raise ValueError("sweep ran without dataplane=True; no "
                             "measured series to diverge against")
        if delay_model is None:
            return divergence_series(self.measured_aopi[policy],
                                     self.predicted_aopi[policy])
        if (self.measured_by_model is None
                or delay_model not in self.measured_by_model):
            raise ValueError(
                f"delay model {delay_model!r} was not replayed; "
                f"available: {self.delay_models}")
        return divergence_series(self.measured_by_model[delay_model][policy],
                                 self.predicted_by_model[delay_model][policy])


#: The keys ``dataplane_params`` takes (``serving.replay.replay_suite``'s).
DATAPLANE_PARAMS = frozenset({
    "n_epochs", "epoch_duration", "frames_cap", "seed", "plan_window",
    "telemetry_gain", "delay_model", "true_delay_model", "mode",
    "engine_params", "replan_threshold", "faults", "plan_retries",
    "plan_deadline"})


def scenario(tables: HorizonTables, k: int) -> HorizonTables:
    """Scenario ``k`` of a stacked horizon, with an all-ones mask dropped
    (``active=None``): the mask dispatch of the module docstring."""
    one = HorizonTables(**{
        f: None if getattr(tables, f) is None else getattr(tables, f)[k]
        for f in profiles.HORIZON_FIELDS})
    if one.active is not None and bool((one.active > 0).all()):
        one = dataclasses.replace(one, active=None)
    return one


def _rollout(name: str, tables: HorizonTables, v, p_min, params: dict,
             solver_backend: str, device):
    if name == "lbcd":
        return lbcd.rollout(tables, v, p_min, n_bcd_iters=params["iters"],
                            solver_backend=solver_backend, device=device)
    if name == "min":
        return baselines.rollout_min(tables, v, n_bcd_iters=params["iters"],
                                     solver_backend=solver_backend,
                                     device=device)
    if name == "dos":
        return baselines.rollout_dos(tables, params["dos_weight"],
                                     solver_backend=solver_backend,
                                     device=device)
    if name == "jcab":
        return baselines.rollout_jcab(tables, params["jcab_latency_cap"],
                                      solver_backend=solver_backend,
                                      device=device)
    raise ValueError(f"unknown policy {name!r}; known: {POLICIES}")


def _reduced(res, active) -> dict:
    """One rollout -> [T] fleet means on its device; under a suite mask
    the means divide by the live count, as the reference's
    ``_reduced_policy`` does."""
    if active is not None:
        n_live = torch.clamp_min(active.sum(dim=-1), 1.0)
        out = {"aopi": res.aopi.sum(dim=-1) / n_live,
               "acc": res.acc.sum(dim=-1) / n_live}
    else:
        out = {"aopi": res.aopi.mean(dim=-1), "acc": res.acc.mean(dim=-1)}
    out["q"] = res.q
    return out


def _block(name, tables: HorizonTables, ks, v, p_min, knobs,
           solver_backend, dev) -> dict:
    """The series of scenarios ``ks`` of ``tables``, each rolled on
    ``dev``: {key: [len(ks), T] tensors on ``dev``}. A card is made the
    current device for the block: the kernels launch on the current
    device's stream, and the plain solves' CUDA graphs capture there."""
    out = []
    guard = torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()
    with guard:
        for k in ks:
            one = scenario(tables, k).to(dev)
            active = None if tables.active is None \
                else tables.active[k].to(dev)
            out.append(_reduced(_rollout(name, one, v, p_min, knobs,
                                         solver_backend, dev), active))
        return {key: torch.stack([o[key] for o in out]) for key in SERIES}


def _host(series: dict) -> dict:
    return {k: x.cpu().numpy() for k, x in series.items()}


def _padded(n_scenarios: int, n_blocks: int) -> list:
    """The scenario index of each of the padded axis's entries, block
    after block: the last scenario repeated so n_blocks divides it."""
    n = -(-n_scenarios // n_blocks) * n_blocks
    return [min(i, n_scenarios - 1) for i in range(n)]


def _run_shard_map(name, tables, v, p_min, knobs, solver_backend, dev,
                   group) -> dict:
    """This rank's block of the padded scenario axis, then the [K, T]
    series all-gathered over ``group``. A rank whose block raises sends
    NaNs and a flag, so every rank reaches the gather and raises after
    it."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    n_scenarios, n_slots = int(tables.acc.shape[0]), int(tables.acc.shape[1])
    idx = _padded(n_scenarios, n)
    block = len(idx) // n
    try:
        mine = _block(name, tables, idx[rank * block:(rank + 1) * block],
                      v, p_min, knobs, solver_backend, dev)
        failed = None
    except Exception as e:  # noqa: BLE001 — re-raised after the gather
        mine = {k: torch.full((block, n_slots), float("nan"),
                              dtype=torch.float64, device=dev)
                for k in SERIES}
        failed = e
    from ..sharding import ctx
    flag = torch.tensor([float(failed is not None)], device=dev)
    dist.all_reduce(flag, group=group)
    ctx.count("all_reduce", flag)
    out = {}
    for key in SERIES:
        # In f64: every rank's series fit it exactly, whatever its dtype.
        x = mine[key].double().contiguous()
        full = x.new_empty((n * block,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(full, x, group=group)
        ctx.count("all_gather", full)
        out[key] = full.to(mine[key].dtype)[:n_scenarios]
    if failed is not None:
        raise failed
    if float(flag) > 0:
        raise RuntimeError(f"{name}: a block of the sweep failed on "
                           f"{int(float(flag))} rank(s)")
    return _host(out)


def _run_fleet(name, tables, v, p_min, knobs, solver_backend,
               devices) -> dict:
    """One block per device, every block launched before any is read."""
    n_scenarios = int(tables.acc.shape[0])
    idx = _padded(n_scenarios, len(devices))
    block = len(idx) // len(devices)
    pending = [_block(name, tables, idx[i * block:(i + 1) * block], v,
                      p_min, knobs, solver_backend, resolve_device(d))
               for i, d in enumerate(devices)]
    return {k: np.concatenate([x[k].cpu().numpy() for x in pending])[
        :n_scenarios] for k in SERIES}


def sweep(suite_or_tables: Suite | HorizonTables, v: float = 10.0,
          p_min: float = 0.7, policies: Sequence[str] = POLICIES,
          backend: str | None = None,
          policy_params: Mapping | None = None,
          solver_backend: str = "auto", dataplane: bool = False,
          dataplane_params: Mapping | None = None,
          device=DEFAULT_DEVICE, devices: Sequence | None = None,
          group=None) -> SweepResult:
    """Run every policy over every stacked scenario.

    ``backend``: ``"loop"`` on ``device``; ``"shard_map"`` over the ranks
    of ``group`` (the default group when None), each on its ``device``;
    ``"fleet"`` over ``devices`` (default ``[device]``); None picks as the
    module docstring says.
    ``solver_backend`` is the rollouts' (``"auto"``: the kernels on the
    card, the plain versions on the CPU; ``"torch"``: the plain versions;
    ``"cuda"`` refuses a suite with a churn mask, which no kernel takes).
    ``policy_params`` take ``n_bcd_iters``, ``dos_weight`` and
    ``jcab_latency_cap`` as in the reference. A policy that raises gets
    NaN series and its error in ``SweepResult.errors``; the others run on.

    ``dataplane=True`` replays every (policy, scenario) cell through the
    data plane (``serving.replay.replay_suite``) once per delay model of
    ``dataplane_params["delay_model"]`` (a name or a sequence; default
    "mm1"), with the other ``dataplane_params`` (``DATAPLANE_PARAMS``)
    passed on, and fills the data-plane fields of the result.
    """
    if backend is None:
        ranks = dist.get_world_size(group) if dist.is_initialized() else 1
        backend = "shard_map" if ranks > 1 else "loop"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    dp = dict(dataplane_params or {})
    unknown = sorted(set(dp) - DATAPLANE_PARAMS)
    if dataplane and unknown:
        raise ValueError(f"unknown dataplane_params {unknown}; "
                         f"known: {sorted(DATAPLANE_PARAMS)}")
    dev = resolve_device(device)
    if isinstance(suite_or_tables, Suite):
        tables = suite_or_tables.tables
        names = list(suite_or_tables.names)
        fams = list(suite_or_tables.families)
    else:
        tables = suite_or_tables
        if tables.acc.ndim != 5:
            raise ValueError(
                f"sweep() needs a *stacked* scenario axis (acc of rank 5, "
                f"[K, T, N, M, R]); got acc{tuple(tables.acc.shape)}. "
                f"Stack horizons with profiles.stack_horizons or pass a "
                f"scenarios.suite(...)")
        k = int(tables.acc.shape[0])
        names = [f"scenario_{i}" for i in range(k)]
        fams = ["unknown"] * k
    tables = tables.to(dev)
    n_scenarios, n_slots = int(tables.acc.shape[0]), int(tables.acc.shape[1])
    devices = [str(d) for d in (devices or [dev])]
    n_devices = {"loop": 1, "fleet": len(devices)}.get(backend) or \
        dist.get_world_size(group)
    tag = backend if backend == "loop" else f"{backend}[{n_devices}]"
    params = dict(policy_params or {})
    knobs = {"iters": int(params.get("n_bcd_iters", 4)),
             "dos_weight": float(params.get("dos_weight", 1.0)),
             "jcab_latency_cap": float(params.get("jcab_latency_cap", 0.5))}
    per_scenario = [scenario(tables, k) for k in range(n_scenarios)]
    masked = [names[k] for k, one in enumerate(per_scenario)
              if one.active is not None]

    series = {}
    errors: dict = {}
    for name in policies:
        if name not in POLICIES:
            raise ValueError(f"unknown policy {name!r}; known: {POLICIES}")
        # One span per policy: every scenario's rollout and the host copy
        # of its fleet means.
        try:
            with obs.span("sweep.policy", policy=name, backend=backend,
                          solver_backend=str(solver_backend),
                          n_scenarios=n_scenarios, n_devices=n_devices):
                if backend == "shard_map":
                    series[name] = _run_shard_map(
                        name, tables, v, p_min, knobs, solver_backend, dev,
                        group)
                elif backend == "fleet":
                    series[name] = _run_fleet(name, tables, v, p_min, knobs,
                                              solver_backend, devices)
                else:
                    series[name] = _host(_block(
                        name, tables, range(n_scenarios), v, p_min, knobs,
                        solver_backend, dev))
        except Exception as e:  # noqa: BLE001 — isolate the policy cell
            # One failing policy must not abort the whole sweep: record
            # the failure, NaN-fill its series, and keep sweeping.
            errors[name] = f"{type(e).__name__}: {e}"
            obs.event("sweep.policy_failed", policy=name, backend=backend)
            nan = np.full((n_scenarios, n_slots), np.nan)
            series[name] = {"aopi": nan, "acc": nan.copy(),
                            "q": np.full((n_scenarios, n_slots), np.nan)}
            continue
        if obs.enabled():
            # Per-(policy, family) AoPI histograms of the [T] fleet-mean
            # slot series of every scenario.
            for ki, fam in enumerate(fams):
                obs.histogram("sweep.aopi", policy=name, family=fam
                              ).observe_many(series[name]["aopi"][ki])

    res = SweepResult(
        names=names, families=fams, policies=list(policies),
        v=v, p_min=p_min, backend=tag,
        aopi={p: s["aopi"] for p, s in series.items()},
        acc={p: s["acc"] for p, s in series.items()},
        q={p: s["q"] for p, s in series.items()},
        errors=errors, masked=masked)
    if dataplane:
        _replay_cells(res, suite_or_tables, dp, policies, v, p_min,
                      policy_params, solver_backend, dev)
    return res


def _replay_cells(res: SweepResult, suite_or_tables, dp: dict, policies,
                  v, p_min, policy_params, solver_backend, dev) -> None:
    """``sweep``'s data-plane replay: one ``replay_suite`` per delay
    model, its series into ``res``."""
    # Imported here: serving imports this module.
    from ..serving import replay as _replay
    models = dp.get("delay_model", "mm1")
    if isinstance(models, str):
        models = (models,)
    res.delay_models = tuple(models)
    res.measured_by_model, res.predicted_by_model = {}, {}
    engine_by_model = {}
    for dm in res.delay_models:
        rres = _replay.replay_suite(
            suite_or_tables, policies=list(policies), v=v, p_min=p_min,
            policy_params=policy_params, solver_backend=solver_backend,
            n_epochs=dp.get("n_epochs"),
            epoch_duration=float(dp.get("epoch_duration", 300.0)),
            frames_cap=int(dp.get("frames_cap", 200_000)),
            seed=int(dp.get("seed", 0)),
            plan_window=dp.get("plan_window"),
            telemetry_gain=float(dp.get("telemetry_gain", 0.0)),
            delay_model=dm,
            true_delay_model=dp.get("true_delay_model"),
            mode=str(dp.get("mode", "mm1")),
            engine_params=dp.get("engine_params"),
            replan_threshold=dp.get("replan_threshold"),
            faults=dp.get("faults"),
            plan_retries=int(dp.get("plan_retries", 2)),
            plan_deadline=dp.get("plan_deadline"), device=dev)
        res.measured_by_model[dm] = rres.measured
        res.predicted_by_model[dm] = rres.predicted
        if rres.engine:
            engine_by_model[dm] = rres.engine
        if dm == res.delay_models[0]:
            res.fallbacks, res.degraded = rres.fallbacks, rres.degraded
            res.errors.update(rres.errors)
    res.measured_aopi = res.measured_by_model[res.delay_models[0]]
    res.predicted_aopi = res.predicted_by_model[res.delay_models[0]]
    res.engine_aopi = engine_by_model.get(res.delay_models[0])
    res.engine_by_model = engine_by_model or None
