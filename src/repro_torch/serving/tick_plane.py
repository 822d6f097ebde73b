"""Tick-scan engine plane: the engine rung as one scan over decode ticks
(the port of the JAX package's ``serving/tick_plane.py``).

The DES of ``engine_plane`` replays the real continuous-batching Engine
event by event. Because it pins one lane per stream, lanes never contend,
and the whole DES (admit, batched decode ticks, LCFSP preemption with
version invalidation, FCFS backlog, epoch-end drain, ``h_eff``
truncation) collapses to per-lane recurrences that one scan over ticks
(one tick per frame index, every lane advanced together) replays bitwise:

  * the same pre-drawn T/O/coin streams (``engine_plane.draw_streams``);
  * FCFS service start is the sequential ``max(a_k, fin_{k-1})`` in
    float64, the float chain the DES heap produces;
  * LCFSP completion wins time ties with the next arrival
    (``fin <= a_next``), as the DES pops the completion first; a
    preemption counts iff the next arrival was scheduled (``a_k <= h_eff``)
    and strictly beats the finish;
  * the carry (service-finish front, last-update time, sampled age, the
    counts, busy time) is the DES's bookkeeping, vectorised over lanes;
  * the age-area terms are added per tick in the DES's event order,
    ``area = area + (age0*seg + 0.5*seg*seg)``, each product rounded on
    its own (the JAX package emits the terms and sums them on the host
    because XLA would fuse a multiply-add there; here every operation
    rounds on its own on both paths, so the carry sums them in place).

On the card the scan is one ``tick_scan`` kernel launch
(``kernels/dataplane``); on the CPU the plain ``_tick_scan``, a Python
loop over ticks vectorised over the lanes, runs (and is the kernel's
twin). Both equal the DES bitwise on what it counts inside the effective
horizon (``aopi``/``n_frames``/``n_completed``/``n_accurate``/
``preempts`` and the (stream, frame, completion time) trace). The stub
model's token arithmetic is not replayed. The draws are host numpy
(one stream at a time) and move to the card once per window; the drain
segment and the final division are host numpy, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import obs
from ..core import queues
from ..device import DEFAULT_DEVICE, resolve_device
from . import engine_plane

#: Engine-rung backends: "des" replays the real Engine event by event,
#: "scan" runs this module's scan, "auto" keeps the DES at small scale.
ENGINE_BACKENDS = ("des", "scan", "auto")

#: "auto" keeps the DES while ``n_streams * frames_cap`` is at most this
#: many frame events per epoch, and switches to the scan above it.
AUTO_DES_MAX_FRAMES = 4096


def resolve_engine_backend(backend: str, *, n_streams: int,
                           frames_cap: int) -> str:
    """Validate ``backend`` and resolve ``"auto"`` by epoch frame volume."""
    if backend not in ENGINE_BACKENDS:
        raise ValueError(
            f"unknown engine_backend {backend!r}; known: {ENGINE_BACKENDS}")
    if backend != "auto":
        return backend
    return ("des" if int(n_streams) * int(frames_cap) <= AUTO_DES_MAX_FRAMES
            else "scan")


def _tick_scan(T, O, coin, p, is_lcfsp, live, epoch: float,
               collect_trace: bool = False) -> dict:
    """The plain scan: every lane's epoch over its ticks. ``T``/``O``/
    ``coin`` ``[S, F]`` float64 host draws, ``p`` ``[S]`` float64,
    ``is_lcfsp``/``live`` ``[S]`` bool. A first loop sums ``T`` in order
    (``np.cumsum``'s last element) for the effective horizon. Returns the
    final lane state ``[S]`` (``h_eff``, ``last_t``, ``age0``, ``area``,
    the counts and ``busy``) and, under ``collect_trace``, ``fin`` and
    ``done`` ``[F, S]``."""
    s, f = T.shape
    zero = torch.zeros(s, dtype=T.dtype, device=T.device)
    inf = torch.full_like(zero, math.inf)
    total = zero
    for k in range(f):
        total = total + T[:, k]
    h_eff = torch.where(live, torch.minimum(torch.full_like(zero, epoch),
                                            total), zero)
    a = fin_prev = last_t = age0 = area = zero
    n_arr = n_done = n_acc = n_pre = busy = zero
    fins, dones = [], []
    for k in range(f):
        tk, ok, uk = T[:, k], O[:, k], coin[:, k]
        a = a + tk                                # a_k; gen_k = a_k - T_k
        nk = a + T[:, k + 1] if k + 1 < f else inf
        gen = a - tk
        # FCFS seizes at arrival or queues behind the finish front;
        # LCFSP always seizes at arrival (preempting the front).
        start = torch.where(is_lcfsp, a, torch.maximum(a, fin_prev))
        fin = start + ok
        arrived = a <= h_eff
        completed = torch.where(is_lcfsp, fin <= nk, True)
        preempted = is_lcfsp & (fin > nk) & arrived
        done = completed & (fin <= h_eff) & live
        valid = done & (uk < p)
        seg = torch.where(valid, fin - last_t, zero)
        t1 = age0 * seg
        t2 = 0.5 * seg * seg
        area = area + (t1 + t2)
        # Busy time: service from its start to its finish, or to the
        # preempting arrival under LCFSP, clipped to the horizon.
        nxt_gate = torch.where(arrived, nk, inf)
        end_s = torch.where(is_lcfsp, torch.minimum(fin, nxt_gate), fin)
        busy_seg = torch.maximum(torch.minimum(end_s, h_eff)
                                 - torch.minimum(start, h_eff), zero)
        fin_prev = fin
        last_t = torch.where(valid, fin, last_t)
        age0 = torch.where(valid, fin - gen, age0)
        n_arr = n_arr + arrived
        n_done = n_done + done
        n_acc = n_acc + valid
        n_pre = n_pre + preempted
        busy = busy + busy_seg
        if collect_trace:
            fins.append(fin)
            dones.append(done)
    out = {"h_eff": h_eff, "last_t": last_t, "age0": age0, "area": area,
           "n_frames": n_arr, "n_completed": n_done, "n_accurate": n_acc,
           "preempts": n_pre, "busy": busy}
    if collect_trace:
        out["fin"] = torch.stack(fins)
        out["done"] = torch.stack(dones)
    return out


def measure_engine_window_scan(lam, mu, p, pol, *, epoch_duration: float,
                               seed: int = 0, t0: int = 0,
                               delay_model: str = "mm1", active=None,
                               frames_cap: int =
                               engine_plane.ENGINE_FRAMES_CAP,
                               collect_samples: int = 0,
                               collect_trace: bool = False,
                               device=DEFAULT_DEVICE) -> dict:
    """Replay ``[E, N]`` engine epochs as one scan on ``device``.

    Each (epoch ``t0+e``, stream ``i``) lane replays the process the DES
    would run for that epoch (the same ``stream_seed_sequence(seed, t0+e,
    i)`` draws). Returns the ``gi_g1_window``-shaped stat dict (``[E, N]``
    values) plus ``preempts``/``occupancy`` ``[E, N]``, scalar
    ``engine_steps`` (ticks), optional ``delay_samples`` ``[E, N,
    collect_samples]`` and, under ``collect_trace``, ``trace``: ``(epoch,
    stream, frame, t_done)`` completion events in ``(t_done, stream,
    frame)`` order per epoch.
    """
    from ..kernels.dataplane import ops
    queues.validate_delay_model(delay_model)
    dev = resolve_device(device)
    lam = np.atleast_2d(np.asarray(lam, np.float64))
    mu = np.atleast_2d(np.asarray(mu, np.float64))
    p = np.clip(np.atleast_2d(np.asarray(p, np.float64)), 1e-3, 1.0)
    pol = np.atleast_2d(np.asarray(pol, np.int64))
    e, n = lam.shape
    live = (lam > 0.0) & (mu > 0.0)
    if active is not None:
        live = live & (np.atleast_2d(np.asarray(active, np.float64)) > 0.0)
    f = int(frames_cap)
    s = e * n
    T = np.zeros((s, f))
    O = np.zeros((s, f))
    coin = np.ones((s, f))
    for ei in range(e):
        Te, Oe, Ce = engine_plane.draw_streams(
            lam[ei], mu[ei], live[ei], delay_model=delay_model,
            seed=seed, t=t0 + ei, frames_cap=f)
        T[ei * n:(ei + 1) * n] = Te
        O[ei * n:(ei + 1) * n] = Oe
        coin[ei * n:(ei + 1) * n] = Ce
    live_f = live.ravel()

    with obs.span("tick_plane.window", delay_model=delay_model,
                  epochs=e, streams=n, n_frames=f):
        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        res = ops.tick_scan(put(T), put(O), put(coin), put(p.ravel()),
                            put(pol.ravel() == 1), put(live_f), epoch_duration,
                            collect_trace=collect_trace)
        # One transfer per window: the final lane state (and the trace).
        res = {k: v.cpu().numpy() for k, v in res.items()}

    h_eff = res["h_eff"]
    last_t, age0, area = res["last_t"], res["age0"], res["area"]
    seg = np.maximum(h_eff - last_t, 0.0)             # DES drain point
    area = area + (age0 * seg + 0.5 * seg * seg)
    safe_h = np.maximum(h_eff, 1e-12)
    out = {"aopi": np.where(live_f, area / safe_h, 0.0)}
    for key in ("n_frames", "n_completed", "n_accurate", "preempts"):
        out[key] = np.where(live_f, res[key], 0.0)
    out["occupancy"] = np.where(live_f, res["busy"] / safe_h, 0.0)
    occ = out["occupancy"][live_f]
    out = {k: np.asarray(v, np.float64).reshape(e, n)
           for k, v in out.items()}
    out["horizon"] = h_eff.reshape(e, n)
    out["engine_steps"] = float(f)
    if collect_samples:
        cap = min(int(collect_samples), f)
        out["delay_samples"] = np.where(
            live_f[:, None], T[:, :cap], 0.0).reshape(e, n, cap)
    if collect_trace:
        fin, done = res["fin"], res["done"]              # [F, S]
        kk, ss = np.nonzero(done)
        ev = zip((ss // n).tolist(), (ss % n).tolist(), kk.tolist(),
                 fin[kk, ss].tolist())
        out["trace"] = sorted(ev, key=lambda r: (r[0], r[3], r[1], r[2]))
    obs.counter("engine.ticks", backend="scan",
                delay_model=delay_model).inc(float(f))
    obs.counter("engine.preempts", backend="scan").inc(
        float(out["preempts"].sum()))
    if occ.size:
        obs.histogram("engine.occupancy", backend="scan").observe_many(occ)
    return out


def measure_engine_epoch_scan(lam, mu, p, pol, *, epoch_duration: float,
                              seed: int = 0, t: int = 0,
                              delay_model: str = "mm1", active=None,
                              frames_cap: int =
                              engine_plane.ENGINE_FRAMES_CAP,
                              collect_samples: int = 0,
                              collect_trace: bool = False,
                              device=DEFAULT_DEVICE) -> dict:
    """Single-epoch tick scan: the batched equivalent of
    ``engine_plane.measure_engine_epoch`` (the same ``[N]`` stat dict, the
    same draws, bitwise-identical counted statistics, no Engine)."""
    out = measure_engine_window_scan(
        np.asarray(lam, np.float64).ravel()[None, :],
        np.asarray(mu, np.float64).ravel()[None, :],
        np.asarray(p, np.float64).ravel()[None, :],
        np.asarray(pol, np.int64).ravel()[None, :],
        epoch_duration=epoch_duration, seed=seed, t0=t,
        delay_model=delay_model,
        active=None if active is None
        else np.asarray(active, np.float64).ravel()[None, :],
        frames_cap=frames_cap, collect_samples=collect_samples,
        collect_trace=collect_trace, device=device)
    trace = out.pop("trace", None)
    steps = out.pop("engine_steps")
    out = {k: v[0] for k, v in out.items()}
    out["engine_steps"] = steps
    if trace is not None:
        out["trace"] = [(i, k, td) for _, i, k, td in trace]
    return out


def measure_epoch(lam, mu, p, pol, *, backend: str = "auto", engine=None,
                  frames_cap: int = engine_plane.ENGINE_FRAMES_CAP,
                  device=DEFAULT_DEVICE, **kw) -> dict:
    """Engine-rung epoch on the backend ``backend`` resolves to: the DES
    on ``engine`` (required for ``"des"``) or the tick scan on
    ``device``. Both return the same stat dict over the same draws."""
    n = np.asarray(lam).ravel().size
    resolved = resolve_engine_backend(backend, n_streams=n,
                                      frames_cap=frames_cap)
    if resolved == "scan":
        return measure_engine_epoch_scan(lam, mu, p, pol,
                                         frames_cap=frames_cap,
                                         device=device, **kw)
    if engine is None:
        raise ValueError("engine_backend 'des' needs an Engine instance "
                         "(make_replay_engine)")
    return engine_plane.measure_engine_epoch(engine, lam, mu, p, pol,
                                             frames_cap=frames_cap, **kw)
