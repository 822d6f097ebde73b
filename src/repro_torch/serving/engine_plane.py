"""Engine-rung measurement plane: the real continuous-batching Engine
driven by a discrete-event replay of the paper's frame-uploading model
(the port of the JAX package's ``serving/engine_plane.py``).

Per stream, transmission and service delays are pre-drawn from the
configured ``delay_model`` family under the collision-free
``stream_seed_sequence(seed, t, i)`` streams, and one host event loop
replays them against a live :class:`~.engine.Engine`:

  * every frame is actually admitted (a prefill into its pinned lane),
    decoded by batched ``decode_tick`` steps across all busy lanes, and
    preempted by real ``preempt_stream`` calls on LCFSP arrivals;
  * frame timing comes from the sampled draws (virtual completion = admit
    time + sampled service), not from the model's FLOPs.

Each stream owns one lane (``n_lanes >= n_streams``), so every stream is a
single-server GI/G/1 system: FCFS queues pending frames, LCFSP preempts
the in-flight frame on arrival. The age integral is truncated at the
per-stream horizon ``min(epoch, last arrival)``. Epoch end drains every
in-flight lane, so a stream that churns out between epochs leaks no lane.

The draws and the event loop are host numpy, the same as the JAX
package's, so the returned statistics equal its exactly; only the engine
under them runs on the card. Each epoch bumps the reference's four obs
series (``engine_plane.epochs``, ``engine_plane.frames``, ``engine.ticks``
and ``engine.preempts``) with the same labels and values.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Optional

import numpy as np

from .. import obs
from ..core import queues
from .engine import DECODING, Engine
from .scheduler import Frame

ARRIVAL, COMPLETION = 0, 1

#: Default per-stream frame budget for engine replay. Real admits are
#: ~3 orders of magnitude costlier than the batched plane's scan steps;
#: the h_eff truncation keeps a capped window unbiased (just shorter).
ENGINE_FRAMES_CAP = 192


def _frame_tokens(stream: int, k: int, vocab: int,
                  seq: int = 6) -> np.ndarray:
    """Deterministic per-(stream, frame) prefill tokens."""
    return ((stream * 131 + k * 17 + np.arange(seq)) % vocab).astype(
        np.int32)


def draw_streams(lam, mu, live, *, delay_model: str, seed: int, t: int,
                 frames_cap: int) -> tuple:
    """Pre-draw every live stream's (T, O, coin) ``[N, frames_cap]``
    arrays from its collision-free ``stream_seed_sequence(seed, t, i)``
    stream (the JAX package's sampler mapping), the engine rung's one
    source of randomness."""
    n = lam.size
    frames_cap = int(frames_cap)
    T = np.zeros((n, frames_cap))
    O = np.zeros((n, frames_cap))
    coin = np.ones((n, frames_cap))
    for i in np.flatnonzero(live):
        rng = np.random.default_rng(
            queues.stream_seed_sequence(int(seed), int(t), int(i)))
        kw = queues.oracle_samplers(delay_model, lam[i], mu[i])
        ts = kw.get("t_sampler") or (
            lambda r, m, s=1.0 / lam[i]: r.exponential(s, size=m))
        os_ = kw.get("o_sampler") or (
            lambda r, m, s=1.0 / mu[i]: r.exponential(s, size=m))
        T[i] = ts(rng, frames_cap)
        O[i] = os_(rng, frames_cap)
        coin[i] = rng.random(frames_cap)
    return T, O, coin


def measure_engine_epoch(engine: Engine, lam, mu, p, pol, *,
                         epoch_duration: float, seed: int = 0, t: int = 0,
                         delay_model: str = "mm1", active=None,
                         frames_cap: int = ENGINE_FRAMES_CAP,
                         collect_samples: int = 0,
                         collect_trace: bool = False) -> dict:
    """Measure one epoch of ``N`` streams on the real engine.

    Returns the same per-stream stat dict as ``queues.gi_g1_window``
    (each value ``[N]``): ``aopi``/``horizon``/``n_frames``/
    ``n_completed``/``n_accurate``, plus ``preempts`` (LCFSP arrival
    preemptions per stream, drain excluded), ``engine_steps`` (batched
    decode dispatches actually executed) and, when
    ``collect_samples > 0``, ``delay_samples`` ``[N, collect_samples]``
    of raw transmission draws (zero-padded) for the fitted delay-model
    selector. ``collect_trace`` additionally returns ``trace``: the
    counted completion events as ``(stream, frame, t_done)`` tuples in
    canonical ``(t_done, stream, frame)`` order — the bitwise parity
    surface shared with the tick-scan backend.
    """
    queues.validate_delay_model(delay_model)
    lam = np.asarray(lam, np.float64).ravel()
    mu = np.asarray(mu, np.float64).ravel()
    p = np.clip(np.asarray(p, np.float64).ravel(), 1e-3, 1.0)
    pol = np.asarray(pol, np.int64).ravel()
    n = lam.size
    if engine.n_lanes < n:
        raise ValueError(
            f"engine has {engine.n_lanes} lanes < {n} streams; the "
            "replay plane pins one lane per stream")
    live = (lam > 0.0) & (mu > 0.0)
    if active is not None:
        live = live & (np.asarray(active, np.float64).ravel() > 0.0)
    vocab = int(getattr(engine.model, "vocab", 32))
    frames_cap = int(frames_cap)

    T, O, coin = draw_streams(lam, mu, live, delay_model=delay_model,
                              seed=seed, t=t, frames_cap=frames_cap)
    arrive = np.cumsum(T, axis=1)                 # a_k; gen_k = a_k - T_k
    h_eff = np.where(live, np.minimum(float(epoch_duration),
                                      arrive[:, -1]), 0.0)

    # Per-stream DES + exact age-integration state.
    last_t = np.zeros(n)
    age0 = np.zeros(n)
    area = np.zeros(n)
    n_arr = np.zeros(n)
    n_done = np.zeros(n)
    n_acc = np.zeros(n)
    n_pre = np.zeros(n)            # LCFSP arrival preemptions (no drain)
    trace: list[tuple] = []        # counted completions (i, k, t_done)
    steps0 = engine._steps
    in_service: list[Optional[int]] = [None] * n  # frame idx on the lane
    version = [0] * n              # invalidates preempted completions
    pending: list[list[int]] = [[] for _ in range(n)]   # FCFS backlog
    stash: dict[int, np.ndarray] = {}   # early engine results by stream
    counter = itertools.count()
    heap: list = []

    # Streams that churned out between epochs may still hold a DECODING
    # lane from the previous window — release them before replaying.
    for i in np.flatnonzero(~live):
        engine.preempt_stream(i)
        stash.pop(i, None)

    def pull_result(i: int) -> np.ndarray:
        """Drive batched decode ticks until stream ``i``'s tokens exist
        (early completions of other lanes are stashed for their own
        completion events)."""
        while i not in stash:
            if engine.lanes[i].status != DECODING:
                raise RuntimeError(
                    f"lane {i} lost its in-flight frame (leaked lane?)")
            for r in engine.decode_tick():
                stash[r.stream_id] = r.tokens
        return stash.pop(i)

    def admit(i: int, k: int, start: float) -> None:
        frame = Frame(stream_id=i, gen_time=arrive[i, k] - T[i, k],
                      arrive_time=arrive[i, k], seq=k)
        if not engine.admit(frame, _frame_tokens(i, k, vocab), lane=i):
            raise RuntimeError(f"lane {i} busy at admit (leaked lane?)")
        in_service[i] = k
        version[i] += 1
        heapq.heappush(heap, (start + O[i, k], next(counter),
                              COMPLETION, i, (k, version[i])))

    for i in np.flatnonzero(live):
        heapq.heappush(heap, (arrive[i, 0], next(counter), ARRIVAL, i, 0))

    while heap:
        now, _, kind, i, payload = heapq.heappop(heap)
        if kind == ARRIVAL:
            k = payload
            if now <= h_eff[i]:
                n_arr[i] += 1
            if pol[i] == 1:                       # LCFSP: preempt + seize
                if in_service[i] is not None:
                    engine.preempt_stream(i)
                    stash.pop(i, None)
                    version[i] += 1               # invalidate completion
                    in_service[i] = None
                    n_pre[i] += 1
                admit(i, k, now)
            else:                                 # FCFS: queue or seize
                if in_service[i] is None:
                    admit(i, k, now)
                else:
                    pending[i].append(k)
            if k + 1 < frames_cap and now <= h_eff[i]:
                heapq.heappush(heap, (arrive[i, k + 1], next(counter),
                                      ARRIVAL, i, k + 1))
        else:                                     # COMPLETION
            k, ver = payload
            if ver != version[i]:
                continue                          # preempted — stale event
            pull_result(i)                        # real engine tokens
            in_service[i] = None
            if now <= h_eff[i]:
                n_done[i] += 1
                if collect_trace:
                    trace.append((i, k, now))
                if coin[i, k] < p[i]:
                    n_acc[i] += 1
                    gen = arrive[i, k] - T[i, k]
                    seg = now - last_t[i]
                    area[i] += age0[i] * seg + 0.5 * seg * seg
                    last_t[i] = now
                    age0[i] = now - gen
            if pending[i] and now <= h_eff[i]:    # FCFS: next in line
                admit(i, pending[i].pop(0), now)

    # Epoch-end drain: free every in-flight lane so churned-out streams
    # can't leak a DECODING lane into the next epoch.
    for i in range(n):
        engine.preempt_stream(i)
    stash.clear()

    seg = np.maximum(h_eff - last_t, 0.0)
    area += age0 * seg + 0.5 * seg * seg
    safe_h = np.maximum(h_eff, 1e-12)
    out = {
        "aopi": np.where(live, area / safe_h, 0.0),
        "horizon": h_eff,
        "n_frames": np.where(live, n_arr, 0.0),
        "n_completed": np.where(live, n_done, 0.0),
        "n_accurate": np.where(live, n_acc, 0.0),
        "preempts": np.where(live, n_pre, 0.0),
        "engine_steps": float(engine._steps),
    }
    if collect_samples:
        cap = min(int(collect_samples), frames_cap)
        out["delay_samples"] = np.where(live[:, None], T[:, :cap], 0.0)
    if collect_trace:
        out["trace"] = sorted(trace, key=lambda r: (r[2], r[0], r[1]))
    obs.counter("engine_plane.epochs", delay_model=delay_model).inc()
    obs.histogram("engine_plane.frames").observe(float(n_arr.sum()))
    obs.counter("engine.ticks", backend="des",
                delay_model=delay_model).inc(float(engine._steps - steps0))
    obs.counter("engine.preempts", backend="des").inc(float(n_pre.sum()))
    return out
