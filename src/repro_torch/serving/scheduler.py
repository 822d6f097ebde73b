"""Per-stream frame queues (FCFS / LCFSP) + online AoPI tracking (the
port's own copy of the JAX package's ``serving/scheduler.py``; host numpy).

This is the paper's computation-policy layer mapped onto a serving
scheduler: each stream (camera) owns a frame queue; under FCFS frames are
processed in arrival order, under LCFSP a newly-arrived frame *preempts*
the stream's in-flight frame at the next step boundary (an accelerator
cannot abort a kernel mid-flight: preemption granularity is one engine
step).

``AoPITracker`` integrates the exact piecewise-linear age curve online —
the measured counterpart of Theorems 1-2, compared against the closed forms
in the JAX package's tests and examples.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

FCFS, LCFSP = 0, 1


@dataclasses.dataclass
class StreamTelemetry:
    """Measured per-stream data-plane rates for one epoch: what re-enters
    the next planning window (``AnalyticsService``), whose profiled
    accuracy and link efficiency are corrected toward what the data plane
    delivered."""
    acc_hat: np.ndarray      # accurate fraction among completed frames
    lam_hat: np.ndarray      # measured frame arrival rate (frames/s)
    mu_hat: np.ndarray       # measured frame completion rate (frames/s)
    n_frames: np.ndarray     # frames offered to each stream's queue
    n_completed: np.ndarray  # frames whose result was delivered
    aopi_hat: np.ndarray = None  # measured per-stream AoPI over the epoch
    #: Raw per-stream transmission-delay draws [streams, cap] (zero-padded;
    #: only set when the service runs the fitted delay-model selector).
    delay_samples: Optional[np.ndarray] = None

    @staticmethod
    def empty(n_streams: int) -> "StreamTelemetry":
        z = np.zeros(n_streams)
        return StreamTelemetry(z.copy(), z.copy(), z.copy(),
                               z.copy(), z.copy(), z.copy())


@dataclasses.dataclass
class Frame:
    stream_id: int
    gen_time: float            # capture instant at the camera
    arrive_time: float         # transmission finished (enters the queue)
    tokens: int = 64           # payload size (resolution analog)
    seq: int = 0


class StreamQueue:
    """One camera's frame queue with the slot's computation policy."""

    def __init__(self, stream_id: int, policy: int = FCFS):
        self.stream_id = stream_id
        self.policy = policy
        self.pending: deque = deque()
        self.preempt_requested = False

    def on_arrival(self, frame: Frame) -> bool:
        """Returns True if the scheduler must preempt this stream's
        in-flight frame (LCFSP semantics)."""
        if self.policy == LCFSP:
            self.pending.clear()
            self.pending.append(frame)
            self.preempt_requested = True
            return True
        self.pending.append(frame)
        return False

    def pop(self) -> Optional[Frame]:
        self.preempt_requested = False
        return self.pending.popleft() if self.pending else None

    def __len__(self):
        return len(self.pending)


class AoPITracker:
    """Exact online integration of the AoPI curve per stream."""

    def __init__(self, n_streams: int, t0: float = 0.0):
        self.last_acc_gen = [t0] * n_streams   # virtual accurate frame at 0
        self.area = [0.0] * n_streams
        self.last_t = [t0] * n_streams
        self.t0 = t0

    def _advance(self, s: int, t: float):
        dt = t - self.last_t[s]
        if dt > 0:
            a0 = self.last_t[s] - self.last_acc_gen[s]
            self.area[s] += a0 * dt + 0.5 * dt * dt
            self.last_t[s] = t

    def on_result(self, s: int, gen_time: float, accurate: bool,
                  t_done: float):
        self._advance(s, t_done)
        if accurate and gen_time > self.last_acc_gen[s]:
            self.last_acc_gen[s] = gen_time

    def mean_aopi(self, s: int, t_now: float) -> float:
        self._advance(s, t_now)
        horizon = t_now - self.t0
        return self.area[s] / max(horizon, 1e-12)

    def overall(self, t_now: float) -> float:
        vals = [self.mean_aopi(s, t_now) for s in range(len(self.area))]
        return sum(vals) / len(vals)
