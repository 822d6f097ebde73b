"""Span-based tracing for the plan/measure/replan loop.

``span("service.plan_window", policy="lbcd")`` opens a wall-clock span;
on exit one event dict is recorded with the span's duration, its parent
(spans nest per-thread, so events form a tree), and the merged label
context (:func:`label_context` — ``replay_suite`` sets ``family``/
``policy`` once and every span underneath inherits them). Completed
events stream to ``<run_dir>/trace.jsonl`` when a run directory is
configured and are kept in a bounded in-memory buffer either way, from
which :func:`chrome_trace` renders Chrome trace-event JSON (load it at
``ui.perfetto.dev``).

Inside every span the code also enters
``torch.profiler.record_function`` with the span name and, once CUDA is
initialised in the process, an NVTX range of the same name, so a device
profile (``torch.profiler`` or an NVTX-aware tool) lines up against the
host spans: the host-side "plan_horizon took 40ms" and the device-side
"which kernels those 40ms were" views share names. This is the port of
``repro.obs.trace``, where the same places enter ``jax.named_scope`` and
``jax.profiler.TraceAnnotation``.

A span never synchronises the device: like the reference's, its duration
is host time, so around asynchronous CUDA work it measures submission,
not completion.

Timebase: ``time.perf_counter()`` relative to module import (the
``ts``/``dur`` fields are seconds on one monotonic clock, directly
subtractable); ``wall`` carries ``time.time()`` for cross-process
alignment.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Iterable

import torch

#: Events kept in memory (ring buffer) — enough for ~hours of control-
#: plane activity; the JSONL stream is the unbounded record.
MAX_EVENTS = 200_000

_T0 = time.perf_counter()
_EPOCH0 = time.time()

_labels: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "repro_torch_obs_labels", default={})


@contextlib.contextmanager
def label_context(**labels):
    """Merge ``labels`` into every span/event recorded inside the block
    (nested contexts stack; inner wins on conflict)."""
    merged = {**_labels.get(), **labels}
    token = _labels.set(merged)
    try:
        yield merged
    finally:
        _labels.reset(token)


def current_labels() -> dict:
    return dict(_labels.get())


class TraceBuffer:
    """Bounded event store + optional JSONL streaming."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._dropped = 0
        self._path: str | None = None
        self._fh = None
        self._next_id = 0
        self._local = threading.local()

    # -- configuration -------------------------------------------------
    def set_stream(self, path: str | None) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self._path = path
            if path is not None:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self._fh = open(path, "a", buffering=1)

    @property
    def stream_path(self) -> str | None:
        return self._path

    # -- recording -----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def record(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= MAX_EVENTS:
                # Drop the oldest half in one slice — amortized O(1).
                self._dropped += len(self._events) // 2
                self._events = self._events[len(self._events) // 2:]
            self._events.append(ev)
            if self._fh is not None:
                self._fh.write(json.dumps(ev) + "\n")

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    # -- reading -------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0


class Span:
    """One wall-clock span; records an event on exit.

    Use through :func:`repro_torch.obs.span` — entering also opens
    ``torch.profiler.record_function`` and, once CUDA is initialised, an
    NVTX range, so device profiles carry the same names.
    """

    __slots__ = ("name", "attrs", "buffer", "sid", "t0", "_cm", "_metric")

    def __init__(self, name: str, buffer: TraceBuffer, attrs: dict,
                 metric=None):
        self.name = name
        self.attrs = attrs
        self.buffer = buffer
        self.sid = buffer.new_id()
        self.t0 = 0.0
        self._cm = None
        self._metric = metric

    def __enter__(self) -> "Span":
        stack = self.buffer._stack()
        stack.append(self.sid)
        self._cm = contextlib.ExitStack()
        self._cm.enter_context(torch.profiler.record_function(self.name))
        if torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(self.name)
            self._cm.callback(torch.cuda.nvtx.range_pop)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        # Exception-safe teardown: the span must pop off the per-thread
        # stack and record its event even when the body raised (or when
        # closing the profiler scopes raises) — otherwise one raise corrupts
        # the span tree for everything recorded after it.
        t1 = time.perf_counter()
        try:
            self._cm.close()
        finally:
            stack = self.buffer._stack()
            if stack and stack[-1] == self.sid:
                stack.pop()
            elif self.sid in stack:
                stack.remove(self.sid)
            dur = t1 - self.t0
            args = {**current_labels(), **self.attrs}
            if exc and exc[0] is not None:
                args["error"] = 1
            ev = {"ph": "X", "name": self.name, "id": self.sid,
                  "parent": stack[-1] if stack else 0,
                  "ts": self.t0 - _T0, "dur": dur,
                  "wall": _EPOCH0 + (self.t0 - _T0),
                  "tid": threading.get_ident(),
                  "args": args}
            self.buffer.record(ev)
            if self._metric is not None:
                self._metric.observe(dur)

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span."""
        self.attrs.update(attrs)
        return self


def record_event(name: str, buffer: TraceBuffer, attrs: dict) -> dict:
    """Record an instant (zero-duration) event at now."""
    stack = buffer._stack()
    t = time.perf_counter()
    ev = {"ph": "i", "name": name, "id": buffer.new_id(),
          "parent": stack[-1] if stack else 0,
          "ts": t - _T0, "dur": 0.0, "wall": _EPOCH0 + (t - _T0),
          "tid": threading.get_ident(),
          "args": {**current_labels(), **attrs}}
    buffer.record(ev)
    return ev


class _NoopSpan:
    """Disabled-path stand-in: a reusable context manager whose enter and
    exit do nothing (one shared instance, no allocation per span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


def chrome_trace(events: Iterable[dict]) -> dict:
    """Render recorded events as Chrome trace-event JSON (the format
    Perfetto / ``chrome://tracing`` loads): ``ph:"X"`` complete events
    with microsecond timestamps, one row per Python thread."""
    out = []
    for ev in events:
        ce = {"name": ev["name"], "cat": "repro",
              "ph": "X" if ev["ph"] == "X" else "i",
              "ts": ev["ts"] * 1e6, "pid": 0, "tid": ev["tid"],
              "args": {k: v for k, v in ev["args"].items()}}
        if ev["ph"] == "X":
            ce["dur"] = ev["dur"] * 1e6
        else:
            ce["s"] = "t"
        out.append(ce)
    return {"traceEvents": out, "displayTimeUnit": "ms"}
