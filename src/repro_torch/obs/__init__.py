"""``repro_torch.obs`` — metrics, traces, and exporters for the timing story.

The port of ``repro.obs``, with the same switches, metric names and
artefacts:

  * **metrics** — a process-local registry of counters, gauges and
    log-bucketed histograms with label sets (``policy``, ``family``,
    ``delay_model``, ``solver_backend``), cheap enough to be on by
    default (:mod:`repro_torch.obs.metrics`);
  * **traces** — nested wall-clock spans streaming to JSONL and
    renderable as Chrome trace-event JSON for Perfetto, with
    ``torch.profiler.record_function`` (and an NVTX range once CUDA is
    initialised) entered inside every span so device profiles line up
    (:mod:`repro_torch.obs.trace`). A span never synchronises the device;
  * **exporters** — Prometheus text exposition + JSONL + the
    ``python -m repro_torch.obs.report <run_dir>`` dashboard
    (:mod:`repro_torch.obs.export`, :mod:`repro_torch.obs.report`).

Switches: ``REPRO_OBS=0`` disables everything (every instrumented call
collapses to one boolean check and a shared no-op object);
``REPRO_OBS_DIR=dir`` streams trace events to ``dir/trace.jsonl`` and
registers an atexit hook writing the full artifact set there. Both are
also runtime-settable via :func:`configure`.

Typical use::

    from repro_torch import obs

    obs.configure(run_dir="results/obs/run0")
    with obs.label_context(policy="lbcd", family="steady"):
        with obs.span("sweep.policy", backend="loop"):
            result = scenarios.sweep(suite, policies=("lbcd",))
    obs.counter("service.early_replans", policy="lbcd").inc()
    print(obs.prometheus_text())
"""
from __future__ import annotations

import atexit
import os

from . import export as _export
from . import trace as _trace
from .metrics import (  # noqa: F401  (re-exported)
    BUCKET_BASE, Counter, Gauge, Histogram, NOOP_METRIC, Registry)
from .trace import (  # noqa: F401
    NOOP_SPAN, Span, chrome_trace, current_labels, label_context)


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "1").lower() not in (
        "0", "false", "off", "no")


_enabled: bool = _env_enabled()
_registry = Registry()
_buffer = _trace.TraceBuffer()
_run_dir: str | None = None
_atexit_registered = False


def enabled() -> bool:
    """Whether instrumentation is live (the one branch on hot paths)."""
    return _enabled


def registry() -> Registry:
    return _registry


def buffer() -> _trace.TraceBuffer:
    return _buffer


def run_dir() -> str | None:
    return _run_dir


def _flush_at_exit() -> None:
    if _run_dir is not None:
        try:
            _export.write_artifacts(_run_dir, _registry, _buffer)
        except Exception:
            pass


def configure(enabled: bool | None = None,
              run_dir: str | None = None) -> None:
    """Runtime switchboard.

    ``enabled`` toggles all instrumentation; ``run_dir`` starts streaming
    trace events to ``<run_dir>/trace.jsonl`` and registers an atexit
    hook that writes the full artifact set (``metrics.prom``,
    ``metrics.jsonl``, ``trace.json``) there. Pass ``run_dir=""`` to stop
    streaming.
    """
    global _enabled, _run_dir, _atexit_registered
    if enabled is not None:
        _enabled = bool(enabled)
    if run_dir is not None:
        if run_dir == "":
            _run_dir = None
            _buffer.set_stream(None)
        else:
            _run_dir = run_dir
            _buffer.set_stream(os.path.join(run_dir, "trace.jsonl"))
            if not _atexit_registered:
                atexit.register(_flush_at_exit)
                _atexit_registered = True


def reset() -> None:
    """Drop all recorded state and re-read the environment switches
    (test isolation; streaming keeps whatever file it had open)."""
    global _enabled
    _registry.clear()
    _buffer.clear()
    _enabled = _env_enabled()


# Re-arm streaming from the environment at import.
if os.environ.get("REPRO_OBS_DIR"):
    configure(run_dir=os.environ["REPRO_OBS_DIR"])


# ---------------------------------------------------------------------
# Metric accessors — get-or-create on the default registry. Explicit
# labels are merged over the ambient label_context (string values only),
# so a counter bumped inside ``label_context(family="outage")`` lands on
# the ``family="outage"`` series without the call site knowing about
# families.
# ---------------------------------------------------------------------
def _metric_labels(attrs: dict) -> dict:
    """String-valued attrs + the label context become metric labels;
    numeric attrs (slot indices, sizes) stay span-only so they can't
    explode the series cardinality."""
    merged = {**current_labels(), **attrs}
    return {k: v for k, v in merged.items() if isinstance(v, str)}


def counter(name: str, **labels):
    if not _enabled:
        return NOOP_METRIC
    return _registry.counter(name, **_metric_labels(labels))


def gauge(name: str, **labels):
    if not _enabled:
        return NOOP_METRIC
    return _registry.gauge(name, **_metric_labels(labels))


def histogram(name: str, **labels):
    if not _enabled:
        return NOOP_METRIC
    return _registry.histogram(name, **_metric_labels(labels))


def span(name: str, **attrs):
    """Open a wall-clock span (context manager).

    On exit the event lands in the trace buffer/stream AND the duration
    is observed into the ``<name>.seconds`` histogram labeled with the
    string-valued attrs merged over the active :func:`label_context` —
    so every span series doubles as a latency histogram with streaming
    p50/p95/p99.
    """
    if not _enabled:
        return NOOP_SPAN
    metric = _registry.histogram(name + ".seconds", **_metric_labels(attrs))
    return _trace.Span(name, _buffer, attrs, metric=metric)


def event(name: str, **attrs):
    """Record an instant event (and bump the ``<name>.count`` counter)."""
    if not _enabled:
        return None
    _registry.counter(name + ".count", **_metric_labels(attrs)).inc()
    return _trace.record_event(name, _buffer, attrs)


def count_dispatch(name: str, **labels) -> None:
    """Dispatch counter for kernel entry points: bumps
    ``obs.dispatch.count`` labeled by entry point (+ callers' labels).
    The reference counts at trace time, once per compiled program; the
    port's wrappers call this beside their launch counters
    (``kernels.slot_solver.ops.launches``), once per kernel launch, so for
    every kernel the sum over its series equals its launch count."""
    if not _enabled:
        return
    _registry.counter("obs.dispatch.count",
                      **_metric_labels({"entry": name, **labels})).inc()


# ---------------------------------------------------------------------
# Exports
# ---------------------------------------------------------------------
def prometheus_text() -> str:
    return _export.prometheus_text(_registry)


def metrics_jsonl() -> str:
    return _export.metrics_jsonl(_registry)


def snapshot() -> list[dict]:
    return _registry.snapshot()


def snapshot_summary() -> dict:
    """Compact provenance stamp (the reference's for
    ``benchmarks/common.run_metadata``):
    every counter/gauge total plus histogram count/p50/p99, aggregated
    over label sets — small enough to ride every ``BENCH_*.json``."""
    agg: dict[str, dict] = {}
    for m in _registry:
        if m.kind == "histogram":
            d = agg.setdefault(m.name, {"count": 0, "sum": 0.0})
            d["count"] += m.count
            d["sum"] += m.total
        else:
            d = agg.setdefault(m.name, {"total": 0.0})
            d["total"] = d.get("total", 0.0) + m.value
    return {"enabled": _enabled, "n_series": len(_registry),
            "n_trace_events": len(_buffer.events()), "metrics": agg}


def write_artifacts(run_dir: str | None = None) -> dict[str, str]:
    """Write ``metrics.prom`` / ``metrics.jsonl`` / ``trace.json`` into
    ``run_dir`` (defaults to the configured one)."""
    target = run_dir or _run_dir
    if target is None:
        raise ValueError("no run_dir: pass one or obs.configure(run_dir=)")
    return _export.write_artifacts(target, _registry, _buffer)


def flush() -> None:
    _buffer.flush()


def events() -> list[dict]:
    return _buffer.events()
