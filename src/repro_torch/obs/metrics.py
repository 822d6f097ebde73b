"""Process-local metric registry: counters, gauges, log-bucketed histograms.

The port's copy of ``repro.obs.metrics``: the same metric names, label
sets, buckets and quantile rules, so both packages export the same text
for the same calls.

The paper's argument is about *time* — AoPI is an age, LBCD wins by
replanning fast enough — so the repo needs to measure its own latency the
same way it measures the fleet's. This registry is the cheap, always-on
substrate: every metric is a plain Python object with a couple of dict
ops per update (no torch, no I/O on the hot path), so instrumented code
stays within noise of uninstrumented code, and ``REPRO_OBS=0`` swaps in
shared no-op singletons whose update methods do literally nothing.

Label sets are free-form keyword labels (``policy``, ``family``,
``delay_model``, ``solver_backend`` are the conventional ones); each
distinct ``(name, labels)`` pair is one time series, exactly the
Prometheus data model so :mod:`repro_torch.obs.export` can emit text
exposition without translation.

Histograms are **log-bucketed**: observations land in geometric buckets
``base**i <= v < base**(i+1)`` with ``base = 2**(1/4)`` (~19% relative
resolution), so streaming p50/p95/p99 extraction is a cumulative walk
over a tiny dict — no reservoir, no sorting, O(1) memory in the number
of observations.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Iterator

#: Geometric bucket base: 2**(1/4) keeps any quantile estimate within
#: ~9.5% of the true value (half a bucket) while a microsecond-to-hour
#: range still fits in ~90 buckets.
BUCKET_BASE = 2.0 ** 0.25
_LOG_BASE = math.log(BUCKET_BASE)

DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic counter. ``inc()`` is one float add under the GIL."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": dict(self.labels), "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": dict(self.labels), "value": self.value}


class Histogram:
    """Log-bucketed streaming histogram with quantile extraction.

    ``observe(v)`` costs one ``math.log`` and one dict increment.
    Non-positive observations (a zero-length span on a coarse clock)
    are tracked in a dedicated underflow bucket that quantile extraction
    treats as 0.0.
    """

    __slots__ = ("name", "labels", "buckets", "count", "total",
                 "vmin", "vmax", "zero_count")
    kind = "histogram"

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zero_count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= 0.0:
            self.zero_count += 1
            return
        idx = int(math.floor(math.log(v) / _LOG_BASE))
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(float(v))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Streaming quantile: cumulative walk over the sorted buckets,
        returning the geometric midpoint of the bucket holding the
        q-th observation (exact endpoints clamp to observed min/max)."""
        if self.count == 0:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        target = q * self.count
        seen = self.zero_count
        if seen >= target and self.zero_count:
            return 0.0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= target:
                mid = BUCKET_BASE ** (idx + 0.5)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def quantiles(self, qs=DEFAULT_QUANTILES) -> dict[float, float]:
        return {q: self.quantile(q) for q in qs}

    def snapshot(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": dict(self.labels), "count": self.count,
                "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "quantiles": {str(q): v
                              for q, v in self.quantiles().items()}}


class _NoopMetric:
    """Shared do-nothing stand-in returned when obs is disabled — every
    update method is a constant-time no-op so the ``REPRO_OBS=0`` fast
    path costs one branch plus one call."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def observe_many(self, values) -> None:
        pass


NOOP_METRIC = _NoopMetric()


@dataclasses.dataclass
class Registry:
    """Get-or-create store of metrics keyed by ``(name, labels)``.

    Creation takes a lock (rare); updates go straight to the metric
    object (GIL-atomic dict/float ops). One process-wide default
    registry lives in :mod:`repro_torch.obs` — tests may instantiate private
    ones.
    """

    _metrics: dict = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)

    def _get(self, cls, name: str, labels: dict):
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"not {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def __iter__(self) -> Iterator:
        return iter(list(self._metrics.values()))

    def __len__(self) -> int:
        return len(self._metrics)

    def get(self, name: str, **labels):
        """Lookup without creation (None when absent)."""
        return self._metrics.get((name, _labels_key(labels)))

    def collect(self, name: str) -> list:
        """Every series of ``name`` across label sets."""
        return [m for (n, _), m in self._metrics.items() if n == name]

    def total(self, name: str) -> float:
        """Sum of a counter/gauge over all label sets."""
        return sum(m.value for m in self.collect(name))

    def snapshot(self) -> list[dict]:
        return [m.snapshot() for m in self]

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
