"""Exporters: Prometheus text exposition, JSONL dumps, run-dir artifacts.

The port's copy of ``repro.obs.export``; series keep the ``repro_``
Prometheus prefix, so dashboards read either package's output.

Three formats, one registry:

  * :func:`prometheus_text` — the text exposition a Prometheus scrape
    (or a human with ``curl``) expects: counters as ``_total``,
    histograms as summaries with ``quantile`` labels plus ``_sum`` /
    ``_count``.
  * :func:`metrics_jsonl` — one JSON object per series, the
    machine-readable twin (this is what ``repro_torch.obs.report`` reads).
  * :func:`write_artifacts` — drop everything into a run directory:
    ``metrics.prom``, ``metrics.jsonl``, ``trace.json`` (Chrome
    trace-event / Perfetto), next to the streamed ``trace.jsonl``.
"""
from __future__ import annotations

import json
import os
import re

from . import trace as trace_mod
from .metrics import Registry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_TYPES = {"counter": "counter", "gauge": "gauge",
               "histogram": "summary"}


def _prom_name(name: str) -> str:
    return "repro_" + _NAME_RE.sub("_", name)


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    body = ",".join(
        f'{_NAME_RE.sub("_", str(k))}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(merged.items()))
    return "{" + body + "}"


def prometheus_text(registry: Registry) -> str:
    """Render the registry in Prometheus text exposition format."""
    by_name: dict[str, list] = {}
    kinds: dict[str, str] = {}
    for m in registry:
        by_name.setdefault(m.name, []).append(m)
        kinds[m.name] = m.kind
    lines = []
    for name in sorted(by_name):
        pname = _prom_name(name)
        kind = kinds[name]
        lines.append(f"# TYPE {pname} {_PROM_TYPES[kind]}")
        for m in by_name[name]:
            if kind == "counter":
                lines.append(
                    f"{pname}_total{_prom_labels(m.labels)} {m.value:g}")
            elif kind == "gauge":
                lines.append(
                    f"{pname}{_prom_labels(m.labels)} {m.value:g}")
            else:
                for q, v in m.quantiles().items():
                    lines.append(
                        f"{pname}{_prom_labels(m.labels, {'quantile': q})}"
                        f" {v:g}")
                lines.append(
                    f"{pname}_sum{_prom_labels(m.labels)} {m.total:g}")
                lines.append(
                    f"{pname}_count{_prom_labels(m.labels)} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def metrics_jsonl(registry: Registry) -> str:
    """One JSON object per line per series (``Metric.snapshot()``)."""
    return "".join(json.dumps(snap) + "\n"
                   for snap in registry.snapshot())


def write_artifacts(run_dir: str, registry: Registry,
                    buffer: trace_mod.TraceBuffer) -> dict[str, str]:
    """Write every export format into ``run_dir``; returns the paths.

    Safe to call repeatedly (snapshots overwrite; the streamed
    ``trace.jsonl`` is flushed, not rewritten).
    """
    os.makedirs(run_dir, exist_ok=True)
    paths = {
        "prometheus": os.path.join(run_dir, "metrics.prom"),
        "metrics_jsonl": os.path.join(run_dir, "metrics.jsonl"),
        "chrome_trace": os.path.join(run_dir, "trace.json"),
    }
    with open(paths["prometheus"], "w") as f:
        f.write(prometheus_text(registry))
    with open(paths["metrics_jsonl"], "w") as f:
        f.write(metrics_jsonl(registry))
    with open(paths["chrome_trace"], "w") as f:
        json.dump(trace_mod.chrome_trace(buffer.events()), f)
    buffer.flush()
    if buffer.stream_path:
        paths["trace_jsonl"] = buffer.stream_path
    return paths
