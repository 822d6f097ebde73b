"""``python -m repro_torch.obs.report <run_dir>`` — the timing dashboard.

The port's copy of ``repro.obs.report``: the same tables, word for word,
from the same artefacts. Its last line counts ``obs.dispatch.count``
under the reference's heading ("kernel entry traces"); in the port that
counter is bumped once per kernel launch.

Reads the artifacts an instrumented run leaves behind
(``trace.jsonl`` streamed live, or the ``trace.json`` Chrome snapshot,
plus ``metrics.jsonl``) and prints the service-latency story per
``policy x family``:

  * plans/sec and p50/p99 ``plan_horizon`` latency, split into boundary
    plans vs divergence-triggered early replans (the p99 *replan*
    latency is the paper-relevant tail: how fast the control plane
    reacts when the model is wrong);
  * early-replan and divergence counters, reconciled against the span
    stream (the counts come from the same instrumented code paths as
    ``AnalyticsService.early_replans``);
  * data-plane measurement throughput (``gi_g1_window`` dispatches) and
    per-backend ``solve_slot`` dispatch timing.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from collections import defaultdict

PLAN_SPAN = "service.plan_window"
MEASURE_SPAN = "service.measure_window"
EPOCH_SPAN = "service.run_epoch"
REPLAN_EVENT = "service.early_replan"


def quantile(values: list[float], q: float) -> float:
    """Exact quantile of a list (offline — no bucketing needed)."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = min(max(int(math.ceil(q * len(s))) - 1, 0), len(s) - 1)
    return s[idx]


def load_events(run_dir: str) -> list[dict]:
    """trace.jsonl (one event per line) preferred; fall back to the
    Chrome ``trace.json`` snapshot (converted back to seconds)."""
    jsonl = os.path.join(run_dir, "trace.jsonl")
    if os.path.exists(jsonl):
        events = []
        with open(jsonl) as f:
            for line in f:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
        return events
    chrome = os.path.join(run_dir, "trace.json")
    if os.path.exists(chrome):
        with open(chrome) as f:
            doc = json.load(f)
        return [{"ph": ev.get("ph", "X"), "name": ev["name"],
                 "ts": ev["ts"] / 1e6, "dur": ev.get("dur", 0.0) / 1e6,
                 "args": ev.get("args", {})}
                for ev in doc.get("traceEvents", [])]
    raise FileNotFoundError(
        f"no trace.jsonl or trace.json under {run_dir!r} — run with "
        f"REPRO_OBS_DIR={run_dir} (or obs.configure(run_dir=...))")


def load_metrics(run_dir: str) -> list[dict]:
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _group(ev: dict) -> tuple[str, str]:
    args = ev.get("args", {})
    return (str(args.get("policy", "?")), str(args.get("family", "?")))


def build_report(events: list[dict], metrics: list[dict]) -> str:
    plans = defaultdict(list)      # (policy, family) -> [dur]
    replans = defaultdict(list)    # early-replan-triggered plan spans
    epochs = defaultdict(int)
    measures = defaultdict(list)
    replan_events = defaultdict(int)
    for ev in events:
        key = _group(ev)
        name = ev["name"]
        if name == PLAN_SPAN:
            plans[key].append(ev["dur"])
            if ev.get("args", {}).get("reason") == "early":
                replans[key].append(ev["dur"])
        elif name == EPOCH_SPAN:
            epochs[key] += 1
        elif name == MEASURE_SPAN:
            measures[key].append(ev["dur"])
        elif name == REPLAN_EVENT:
            replan_events[key] += 1

    div_gauges = {}
    early_counters = {}
    for m in metrics:
        lbl = m.get("labels", {})
        key = (str(lbl.get("policy", "?")), str(lbl.get("family", "?")))
        if m["name"] == "service.divergence":
            div_gauges[key] = m.get("value", 0.0)
        elif m["name"] == REPLAN_EVENT + ".count":
            # One series per scenario — a family spanning several
            # scenarios reconciles against the SUM of its series.
            early_counters[key] = (early_counters.get(key, 0.0)
                                   + m.get("value", 0.0))

    keys = sorted(set(plans) | set(epochs) | set(replan_events)
                  | set(early_counters))
    lines = ["repro.obs report — plan/measure/replan loop", ""]
    hdr = (f"{'policy':<7s} {'family':<14s} {'plans':>6s} {'plans/s':>9s} "
           f"{'p50 plan':>10s} {'p99 plan':>10s} {'replans':>8s} "
           f"{'p99 replan':>11s} {'epochs':>7s} {'div':>8s}")
    lines += [hdr, "-" * len(hdr)]
    for key in keys:
        pol, fam = key
        durs = plans.get(key, [])
        total = sum(durs)
        rate = (len(durs) / total) if total > 0 else 0.0
        n_replan = replan_events.get(key, 0)
        counter_val = early_counters.get(key)
        mismatch = (counter_val is not None
                    and int(counter_val) != n_replan)
        lines.append(
            f"{pol:<7s} {fam:<14s} {len(durs):>6d} {rate:>9.2f} "
            f"{quantile(durs, 0.50) * 1e3:>8.2f}ms "
            f"{quantile(durs, 0.99) * 1e3:>8.2f}ms "
            f"{n_replan:>8d} "
            f"{quantile(replans.get(key, []), 0.99) * 1e3:>9.2f}ms "
            f"{epochs.get(key, 0):>7d} "
            f"{div_gauges.get(key, 0.0):>+8.2%}"
            + ("  [COUNTER MISMATCH]" if mismatch else ""))
    if not keys:
        lines.append("(no service spans recorded)")

    meas_all = [d for v in measures.values() for d in v]
    if meas_all:
        lines += ["", f"data plane: {len(meas_all)} measure_window "
                      f"dispatches, p50 {quantile(meas_all, .5) * 1e3:.2f}ms"
                      f", p99 {quantile(meas_all, .99) * 1e3:.2f}ms"]

    solve = [m for m in metrics if m["name"] == "bcd.solve_slot.seconds"]
    for m in solve:
        q = m.get("quantiles", {})
        lines.append(
            f"solve_slot[{m['labels'].get('solver_backend', '?')}]: "
            f"{m['count']} host dispatches, p50 "
            f"{float(q.get('0.5', 0.0)) * 1e3:.2f}ms, p99 "
            f"{float(q.get('0.99', 0.0)) * 1e3:.2f}ms")
    disp = [m for m in metrics if m["name"] == "obs.dispatch.count"]
    if disp:
        total = sum(m["value"] for m in disp)
        per = ", ".join(
            f"{m['labels'].get('entry', '?')}={m['value']:g}"
            for m in sorted(disp, key=lambda m: -m["value"])[:8])
        lines.append(f"kernel entry traces: {total:g} ({per})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Text dashboard over a run directory's obs artifacts")
    ap.add_argument("run_dir", help="directory holding trace.jsonl / "
                                    "metrics.jsonl (REPRO_OBS_DIR)")
    args = ap.parse_args(argv)
    events = load_events(args.run_dir)
    metrics = load_metrics(args.run_dir)
    print(build_report(events, metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
