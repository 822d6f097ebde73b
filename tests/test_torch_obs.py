"""The port's observability package (repro_torch.obs) held against the JAX
package's (repro.obs) on the CPU: the same registry, quantiles and
exports for the same calls, the same report text on the same artefacts,
spans that nest and survive exceptions, and the engine plane's counters.
On the card (no synchronise inside a span): tests/test_torch_gpu.py."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro.obs import export as j_export  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import report as j_report  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro.serving import engine_plane as j_plane  # noqa: E402
from repro.serving import make_replay_engine as j_replay_engine  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core import bcd as t_bcd  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402
from repro_torch.obs import export as t_export  # noqa: E402
from repro_torch.obs import metrics as t_metrics  # noqa: E402
from repro_torch.obs import report as t_report  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402
from repro_torch.serving import engine_plane as t_plane  # noqa: E402
from repro_torch.serving import make_replay_engine as t_replay_engine  # noqa: E402,E501


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    """Both packages' process-wide obs state, empty and enabled."""
    monkeypatch.delenv("REPRO_OBS", raising=False)
    for mod in (j_obs, t_obs):
        mod.configure(run_dir="")
        mod.reset()
    yield
    for mod in (j_obs, t_obs):
        mod.configure(run_dir="")
        mod.reset()


def _drive(m, seed):
    """One call sequence on a registry: counters, gauges, histograms."""
    rng = np.random.default_rng(seed)
    reg = m.Registry()
    for i in range(40):
        reg.counter("sweep.runs", policy=["lbcd", "min"][i % 2]).inc()
        reg.counter("bytes", kind="x").inc(float(rng.integers(1, 9)))
        reg.gauge("queue.depth", server=str(i % 3)).set(rng.normal())
        reg.gauge("level").inc(0.25)
        h = reg.histogram("latency.seconds", family=["a", "b"][i % 2])
        h.observe(float(rng.lognormal(-4.0, 1.5)))
    reg.histogram("zeros").observe_many([0.0, 0.0, -1.0, 2.5])
    reg.histogram("empty")
    reg.counter('odd "name"', label='back\\slash "q"').inc(3)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exports_match_reference(seed):
    rj, rt = _drive(j_metrics, seed), _drive(t_metrics, seed)
    assert t_export.prometheus_text(rt) == j_export.prometheus_text(rj)
    assert t_export.metrics_jsonl(rt) == j_export.metrics_jsonl(rj)
    assert rt.total("sweep.runs") == rj.total("sweep.runs") == 40
    assert rt.get("level").value == rj.get("level").value == 10.0
    assert rt.get("absent") is None
    with pytest.raises(TypeError, match="already registered"):
        rt.gauge("sweep.runs", policy="lbcd")


@pytest.mark.parametrize("seed", [0, 3])
def test_histogram_quantiles_match_reference(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(0.0, 3.0, 500), [0.0] * 7,
                             rng.uniform(1e-7, 1e-6, 20)])
    hj = j_metrics.Histogram("h", {})
    ht = t_metrics.Histogram("h", {})
    hj.observe_many(values)
    ht.observe_many(values)
    qs = np.linspace(0.0, 1.0, 41)
    assert [ht.quantile(q) for q in qs] == [hj.quantile(q) for q in qs]
    assert ht.mean == hj.mean and ht.snapshot() == hj.snapshot()
    assert t_metrics.BUCKET_BASE == j_metrics.BUCKET_BASE
    assert t_metrics.DEFAULT_QUANTILES == j_metrics.DEFAULT_QUANTILES
    with pytest.raises(ValueError, match="outside"):
        ht.quantile(1.5)
    assert t_metrics.Histogram("e", {}).quantile(0.5) == 0.0


def _module_calls(mod):
    with mod.label_context(policy="lbcd", family="steady"):
        mod.counter("service.early_replans").inc()
        mod.counter("service.early_replans", policy="min").inc(2)
        mod.gauge("service.divergence", slot=3).set(0.125)
        with mod.label_context(family="outage"):
            mod.histogram("sweep.aopi").observe_many([0.5, 1.5, 2.0])
            mod.event("service.early_replan", reason="div")
        mod.count_dispatch("waterfill", mode="bandwidth")
        mod.count_dispatch("config_argmin")
    mod.count_dispatch("config_argmin")


def test_module_api_matches_reference():
    """Accessors merge the label context (strings only), events count."""
    for mod in (j_obs, t_obs):
        _module_calls(mod)
    assert t_obs.prometheus_text() == j_obs.prometheus_text()
    assert t_obs.metrics_jsonl() == j_obs.metrics_jsonl()
    sj, st = j_obs.snapshot_summary(), t_obs.snapshot_summary()
    assert st == sj
    assert t_obs.registry().total("obs.dispatch.count") == 3
    ev = t_obs.events()[-1]
    assert ev["name"] == "service.early_replan" and ev["ph"] == "i"
    assert ev["args"] == {"policy": "lbcd", "family": "outage",
                          "reason": "div"}


def _nested(mod):
    ids = {}
    with mod.label_context(policy="dos"):
        with mod.span("outer", backend="loop") as outer:
            ids["outer"] = outer.sid
            with mod.span("inner", k=1) as inner:
                inner.set(found=2)
            with pytest.raises(RuntimeError):
                with mod.span("fails"):
                    raise RuntimeError("boom")
            with mod.span("after"):
                pass
    with mod.span("top"):
        pass
    return mod.events()


def test_spans_nest_label_and_survive_exceptions():
    ej, et = _nested(j_obs), _nested(t_obs)
    shape = [(e["name"], e["ph"], sorted(e["args"].items())) for e in ej]
    assert [(e["name"], e["ph"], sorted(e["args"].items()))
            for e in et] == shape
    by = {e["name"]: e for e in et}
    outer = by["outer"]["id"]
    assert by["inner"]["parent"] == by["fails"]["parent"] == outer
    assert by["after"]["parent"] == outer           # the raise popped
    assert by["outer"]["parent"] == by["top"]["parent"] == 0
    assert by["fails"]["args"]["error"] == 1
    assert by["inner"]["args"] == {"policy": "dos", "k": 1, "found": 2}
    assert t_trace.TraceBuffer()._stack() == []
    assert all(e["dur"] >= 0.0 for e in et)
    hist = t_obs.registry().get("outer.seconds", policy="dos",
                                backend="loop")
    assert hist.count == 1 and hist.total == by["outer"]["dur"]


def test_chrome_trace_matches_reference_on_the_same_events():
    events = _nested(t_obs)
    assert t_trace.chrome_trace(events) == j_trace.chrome_trace(events)


def test_span_enters_a_profiler_range():
    """record_function: the span's name is a range in torch.profiler."""
    with torch.profiler.profile() as prof:
        with t_obs.span("obs.test_range"):
            torch.ones(8).add_(1.0)
    assert "obs.test_range" in {e.key for e in prof.key_averages()}


def test_disabled_obs_is_a_no_op(monkeypatch):
    monkeypatch.setenv("REPRO_OBS", "0")
    t_obs.reset()
    assert not t_obs.enabled()
    assert t_obs.span("x") is t_trace.NOOP_SPAN
    assert t_obs.counter("c") is t_metrics.NOOP_METRIC
    with t_obs.span("x"):
        t_obs.counter("c").inc()
        t_obs.count_dispatch("config_argmin")
        assert t_obs.event("e") is None
    assert len(t_obs.registry()) == 0 and t_obs.events() == []
    t_obs.configure(enabled=True)
    assert t_obs.enabled()


def _synthetic_run():
    """Service-shaped events and metrics (the report's input)."""
    events, t = [], 0.0
    for i in range(30):
        for pol, fam in (("lbcd", "steady"), ("min", "outage")):
            dur = 0.001 * (1 + (i * 7) % 13)
            reason = "early" if i % 5 == 0 else "boundary"
            events.append({"ph": "X", "name": t_report.PLAN_SPAN, "ts": t,
                           "dur": dur, "args": {"policy": pol,
                                                "family": fam,
                                                "reason": reason}})
            events.append({"ph": "X", "name": t_report.MEASURE_SPAN,
                           "ts": t, "dur": dur / 2,
                           "args": {"policy": pol, "family": fam}})
            if i % 3 == 0:
                events.append({"ph": "X", "name": t_report.EPOCH_SPAN,
                               "ts": t, "dur": dur,
                               "args": {"policy": pol, "family": fam}})
            if reason == "early":
                events.append({"ph": "i", "name": t_report.REPLAN_EVENT,
                               "ts": t, "dur": 0.0,
                               "args": {"policy": pol, "family": fam}})
            t += dur
    metrics = [
        {"name": "service.divergence", "type": "gauge",
         "labels": {"policy": "lbcd", "family": "steady"}, "value": 0.031},
        {"name": t_report.REPLAN_EVENT + ".count", "type": "counter",
         "labels": {"policy": "lbcd", "family": "steady"}, "value": 6.0},
        {"name": t_report.REPLAN_EVENT + ".count", "type": "counter",
         "labels": {"policy": "min", "family": "outage"}, "value": 5.0},
        {"name": "bcd.solve_slot.seconds", "type": "histogram",
         "labels": {"solver_backend": "cuda"}, "count": 40, "sum": 0.1,
         "quantiles": {"0.5": 0.002, "0.95": 0.004, "0.99": 0.005}},
        {"name": "obs.dispatch.count", "type": "counter",
         "labels": {"entry": "config_argmin"}, "value": 16.0},
        {"name": "obs.dispatch.count", "type": "counter",
         "labels": {"entry": "waterfill_pair"}, "value": 20.0}]
    return events, metrics


def test_report_text_matches_reference():
    events, metrics = _synthetic_run()
    text = t_report.build_report(events, metrics)
    assert text == j_report.build_report(events, metrics)
    assert "[COUNTER MISMATCH]" in text          # min: 6 events, counter 5
    assert t_report.build_report([], []) == j_report.build_report([], [])
    for q in (0.0, 0.5, 0.99, 1.0):
        assert t_report.quantile([3.0, 1.0, 2.0], q) == \
            j_report.quantile([3.0, 1.0, 2.0], q)


def test_artifacts_and_report_cli_match_reference(tmp_path):
    """A run directory streamed and written by the port reads the same in
    both reports (trace.jsonl, then the Chrome trace.json fallback)."""
    run = tmp_path / "run"
    t_obs.configure(run_dir=str(run))
    with t_obs.label_context(policy="lbcd", family="steady"):
        for _ in range(3):
            with t_obs.span("service.plan_window", reason="boundary"):
                pass
        t_obs.event("service.early_replan")
    t_obs.count_dispatch("config_argmin")
    paths = t_obs.write_artifacts()
    assert {os.path.basename(p) for p in paths.values()} == {
        "metrics.prom", "metrics.jsonl", "trace.json", "trace.jsonl"}
    assert all(os.path.exists(p) for p in paths.values())
    t_obs.configure(run_dir="")
    outs = []
    for main in (t_report.main, j_report.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(run)]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "lbcd" in outs[0]
    assert "config_argmin=1" in outs[0]
    os.remove(run / "trace.jsonl")
    assert t_report.load_events(str(run)) == j_report.load_events(str(run))
    prom = (run / "metrics.prom").read_text()
    assert "repro_service_plan_window_seconds_count" in prom
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert {json.loads(x)["name"] for x in lines} >= {
        "obs.dispatch.count", "service.plan_window.seconds"}
    with pytest.raises(FileNotFoundError):
        t_report.load_events(str(tmp_path / "nothing"))


@pytest.mark.parametrize("delay_model", ["mm1", "lognormal", "weibull"])
def test_engine_epoch_counters_equal_reference(delay_model):
    """measure_engine_epoch's four series, labels and values, equal
    repro's on the same draws (replay engines, one stream churned out)."""
    n = 6
    lam, mu = np.full(n, 0.6), np.full(n, 2.0)
    p, pol = np.full(n, 0.8), (np.arange(n) % 2).astype(np.int64)
    active = np.array([1, 1, 0, 1, 1, 1], np.float64)
    kw = dict(epoch_duration=120.0, seed=9, t=2, frames_cap=48,
              delay_model=delay_model, active=active)
    for _ in range(2):
        j_plane.measure_engine_epoch(j_replay_engine(n), lam, mu, p, pol,
                                     **kw)
        t_plane.measure_engine_epoch(t_replay_engine(n, device="cpu"), lam,
                                     mu, p, pol, **kw)
    names = ("engine_plane.epochs", "engine_plane.frames", "engine.ticks",
             "engine.preempts")
    snap_j = sorted((m["name"], json.dumps(m, sort_keys=True))
                    for m in j_obs.snapshot() if m["name"] in names)
    snap_t = sorted((m["name"], json.dumps(m, sort_keys=True))
                    for m in t_obs.snapshot() if m["name"] in names)
    assert [s[0] for s in snap_t] == sorted(names)
    assert snap_t == snap_j
    assert t_obs.registry().total("engine.ticks") > 0


def test_solve_slot_span_and_no_dispatch_on_the_cpu():
    """solve_slot opens one span per call, labelled by the backend that
    runs (the plain one on the CPU, masked or not), never the reference's
    traces counter; the plain versions count no dispatch."""
    tab = t_prof.EdgeSystem(n_cameras=6, n_servers=2, n_slots=2).horizon(
        1, device="cpu")
    args = (tab.acc[0], tab.xi, tab.size, tab.eff,
            torch.tensor([0, 1, 0, 1, 0, 1], dtype=torch.int32),
            tab.budgets_b[0], tab.budgets_c[0], 0.5, 10.0)
    t_bcd.solve_slot(*args, n_servers=2)
    t_bcd.solve_slot(*args, n_servers=2, solver_backend="torch:nofuse",
                     active=torch.tensor([1.0, 0, 1, 1, 1, 1]))
    spans = [e for e in t_obs.events() if e["name"] == "bcd.solve_slot"]
    assert len(spans) == 2
    assert [e["args"]["solver_backend"] for e in spans] == ["torch"] * 2
    assert spans[0]["args"]["n_cameras"] == 6
    hist = t_obs.registry().get("bcd.solve_slot.seconds",
                                solver_backend="torch")
    assert hist.count == 2
    assert t_obs.registry().collect("bcd.solve_slot.traces") == []
    assert t_obs.registry().collect("obs.dispatch.count") == []
