"""The port's entry points in ``examples/*_torch.py`` and
``scripts/hillclimb_torch.py``, run on the CPU at small sizes and held
against the JAX package's functions that the reference scripts call,
with the same arguments (the reference scripts themselves take minutes
here, and print rounded numbers).

Bars: AoPI, accuracy and queue values within 1e-3 relative; island loads,
policies and fault counters exactly. ``train_e2e_torch`` draws its
parameters with ``torch.Generator``, not threefry, so its losses are not
the reference's: its parameter count is held exactly, and its losses
must be finite. The hill-climb runner counts one reduced cell with and
without ``{"act_seq": "model"}``.
"""
import contextlib
import dataclasses
import importlib.util
import io
import math
import pathlib

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REL = 1e-3


def _load(path: str):
    """A script of the repo as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *a, **k):
    """``fn``'s return value, its printed lines captured."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        value = fn(*a, **k)
    return value, out.getvalue()


def _close(got, want, rel=REL):
    assert got == pytest.approx(want, rel=rel), (got, want)


# The quickstart's horizon here (25 in the script).
QUICK_SLOTS = 8


def test_quickstart():
    from repro.core import aopi, baselines, lbcd, profiles, queues
    got, text = _quiet(_load("examples/quickstart_torch.py").main, "cpu",
                       n_slots=QUICK_SLOTS)
    assert "Theorem 3 threshold" in text and "V sweep" in text
    lam, mu, p = 5.0, 10.0, 0.8
    _close(got["a_f"], float(aopi.aopi_fcfs(lam, mu, p)))
    _close(got["a_l"], float(aopi.aopi_lcfsp(lam, mu, p)))
    _close(got["threshold"], float(aopi.policy_threshold(lam / mu)))
    assert got["lcfsp"] == bool(aopi.optimal_policy(lam, mu, p))
    # The numpy oracle is a copy: the same draws.
    assert got["sim_f"] == queues.simulate_fcfs(lam, mu, p,
                                                200_000).mean_aopi
    assert got["sim_l"] == queues.simulate_lcfsp(lam, mu, p,
                                                 200_000).mean_aopi

    def system():
        return profiles.EdgeSystem(n_cameras=20, n_servers=3,
                                   n_slots=QUICK_SLOTS,
                                   mean_bandwidth_hz=15e6,
                                   mean_compute_flops=25e12, seed=0)
    s = lbcd.LBCDController(system(), v=10.0, p_min=0.7).run(QUICK_SLOTS)
    _close(got["LBCD"][0], s.mean_aopi)
    _close(got["LBCD"][1], s.mean_acc)
    for name in ("MIN", "DOS", "JCAB"):
        b = baselines.make(name, system()).run(QUICK_SLOTS)
        _close(got[name][0], b.mean_aopi)
        _close(got[name][1], b.mean_acc)
    grid = lbcd.rollout_grid(system().horizon(QUICK_SLOTS),
                             jnp.asarray([1.0, 10.0, 100.0]),
                             jnp.asarray([0.7, 0.7, 0.7]))
    for g, (a, c) in enumerate(got["grid"]):
        _close(a, float(grid.aopi[g].mean()))
        _close(c, float(grid.acc[g].mean()))


def test_failover_demo():
    from repro.core import lbcd, profiles
    from repro.training.failure import failover_assignment
    got, text = _quiet(_load("examples/failover_demo_torch.py").main, "cpu")
    assert "(island 1 drained)" in text
    ctrl = lbcd.LBCDController(profiles.EdgeSystem(
        n_cameras=16, n_servers=4, n_slots=12, seed=0), v=10.0, p_min=0.7)
    want = [ctrl.step(t) for t in range(3)]
    want.append(failover_assignment(ctrl, 3, np.array([False, True, False,
                                                       False])))
    want.append(ctrl.step(4))
    for (aopi_, load), rec in zip(got, want):
        _close(aopi_, rec.mean_aopi)
        assert load == np.bincount(np.asarray(rec.assign),
                                   minlength=4).tolist()
    assert got[3][1][1] == 0


SUITE = ["steady_ar1", "server_outage"]
SUITE_DIMS = dict(n_cameras=6, n_slots=8, n_servers=2)


def test_scenario_suite():
    from repro import scenarios
    got, text = _quiet(_load("examples/scenario_suite_torch.py").main,
                       smoke=True, device="cpu", names=SUITE,
                       dims=SUITE_DIMS)
    assert "sweep backend: loop (1 rank(s))" in text
    assert "worst family" in text
    want = scenarios.sweep(scenarios.suite(SUITE, **SUITE_DIMS), v=10.0,
                           p_min=0.7)
    assert list(got.policies) == list(want.policies)
    for p in want.policies:
        for key in ("aopi", "acc"):
            np.testing.assert_allclose(np.asarray(getattr(got, key)[p]),
                                       np.asarray(getattr(want, key)[p]),
                                       rtol=REL, err_msg=f"{p} {key}")


def test_serve_e2e():
    from repro.core import lbcd, profiles
    from repro.serving import AnalyticsService
    # 150 s epochs (the script's 1,500 s): the CPU's plain data plane
    # walks every frame in Python.
    got, text = _quiet(_load("examples/serve_e2e_torch.py").main,
                       ["--epochs", "2", "--streams", "4", "--device",
                        "cpu"], epoch_duration=150.0)
    assert "mean predicted" in text
    system = profiles.EdgeSystem(n_cameras=4, n_servers=2, n_slots=8,
                                 mean_bandwidth_hz=12e6,
                                 mean_compute_flops=15e12, seed=0)
    svc = AnalyticsService(lbcd.LBCDController(system, v=10.0, p_min=0.7),
                           mode="mm1", epoch_duration=150.0)
    for t, r in enumerate(got):
        w = svc.run_epoch(t)
        for key in ("predicted_aopi", "measured_aopi", "accuracy", "q"):
            _close(getattr(r, key), getattr(w, key))


def test_train_e2e(tmp_path):
    from repro import configs as j_configs
    from repro.models import build as j_build
    args = ["--steps", "2", "--d-model", "64", "--layers", "2", "--batch",
            "2", "--seq", "32", "--vocab", "256", "--device", "cpu",
            "--ckpt", str(tmp_path / "ckpt")]
    got, text = _quiet(_load("examples/train_e2e_torch.py").main, args)
    assert "over 2 steps" in text
    cfg = dataclasses.replace(
        j_configs.get("qwen2.5-3b"), n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=256, vocab=256, head_dim=64, remat="none",
        fsdp=False, dtype="float32")
    assert got["n_params"] == j_build(cfg).param_count()
    assert len(got["losses"]) == 2
    assert all(math.isfinite(x) for x in got["losses"])


def test_hillclimb_runner_counts_the_sp_variant():
    """``hillclimb_torch.measure`` on the reduced dense train cell on a
    (1, 4) mesh, without and with the sequence-parallel residual: the
    second record scatters and gathers the stream, holds less temp
    memory, and both read through the roofline."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import Mesh
    hc = _load("scripts/hillclimb_torch.py")
    assert len(hc.runs()) == 14
    cfg = configs.get("qwen2.5-3b").reduced()
    # Named as a cell of the grid: the roofline reads its tokens by name.
    shape = InputShape("train_4k", 16, 4, "train")
    mesh = Mesh(("data", "model"), (1, 4))
    recs = [hc.measure(name, cfg, shape, kw, mesh, skip_extrapolation=True)
            for name, kw in (("plain", {}), ("sp", {"rule_overrides": {
                "act_seq": "model"}}))]
    for rec in recs:
        assert "error" not in rec, rec.get("traceback")
        assert hc.summary(rec).startswith(rec["variant"] + ": flops=")
    plain, sp = (r["collectives_full_hlo"]["counts"] for r in recs)
    assert plain["reduce-scatter"] == 0 < sp["reduce-scatter"]
    assert recs[1]["memory"]["temp_gib"] < recs[0]["memory"]["temp_gib"]
    assert recs[1]["cost_full_hlo"]["flops"] == \
        recs[0]["cost_full_hlo"]["flops"]


def test_examples_import_neither_jax_nor_repro():
    """Each port entry point's own imports are the port's."""
    import re
    for path in sorted(ROOT.glob("examples/*_torch.py")) + [
            ROOT / "scripts/hillclimb_torch.py"]:
        bad = re.findall(r"^\s*(?:import|from) (jax|repro)\b",
                         path.read_text(), re.M)
        assert not bad, f"{path.name} imports {bad}"
