"""The port's serving launcher (``python -m repro_torch.launch.serve``)
held against the JAX package's on the CPU, in both modes: the same flags
and defaults, the same table, each epoch within the service's bars
(tests/test_torch_service.py: decisions equal, predicted AoPI and
accuracy at the rollout contract, measured AoPI per stream within the
data plane's bar plus the rate gap the two planners leave)."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import queues as j_queues  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch.core import queues as t_queues  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.serving import service as t_service  # noqa: E402
from test_torch_service import _compare, _decisions, _record  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARGV = ["--streams", "4", "--islands", "2", "--epochs", "2"]


def _table(out):
    """The launcher's table: per-epoch (t, predicted, measured, accuracy,
    q) and the closing means."""
    lines = out.strip().splitlines()
    assert lines[0].split() == ["epoch", "pred-AoPI", "meas-AoPI", "acc",
                                "q"]
    rows = np.array([[float(v) for v in ln.split()] for ln in lines[1:-2]])
    assert lines[-2] == ""
    tail = lines[-1].replace("(", "").replace(")", "").split()
    return rows, (float(tail[3]), float(tail[6]))


def _run_pair(monkeypatch, capsys, argv):
    """Both launchers on ``argv`` (the reference's through ``sys.argv``),
    with their services, windows and decisions recorded."""
    rec = {"j": [], "t": [], "dj": [], "dt": []}
    _record(monkeypatch, j_queues, rec["j"])
    _record(monkeypatch, t_queues, rec["t"])
    _decisions(monkeypatch, j_service.AnalyticsService, rec["dj"])
    _decisions(monkeypatch, t_service.AnalyticsService, rec["dt"])
    made = []

    class Recorded(j_service.AnalyticsService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(j_serve, "AnalyticsService", Recorded)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    out_j = capsys.readouterr().out
    st = t_serve.main(argv, device="cpu")
    out_t = capsys.readouterr().out
    (sj,) = made
    return sj, st, out_j, out_t, rec


@pytest.mark.parametrize("engine", [False, True], ids=["mm1", "engine"])
def test_launcher_matches_reference(monkeypatch, capsys, engine):
    argv = ARGV + (["--engine"] if engine else [])
    sj, st, out_j, out_t, rec = _run_pair(monkeypatch, capsys, argv)
    print(out_t)
    assert st.device == torch.device("cpu")
    assert st.controller.device == torch.device("cpu")
    assert st.mode == sj.mode == ("engine" if engine else "mm1")
    assert st.epoch_duration == sj.epoch_duration == (3.0 if engine
                                                      else 1200.0)
    if engine:
        # 4 streams x the engine cap: the event-driven plane, so the real
        # Engine serves the frames (a "scan" resolution would ignore it).
        assert st.engine_backend == sj.engine_backend == "des"
        assert type(st.engine).__name__ == "Engine"
        assert st.engine.n_lanes == 8 and st.engine.max_len == 96
        assert st.engine.decode_tokens == 2
        assert st.engine.model.cfg.name.startswith("qwen2.5-3b")
    worst, gap = _compare(sj, st, sj.reports, st.reports, rec,
                          engine=engine)
    rows_j, means_j = _table(out_j)
    rows_t, means_t = _table(out_t)
    assert rows_t.shape == rows_j.shape == (2, 5)
    np.testing.assert_array_equal(rows_t[:, 0], [0, 1])
    # The printed digits: each column within its bar plus half a unit of
    # its last printed digit.
    meas_bar = (1e-9 if engine else 1e-4) + 10 * gap
    for col, rtol, unit in ((1, 5e-3, 1e-4), (2, meas_bar, 1e-4),
                            (3, 1e-3, 1e-3), (4, 1e-3, 1e-2)):
        np.testing.assert_allclose(rows_t[:, col], rows_j[:, col],
                                   rtol=rtol, atol=0.5 * unit + 1e-4 *
                                   (col == 4), err_msg=f"column {col}")
    np.testing.assert_allclose(means_t, means_j, rtol=max(5e-3, meas_bar),
                               atol=0.5e-4)
    assert all(np.isfinite(r.measured_aopi) for r in st.reports)
    print(f"max rel measured diff {worst:.3e}, max rate gap {gap:.3e}")


def test_launcher_engine_at_its_defaults_fails_in_both(monkeypatch):
    """Pins a fault of the reference that the port follows: ``--engine``
    at the launcher's own defaults (16 streams) builds an 8-lane engine,
    and the engine rung pins one lane per stream, so the first epoch
    raises in both packages (ROADMAP section 3)."""
    argv = ["--engine", "--epochs", "1"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(ValueError, match="8 lanes < 16 streams"):
        j_serve.main()
    with pytest.raises(ValueError, match="8 lanes < 16 streams"):
        t_serve.main(argv, device="cpu")


def test_launcher_defaults_and_device():
    """The reference's flags and defaults; ``--device`` defaults to the
    card, and without one the launcher raises instead of running on the
    CPU."""
    args = t_serve.parse_args([])
    assert (args.streams, args.islands, args.epochs, args.engine, args.v,
            args.p_min, args.bandwidth_mhz, args.tflops, args.device) == (
        16, 4, 8, False, 10.0, 0.7, 12.0, 15.0, "cuda")
    assert t_serve.parse_args([], device="cpu").device == "cpu"
    assert t_serve.parse_args(["--device", "cpu"]).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_serve.main(["--epochs", "1"])
    # The CLI defaults' engine rung resolves to the DES too: 16 streams x
    # the engine cap is within AUTO_DES_MAX_FRAMES.
    svc = t_serve.build_service(t_serve.parse_args(
        ["--engine", "--device", "cpu"]), engine=object())
    assert svc.engine_backend == "des"
    assert svc.controller.system.n_cameras == 16


def test_launcher_runs_as_a_module():
    """``python -m repro_torch.launch.serve`` reaches the launcher's
    parser, importing no JAX."""
    code = ("import runpy, sys; sys.argv = ['serve', '--help']\n"
            "try:\n    runpy.run_module('repro_torch.launch.serve', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\nassert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(SRC)}, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "python -m repro_torch.launch.serve" in proc.stdout
    for flag in ("--streams", "--islands", "--epochs", "--engine", "--v",
                 "--p-min", "--bandwidth-mhz", "--tflops", "--device"):
        assert flag in proc.stdout
