"""The port's tick-scan engine plane (``serving.tick_plane``) held against
the port's DES (``engine_plane.measure_engine_epoch``) and the JAX
package's scan on the CPU: bitwise, trace included, for every delay
family. On the card (kernel against plain scan): tests/test_torch_gpu.py."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import aopi as j_aopi  # noqa: E402
from repro.serving import tick_plane as j_tick  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core import queues as t_queues  # noqa: E402
from repro_torch.serving import engine_plane as t_plane  # noqa: E402
from repro_torch.serving import make_replay_engine  # noqa: E402
from repro_torch.serving import tick_plane as t_tick  # noqa: E402

CPU = dict(device="cpu")


def _steady(n=6, lam=0.6, mu=2.0, p=0.8):
    pol = (np.arange(n) % 2).astype(np.int64)
    return (np.full(n, lam), np.full(n, mu), np.full(n, p), pol)


def _assert_same(a, b, keys=None):
    keys = sorted(set(a) - {"trace"}) if keys is None else keys
    for k in keys:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
    if "trace" in a:
        assert a["trace"] == b["trace"]


@pytest.mark.parametrize("dm", ["mm1", "uniform", "gamma", "lognormal",
                                "weibull"])
def test_scan_equals_des_and_reference_every_family(dm):
    """The port's scan equals the port's DES and the reference's scan
    bitwise: every statistic, the delay samples and the completion
    trace."""
    lam, mu, p, pol = _steady()
    active = np.array([1, 1, 1, 0, 1, 1], np.float64)
    kw = dict(epoch_duration=120.0, seed=7, t=1, frames_cap=48,
              delay_model=dm, collect_samples=8, collect_trace=True,
              active=active)
    des = t_plane.measure_engine_epoch(make_replay_engine(6, **CPU), lam, mu,
                                       p, pol, **kw)
    scan = t_tick.measure_engine_epoch_scan(lam, mu, p, pol, **CPU, **kw)
    ref = j_tick.measure_engine_epoch_scan(lam, mu, p, pol, **kw)
    assert set(scan) == set(ref)
    _assert_same(ref, scan)
    _assert_same(des, scan, ["aopi", "horizon", "n_frames", "n_completed",
                             "n_accurate", "preempts", "delay_samples"])
    assert des["trace"] == scan["trace"] and len(scan["trace"]) > 0
    assert (scan["n_completed"][active > 0] > 0).all()
    assert scan["n_frames"][3] == 0 and scan["aopi"][3] == 0
    assert scan["preempts"][pol == 1].sum() > 0


def test_window_scan_equals_reference_over_epochs():
    """A [E, N] window (epoch-major trace, occupancy, per-epoch draws) at a
    budget that runs out on some lanes and not on others."""
    rng = np.random.default_rng(3)
    lam = rng.uniform(0.5, 3.0, (3, 5))
    mu = rng.uniform(1.0, 4.0, (3, 5))
    p = rng.uniform(0.4, 0.95, (3, 5))
    pol = rng.integers(0, 2, (3, 5))
    lam[2, 0] = 0.0
    kw = dict(epoch_duration=60.0, seed=2, t0=4, delay_model="gamma",
              frames_cap=96, collect_samples=12, collect_trace=True)
    a = j_tick.measure_engine_window_scan(lam, mu, p, pol, **kw)
    b = t_tick.measure_engine_window_scan(lam, mu, p, pol, **CPU, **kw)
    assert set(a) == set(b)
    _assert_same(a, b)
    assert b["engine_steps"] == 96.0
    assert (b["horizon"] < 60.0).any() and (b["horizon"] == 60.0).any()
    assert ((b["occupancy"] > 0) & (b["occupancy"] <= 1)).sum() >= 14


def test_plain_scan_state_matches_host_cumsum():
    """The plain scan's effective horizon is np.cumsum's last element, and
    its final lane state reproduces the host epilogue."""
    lam, mu, p, pol = _steady(n=4, lam=1.1, mu=1.4)
    T, O, coin = t_plane.draw_streams(lam, mu, np.ones(4, bool),
                                      delay_model="mm1", seed=1, t=0,
                                      frames_cap=64)
    live = torch.tensor([True, True, False, True])
    out = t_tick._tick_scan(torch.from_numpy(T), torch.from_numpy(O),
                            torch.from_numpy(coin), torch.from_numpy(p),
                            torch.from_numpy(pol == 1), live, 40.0)
    want = np.where(live.numpy(), np.minimum(40.0, np.cumsum(T, axis=1)[:,
                                                                      -1]),
                    0.0)
    np.testing.assert_array_equal(out["h_eff"].numpy(), want)
    assert out["n_frames"][2] == 0 and out["area"][2] == 0


def test_scan_statistical_parity_with_closed_forms():
    """The engine rung on the scan backend against Theorems 1-2 (the
    reference's 15% anchor)."""
    lam, mu, p, pol = _steady()
    means = []
    for t in range(3):
        out = t_tick.measure_engine_epoch_scan(
            lam, mu, p, pol, epoch_duration=300.0, seed=5, t=t, **CPU)
        assert out["engine_steps"] > 0
        means.append(out["aopi"])
    got = np.mean(means, axis=0)
    th = np.array([float(j_aopi.aopi(l, m, q, w))
                   for l, m, q, w in zip(lam, mu, p, pol)])
    assert got.mean() == pytest.approx(th.mean(), rel=0.15)
    assert got[pol == 1].mean() < got[pol == 0].mean()


def test_resolve_engine_backend_and_dispatch():
    r = t_tick.resolve_engine_backend
    for args in (("des", 10_000, 10_000), ("scan", 1, 1), ("auto", 5, 192),
                 ("auto", 300, 200_000), ("auto", 64, 64)):
        assert r(args[0], n_streams=args[1], frames_cap=args[2]) == \
            j_tick.resolve_engine_backend(args[0], n_streams=args[1],
                                          frames_cap=args[2])
    assert t_tick.ENGINE_BACKENDS == j_tick.ENGINE_BACKENDS
    assert t_tick.AUTO_DES_MAX_FRAMES == j_tick.AUTO_DES_MAX_FRAMES
    with pytest.raises(ValueError, match="engine_backend"):
        r("vmap", n_streams=1, frames_cap=1)
    lam, mu, p, pol = _steady(n=4)
    kw = dict(epoch_duration=90.0, seed=2, t=0, frames_cap=32)
    a = t_tick.measure_epoch(lam, mu, p, pol, backend="scan", **CPU, **kw)
    b = t_tick.measure_epoch(lam, mu, p, pol, backend="des",
                             engine=make_replay_engine(4, **CPU), **kw)
    np.testing.assert_array_equal(a["aopi"], b["aopi"])
    with pytest.raises(ValueError, match="engine"):
        t_tick.measure_epoch(lam, mu, p, pol, backend="des", **kw)
    with pytest.raises(ValueError, match="delay_model"):
        t_tick.measure_engine_epoch_scan(lam, mu, p, pol, delay_model="x",
                                         epoch_duration=1.0, **CPU)


def test_scan_obs_series():
    """The reference's series: engine.ticks and engine.preempts counters,
    the engine.occupancy histogram and one tick_plane.window span."""
    lam, mu, p, pol = _steady(n=4, lam=1.2, mu=1.5)
    t_obs.reset()
    out = t_tick.measure_engine_epoch_scan(
        lam, mu, p, pol, epoch_duration=60.0, seed=3, t=0, frames_cap=40,
        **CPU)
    reg = t_obs.registry()
    assert reg.total("engine.ticks") == 40.0
    assert reg.total("engine.preempts") == out["preempts"].sum() > 0
    spans = [e for e in t_obs.events() if e["name"] == "tick_plane.window"]
    assert len(spans) == 1 and spans[0]["args"]["n_frames"] == 40
    occ = [m for m in t_obs.snapshot() if m["name"] == "engine.occupancy"]
    assert occ[0]["count"] == 4


def test_scan_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_tick.measure_engine_epoch_scan(*_steady(n=2), epoch_duration=5.0)
    assert t_queues.validate_delay_model("mm1") == "mm1"
