"""The port's GI/G/1 data plane (``core.threefry``, ``core.queues``,
``serving.service.measure_window``) held against the JAX package on the
CPU: threefry bit for bit, the numpy oracle and the delay-model selector
exactly, the batched window to tight float tolerances on the same random
process, and the port's own runs against Theorems 1-2. On the card
(kernel against plain version): tests/test_torch_gpu.py."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import aopi as j_aopi  # noqa: E402
from repro.core import queues as j_queues  # noqa: E402
from repro.serving import service as j_service  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core import aopi as t_aopi  # noqa: E402
from repro_torch.core import queues as t_queues  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.kernels.dataplane import kernel as dp_kernel  # noqa: E402
from repro_torch.serving import service as t_service  # noqa: E402

#: The two frame budgets this file runs the reference's window at (one
#: float32 window, one float64).
F32_FRAMES, F64_FRAMES = 640, 1280
#: aopi/horizon bars against the reference: its float32 window differs by
#: the rounding of log1p and friends (XLA's against PyTorch's), its
#: float64 one the same (test_dataplane.py's batching-invariance rtol).
RTOL = {np.float32: 1e-4, np.float64: 1e-9}
COUNTS = ("n_frames", "n_completed", "n_accurate")


# ---------------------------------------------------------------------------
# Threefry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 2**33 + 5])
@pytest.mark.parametrize("rows", [3, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_threefry_uniform_bitwise(seed, rows, dtype):
    """key, fold_in and uniform against jax.random (threefry2x32,
    partitionable bits), a seed past 2^32 included."""
    with jax.enable_x64(True):
        kj = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 3),
                                5)
        uj = np.asarray(jax.random.uniform(kj, (rows, F64_FRAMES), dtype))
        kd = np.asarray(jax.random.key_data(kj))
    kt = threefry.fold_in(threefry.fold_in(threefry.key(seed), 3), 5)
    assert kt.tolist() == kd.tolist()
    ut = threefry.uniform(kt, (rows, F64_FRAMES),
                          torch.float32 if dtype == np.float32
                          else torch.float64).numpy()
    assert ut.dtype == uj.dtype
    np.testing.assert_array_equal(ut.view(np.uint8), uj.view(np.uint8))


def test_threefry_lane_keys_bitwise():
    """The window's per-lane keys: fold_in(fold_in(key(seed), t), i) for a
    block of epochs and streams, as the reference's vmapped folds make
    them (epoch_key included)."""
    with jax.enable_x64(True):
        ke = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(11), jax.numpy.arange(4, 7))
        lanes = jax.vmap(lambda k: jax.vmap(jax.random.fold_in, (None, 0))(
            k, jax.numpy.arange(9)))(ke)
        want = np.asarray(jax.random.key_data(lanes)).reshape(-1, 2)
        e0 = np.asarray(jax.random.key_data(j_queues.epoch_key(11, 4)))
    keys = threefry.fold_in(threefry.key(11), torch.arange(4, 7))
    np.testing.assert_array_equal(t_queues.stream_keys(keys, 9).numpy(),
                                  want)
    np.testing.assert_array_equal(t_queues.epoch_key(11, 4).numpy(), e0)


# ---------------------------------------------------------------------------
# The oracle, the budget and the selector: copies, so exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dm", ["mm1", "uniform", "lognormal"])
@pytest.mark.parametrize("pol", [0, 1])
def test_oracle_equals_reference(dm, pol):
    lam, mu, p = 4.0, 9.0, 0.7
    kw = dict(n_frames=5000, seed=j_queues.stream_seed_sequence(3, 1, 2))
    a = j_queues.simulate(lam, mu, p, pol,
                          **j_queues.oracle_samplers(dm, lam, mu), **kw)
    kw["seed"] = t_queues.stream_seed_sequence(3, 1, 2)
    b = t_queues.simulate(lam, mu, p, pol,
                          **t_queues.oracle_samplers(dm, lam, mu), **kw)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert dataclasses.astuple(t_queues.simulate(0.0, mu, p, pol)) == \
        dataclasses.astuple(j_queues.simulate(0.0, mu, p, pol))


def test_integrate_age_and_budget_equal_reference():
    rng = np.random.default_rng(0)
    gen = np.sort(rng.uniform(0, 50, 40))
    done = gen + rng.uniform(0.1, 1.0, 40)
    acc = rng.random(40) < 0.6
    assert t_queues._integrate_age(gen, done, acc, 60.0) == \
        j_queues._integrate_age(gen, done, acc, 60.0)
    for args in ((61.7, 300.0, 200_000), (135.8, 600.0, 200_000),
                 (1e-3, 100.0, 200_000, 200), (500.0, 400.0, 100_000),
                 (5.0, 20_000.0, 400_000)):
        assert t_queues.frames_budget(*args) == j_queues.frames_budget(*args)
    assert t_queues.frames_budget(135.8, 300.0, 200_000) == 49_152
    assert t_queues.frames_budget(135.8, 600.0, 200_000) == 98_304
    for name in ("F32_MAX_FRAMES", "SAMPLE_STREAM_CAP", "DELAY_MODELS",
                 "HEAVY_TAIL_MODELS", "LOGNORMAL_SIGMA_GRID",
                 "WEIBULL_SHAPE_GRID"):
        assert getattr(t_queues, name) == getattr(j_queues, name), name
    for dm in t_queues.DELAY_MODELS:
        assert t_queues._n_uniforms(dm) == j_queues._n_uniforms(dm)


@pytest.mark.parametrize("dm", ["mm1", "uniform", "gamma", "lognormal",
                                "weibull"])
def test_fit_delay_model_equals_reference(dm):
    rng = np.random.default_rng(17)
    if dm == "mm1":
        x = rng.exponential(0.4, 2048)
    else:
        x = j_queues.oracle_samplers(dm, 2.5, 10.0)["t_sampler"](rng, 2048)
    a, b = j_queues.fit_delay_model(x), t_queues.fit_delay_model(x)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.model == dm
    assert dataclasses.asdict(t_queues.fit_delay_model(np.ones(4))) == \
        dataclasses.asdict(j_queues.fit_delay_model(np.ones(4)))
    for params in (None, {"sigma": 1.25}, {"k": 0.5}):
        assert t_queues.family_cv2(dm, params) == \
            j_queues.family_cv2(dm, params)
        assert t_queues.residual_prior(dm, params) == \
            j_queues.residual_prior(dm, params)
    x = np.linspace(0.0, 3.0, 31)
    np.testing.assert_array_equal(t_queues._family_cdf(x, dm),
                                  j_queues._family_cdf(x, dm))


def test_kernel_family_constants_follow_queues():
    """Every family constant reaches the kernel from ``queues`` at run
    time, in the order of the source's ``Family`` struct; none is a
    literal in the source."""
    (lo, width, shape, half_var, sigma, inv_gamma,
     power) = dp_kernel.family_constants()
    assert lo == 1.0 - t_queues.UNIFORM_SPREAD
    assert width == 2.0 * t_queues.UNIFORM_SPREAD
    assert shape == t_queues.GAMMA_SHAPE
    assert 2 * int(shape) + 1 == t_queues._n_uniforms("gamma")
    assert half_var == 0.5 * t_queues.LOGNORMAL_SIGMA ** 2
    assert sigma == t_queues.LOGNORMAL_SIGMA
    assert power == 1.0 / t_queues.WEIBULL_SHAPE
    assert inv_gamma == pytest.approx(1.0 / 1.2658235060572833, rel=1e-15)
    assert list(dp_kernel.MODELS) == list(t_queues.DELAY_MODELS)
    src = "".join(p.read_text() for p in dp_kernel.SOURCES)
    fields = re.search(r"struct Family \{\s*double ([^;]*);", src).group(1)
    assert [f.strip() for f in fields.split(",")] == [
        "uniform_lo", "uniform_width", "gamma_shape", "lognormal_half_var",
        "lognormal_sigma", "weibull_inv_gamma", "weibull_power"]
    delay = src[src.index("T delay(const Family& fam"):]
    delay = delay[:delay.index("\n}\n")]
    assert "fam.lognormal_sigma" in delay and "fam.gamma_shape" in delay


# ---------------------------------------------------------------------------
# The batched window against the reference's
# ---------------------------------------------------------------------------

def _window_inputs(seed=0, e=3, n=6):
    rng = np.random.default_rng(seed)
    lam = rng.uniform(3.0, 8.0, (e, n))
    mu = rng.uniform(8.0, 15.0, (e, n))
    p = rng.uniform(0.5, 0.9, (e, n))
    pol = rng.integers(0, 2, (e, n))
    lam[0, 1] = 0.0                          # a dead lane
    active = np.ones((e, n))
    active[1, 2] = 0.0                       # a churned-out lane
    return lam, mu, p, pol, active


def _compare_windows(a, b, dtype, label):
    """Counts equal; aopi/horizon/samples within the dtype's bar. Returns
    the largest relative aopi difference."""
    for k in COUNTS:
        np.testing.assert_array_equal(b[k], a[k], err_msg=f"{label} {k}")
    worst = 0.0
    for k in ("aopi", "horizon", "delay_samples"):
        np.testing.assert_allclose(b[k], a[k], rtol=RTOL[dtype], atol=0.0,
                                   err_msg=f"{label} {k}")
    live = a["aopi"] > 0
    worst = float(np.max(np.abs(b["aopi"][live] / a["aopi"][live] - 1.0)))
    return worst


@pytest.mark.parametrize("frames", [F32_FRAMES, F64_FRAMES])
@pytest.mark.parametrize("dm", ["mm1", "uniform", "gamma", "lognormal",
                                "weibull"])
def test_window_matches_reference(dm, frames):
    """Every family in both dtype branches (light tails at 640 frames run
    in float32, everything else in float64), FCFS and LCFSP lanes, a dead
    lane, a churn mask and delay samples; horizons the budget covers. The
    largest relative aopi difference is printed."""
    lam, mu, p, pol, active = _window_inputs()
    horizon = frames / 9.0                 # under every lane's sum of T
    kw = dict(seed=5, t0=2, n_frames=frames, horizon=horizon,
              delay_model=dm, active=active, collect_samples=24)
    a = j_queues.gi_g1_window(lam, mu, p, pol, **kw)
    b = t_queues.gi_g1_window(lam, mu, p, pol, device="cpu", **kw)
    assert set(a) == set(b)
    dtype = (np.float64 if frames > t_queues.F32_MAX_FRAMES
             or dm in t_queues.HEAVY_TAIL_MODELS else np.float32)
    worst = _compare_windows(a, b, dtype, dm)
    print(f"{dm} F={frames} {dtype.__name__}: max rel aopi diff {worst:.3e}")
    assert (b["horizon"][b["aopi"] > 0] == dtype(horizon)).all()
    assert b["n_frames"][0, 1] == 0 and b["aopi"][1, 2] == 0
    assert (b["delay_samples"][0, 1] == 0).all()


def test_window_short_budget_differs_by_one_arrival_at_most():
    """Where the frame budget runs out before the horizon, the effective
    horizon is the sum of T: the port's serial sum and the reference's XLA
    reduction may differ by ulps, and a last arrival sitting exactly on the
    port's horizon is counted (the reference's may lie an ulp below it).
    Everything else keeps the bars."""
    lam, mu, p, pol, active = _window_inputs(seed=1)
    kw = dict(seed=3, t0=0, n_frames=F32_FRAMES, horizon=1e6,
              delay_model="mm1", active=active)
    a = j_queues.gi_g1_window(lam, mu, p, pol, **kw)
    b = t_queues.gi_g1_window(lam, mu, p, pol, device="cpu", **kw)
    np.testing.assert_allclose(b["horizon"], a["horizon"], rtol=1e-6)
    np.testing.assert_allclose(b["aopi"], a["aopi"], rtol=1e-4)
    extra = b["n_frames"] - a["n_frames"]
    assert ((extra == 0) | (extra == 1)).all()
    live = b["horizon"] > 0
    assert (b["n_frames"][live] == F32_FRAMES).all()
    for k in ("n_completed", "n_accurate"):
        np.testing.assert_array_equal(b[k], a[k])


def test_window_batching_invariance():
    """One [E, N] window equals E one-epoch windows: keys depend only on
    (seed, t, i)."""
    lam, mu, p, pol, _ = _window_inputs(seed=2)
    kw = dict(n_frames=F64_FRAMES, horizon=150.0, seed=9, device="cpu")
    win = t_queues.gi_g1_window(lam, mu, p, pol, t0=2, **kw)
    for e in range(3):
        one = t_queues.gi_g1_window(lam[e], mu[e], p[e], pol[e], t0=2 + e,
                                    **kw)
        for k in win:
            np.testing.assert_array_equal(win[k][e], one[k][0], err_msg=k)


def test_measure_window_matches_reference():
    """The service-level window (one budget from the window's fastest
    stream), its telemetry included, and the host loop over the oracle
    exactly."""
    lam, mu, p, pol, _ = _window_inputs(seed=4)
    lam[0, 1] = 4.0
    kw = dict(epoch_duration=120.0, seed=9, t0=2, collect_samples=16)
    ma, ta = j_service.measure_window(lam, mu, p, pol, **kw)
    mb, tb = t_service.measure_window(lam, mu, p, pol, device="cpu", **kw)
    np.testing.assert_allclose(mb, ma, rtol=RTOL[np.float64])
    for x, y in zip(ta, tb):
        for f in ("n_frames", "n_completed"):
            np.testing.assert_array_equal(getattr(y, f), getattr(x, f))
        for f in ("acc_hat", "lam_hat", "mu_hat", "aopi_hat",
                  "delay_samples"):
            np.testing.assert_allclose(getattr(y, f), getattr(x, f),
                                       rtol=RTOL[np.float64], err_msg=f)
    kw = dict(epoch_duration=50.0, seed=3, t=1, delay_model="gamma")
    la, tla = j_service.measure_mm1_loop(lam[0], mu[0], p[0], pol[0], **kw)
    lb, tlb = t_service.measure_mm1_loop(lam[0], mu[0], p[0], pol[0], **kw)
    np.testing.assert_array_equal(lb, la)
    np.testing.assert_array_equal(tlb.mu_hat, tla.mu_hat)


# ---------------------------------------------------------------------------
# The port's own runs against Theorems 1-2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rho,pol,p", [
    (0.5, 0, 0.8), (0.5, 1, 0.8), (0.75, 0, 0.6), (0.25, 1, 0.9)])
def test_window_matches_closed_forms(rho, pol, p):
    """256 independent lanes of one (lam, mu, p, policy), 1,280 frames
    each: their mean measured AoPI is Theorem 1 (FCFS) / 2 (LCFSP) within
    the reference's 10%."""
    mu, lam = 10.0, rho * 10.0
    shape = (4, 64)
    out = t_queues.gi_g1_window(
        np.full(shape, lam), np.full(shape, mu), np.full(shape, p),
        np.full(shape, pol), seed=11, n_frames=F64_FRAMES,
        horizon=0.9 * F64_FRAMES / lam, device="cpu")
    want = float(t_aopi.aopi(torch.tensor(lam), torch.tensor(mu),
                             torch.tensor(p), pol))
    assert want == pytest.approx(float(j_aopi.aopi(lam, mu, p, pol)),
                                 rel=1e-6)
    assert out["aopi"].mean() == pytest.approx(want, rel=0.1)
    assert out["n_frames"].mean() / out["horizon"].mean() == pytest.approx(
        lam, rel=0.05)


def test_non_exponential_families_drift_from_the_theorems():
    """The §III-B regime on the port's own draws: lighter tails measure
    below Theorem 1 under FCFS, heavy tails above."""
    lam, mu, p = 5.0, 10.0, 0.8
    shape = (2, 64)
    want = float(j_aopi.aopi(lam, mu, p, 0))
    means = {}
    for dm in t_queues.DELAY_MODELS:
        out = t_queues.gi_g1_window(
            np.full(shape, lam), np.full(shape, mu), np.full(shape, p),
            np.zeros(shape), seed=4, n_frames=F64_FRAMES, horizon=230.0,
            delay_model=dm, device="cpu")
        means[dm] = out["aopi"].mean()
    assert means["uniform"] < 0.95 * want and means["gamma"] < 0.95 * want
    assert means["lognormal"] > 1.05 * want and means["weibull"] > 1.05 * want
    assert means["mm1"] == pytest.approx(want, rel=0.1)


# ---------------------------------------------------------------------------
# Obs, refusals and the device policy
# ---------------------------------------------------------------------------

def test_window_obs_and_dispatch_counter():
    lam, mu, p, pol, _ = _window_inputs(seed=5)
    t_obs.reset()
    before = t_queues.BATCH_DISPATCHES
    t_queues.gi_g1_window(lam, mu, p, pol, n_frames=256, horizon=20.0,
                          delay_model="gamma", device="cpu")
    assert t_queues.BATCH_DISPATCHES == before + 1
    reg = t_obs.registry()
    assert reg.total("queues.batch_dispatches") == 1
    spans = [e for e in t_obs.events() if e["name"] == "queues.gi_g1_window"]
    assert len(spans) == 1 and spans[0]["args"]["n_frames"] == 256
    hist = [m for m in t_obs.snapshot() if m["name"] == "queues.batch_elems"]
    assert hist[0]["count"] == 1 and hist[0]["labels"]["delay_model"] == \
        "gamma"


def test_window_refusals_and_device(monkeypatch):
    with pytest.raises(ValueError, match="delay_model"):
        t_queues.gi_g1_window([1.0], [2.0], [0.5], [0], n_frames=64,
                              horizon=10.0, delay_model="pareto",
                              device="cpu")
    with pytest.raises(ValueError, match="delay_model"):
        t_service.measure_mm1_loop(np.ones(1), np.ones(1), np.ones(1) * 0.5,
                                   np.zeros(1), delay_model="pareto")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_queues.gi_g1_window([1.0], [2.0], [0.5], [0], n_frames=64,
                              horizon=10.0)


def test_data_plane_imports_neither_jax_nor_repro():
    """The data plane, the service and replay import, and a window and a
    two-epoch service run, with jax and repro unimportable."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "import repro_torch.core.threefry, repro_torch.core.queues, "
        "repro_torch.kernels.dataplane.ops, repro_torch.serving.replay, "
        "repro_torch.serving.tick_plane, repro_torch.scenarios\n"
        "from repro_torch.core import lbcd, profiles, queues\n"
        "from repro_torch.serving import AnalyticsService\n"
        "queues.gi_g1_window([2.0], [5.0], [0.8], [1], n_frames=64, "
        "horizon=10.0, device='cpu')\n"
        "c = lbcd.LBCDController(profiles.EdgeSystem(n_cameras=3, "
        "n_servers=1, n_slots=4), device='cpu')\n"
        "AnalyticsService(c, epoch_duration=2.0, plan_window=2).run(2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    src = Path(__file__).resolve().parent.parent / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
