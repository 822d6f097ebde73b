"""Discrete-event AoPI simulators and the batched GI/G/1 data plane: the
port of the JAX package's ``core/queues.py``.

Three parts:

  * the per-stream **numpy oracle** (``simulate_fcfs`` / ``simulate_lcfsp``),
    copied: it reproduces the paper's frame-uploading model exactly
    (§III-A), the camera uploading a new frame the instant the previous
    one's transmission ends, and integrates the piecewise-linear age
    curve; Theorems 1-2 are its closed forms;
  * the **batched GI/G/1 window** (``gi_g1_window``): every (epoch,
    stream) lane of a plan window simulated at once, the FCFS and LCFSP
    recurrences in one pass over the frame axis with the exact age
    integral truncated at the epoch horizon. Its random draws are the JAX
    package's own: the threefry uniforms of ``core.threefry`` under the
    keys ``fold_in(fold_in(key(seed), t), i)``, element (row j, frame f)
    of a lane's ``[k, F]`` draw at counter ``j * F + f``. On the card one
    ``gi_g1_window`` kernel launch (``kernels/dataplane``) simulates the
    window, its draws made in registers; on the CPU ``_window_sim``, a
    Python loop over frames vectorised over the lanes, does (it is also
    the kernel's plain twin);
  * the **telemetry-fitted delay-model selector** (``fit_delay_model``),
    copied.

The delay families keep the exponential model's mean 1/rate: "uniform"
and "gamma" are lighter-tailed than exponential (the §III-B testbed
regime), "lognormal" and "weibull" heavier.

One difference from the JAX package: the effective horizon
``min(horizon, sum T)`` takes ``sum T`` as the arrival recurrence's own
serial sum (the kernel has no other without storing T), where the
reference reduces ``T`` with XLA. On a lane whose frame budget runs out
before the horizon the two differ by ulps, and the last arrival, which
lies exactly on the port's horizon, may count one frame more here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..device import DEFAULT_DEVICE, resolve_device
from . import threefry

Sampler = Callable[[np.random.Generator, int], np.ndarray]


def _exp_sampler(rate: float) -> Sampler:
    return lambda rng, n: rng.exponential(1.0 / rate, size=n)


@dataclass
class SimResult:
    mean_aopi: float
    horizon: float
    n_frames: int
    n_completed: int
    n_accurate: int

    @property
    def completion_rate(self) -> float:
        return self.n_completed / max(self.horizon, 1e-12)


def _integrate_age(gen_times: np.ndarray, done_times: np.ndarray,
                   accurate: np.ndarray, horizon: float) -> float:
    """Time-average of the age curve. Age resets to ``done - gen`` at each
    *accurate* completion and grows at slope 1 otherwise, from 0 at t=0."""
    d = done_times[accurate]
    g = gen_times[accurate]
    t0 = np.concatenate(([0.0], d))          # segment starts
    age0 = np.concatenate(([0.0], d - g))    # age immediately after reset
    t1 = np.concatenate((d, [horizon]))      # segment ends
    seg = t1 - t0
    area = np.sum(age0 * seg + 0.5 * seg * seg)
    return float(area / horizon)


def simulate_fcfs(lam: float, mu: float, p: float, n_frames: int = 1_000_000,
                  seed: int = 0, t_sampler: Optional[Sampler] = None,
                  o_sampler: Optional[Sampler] = None) -> SimResult:
    """FCFS (x=0): with S_i = cumsum(O)_i,
    finish_i = S_i + running_max_j(arrive_j - S_{j-1})."""
    rng = np.random.default_rng(seed)
    T = (t_sampler or _exp_sampler(lam))(rng, n_frames)
    O = (o_sampler or _exp_sampler(mu))(rng, n_frames)
    gen = np.concatenate(([0.0], np.cumsum(T)))[:-1]   # tau_i
    arrive = gen + T                                    # a_i = tau_{i+1}
    S = np.cumsum(O)
    slack = arrive - np.concatenate(([0.0], S[:-1]))
    finish = S + np.maximum.accumulate(slack)
    acc = rng.random(n_frames) < p
    horizon = float(finish[-1])
    mean_age = _integrate_age(gen, finish, acc, horizon)
    return SimResult(mean_age, horizon, n_frames, n_frames, int(acc.sum()))


def simulate_lcfsp(lam: float, mu: float, p: float, n_frames: int = 1_000_000,
                   seed: int = 0, t_sampler: Optional[Sampler] = None,
                   o_sampler: Optional[Sampler] = None) -> SimResult:
    """LCFSP (x=1): every arrival preempts the frame in service; frame i
    completes iff O_i < T_{i+1}."""
    rng = np.random.default_rng(seed)
    T = (t_sampler or _exp_sampler(lam))(rng, n_frames)
    O = (o_sampler or _exp_sampler(mu))(rng, n_frames)
    gen = np.concatenate(([0.0], np.cumsum(T)))[:-1]
    arrive = gen + T
    nxt = np.concatenate((T[1:], [np.inf]))  # T_{i+1}
    completed = O < nxt
    finish = arrive + O
    acc = completed & (rng.random(n_frames) < p)
    horizon = float(arrive[-1] + O[-1] * completed[-1])
    mean_age = _integrate_age(gen[completed], finish[completed],
                              acc[completed], horizon)
    return SimResult(mean_age, horizon, n_frames, int(completed.sum()),
                     int(acc.sum()))


def simulate(lam: float, mu: float, p: float, policy: int, **kw) -> SimResult:
    if lam <= 0.0 or mu <= 0.0:
        # Zero-rate stream (churned-out camera): an exactly-zero result.
        return SimResult(0.0, 0.0, 0, 0, 0)
    return (simulate_lcfsp if policy == 1 else simulate_fcfs)(lam, mu, p, **kw)


# ---------------------------------------------------------------------------
# Delay families
# ---------------------------------------------------------------------------

DELAY_MODELS = ("mm1", "uniform", "gamma", "lognormal", "weibull")
UNIFORM_SPREAD = 0.9     # uniform_sampler's default
GAMMA_SHAPE = 2.0        # gamma_sampler's default
LOGNORMAL_SIGMA = 1.0    # lognormal_sampler's default
WEIBULL_SHAPE = 0.7      # weibull_sampler's default (k < 1)

#: Families whose tails overflow the float32 path: their windows always
#: run in float64.
HEAVY_TAIL_MODELS = frozenset({"lognormal", "weibull"})

#: The serving layer's sentinel for "fit the family from telemetry"
#: (``fit_delay_model``); ``gi_g1_window`` needs a concrete family.
AUTO_DELAY_MODEL = "auto"


def uniform_sampler(mean: float, spread: float = UNIFORM_SPREAD) -> Sampler:
    """Uniform on [mean*(1-spread), mean*(1+spread)]."""
    lo, hi = mean * (1 - spread), mean * (1 + spread)
    return lambda rng, n: rng.uniform(lo, hi, size=n)


def gamma_sampler(mean: float, shape: float = GAMMA_SHAPE) -> Sampler:
    return lambda rng, n: rng.gamma(shape, mean / shape, size=n)


def lognormal_sampler(mean: float, sigma: float | None = None) -> Sampler:
    """Lognormal ``exp(N(m, sigma^2))`` with ``m = ln(mean) - sigma^2/2``,
    so its mean is ``mean``."""
    sigma = LOGNORMAL_SIGMA if sigma is None else sigma
    m = np.log(mean) - 0.5 * sigma * sigma
    return lambda rng, n: rng.lognormal(m, sigma, size=n)


def weibull_sampler(mean: float, shape: float | None = None) -> Sampler:
    """Weibull ``scale * W(k)`` with ``scale = mean / Gamma(1 + 1/k)``."""
    shape = WEIBULL_SHAPE if shape is None else shape
    scale = mean / math.gamma(1.0 + 1.0 / shape)
    return lambda rng, n: scale * rng.weibull(shape, size=n)


def validate_delay_model(delay_model: str, *, allow_auto: bool = False) -> str:
    """Return ``delay_model`` if it names a family (or ``"auto"`` where the
    caller accepts it); raise ``ValueError`` listing them otherwise."""
    known = DELAY_MODELS + ((AUTO_DELAY_MODEL,) if allow_auto else ())
    if delay_model not in known:
        raise ValueError(
            f"unknown delay_model {delay_model!r}; known: {known}")
    return delay_model


def oracle_samplers(delay_model: str, lam: float, mu: float) -> dict:
    """``t_sampler``/``o_sampler`` for a family (empty for "mm1": the
    callers then draw exponentials)."""
    validate_delay_model(delay_model)
    if delay_model == "mm1":
        return {}
    makers = {"uniform": uniform_sampler, "gamma": gamma_sampler,
              "lognormal": lognormal_sampler, "weibull": weibull_sampler}
    make = makers[delay_model]
    return dict(t_sampler=make(1.0 / lam), o_sampler=make(1.0 / mu))


# ---------------------------------------------------------------------------
# Batched GI/G/1 window
# ---------------------------------------------------------------------------

#: +1 per batched window (one kernel launch on the card, one plain loop
#: on the CPU).
BATCH_DISPATCHES = 0


def stream_seed_sequence(seed: int, t: int, i: int) -> np.random.SeedSequence:
    """Collision-free numpy RNG stream for (epoch ``t``, stream ``i``):
    ``SeedSequence(entropy=seed, spawn_key=(t, i))``."""
    return np.random.SeedSequence(entropy=seed, spawn_key=(t, i))


def epoch_key(seed: int, t: int) -> torch.Tensor:
    """Threefry key of epoch ``t`` (int64 ``[2]``); streams fold in their
    index on top, so (epoch, stream) keys never collide."""
    return threefry.fold_in(threefry.key(seed), t)


def frames_budget(max_lam: float, horizon: float, frames_cap: int,
                  frames_floor: int = 200) -> int:
    """Frames so arrivals cover ``[0, horizon]`` w.h.p. for the fastest
    stream: ``lam*H`` plus a 2-sigma margin, rounded up to a
    quarter-power-of-two bucket, capped at ``frames_cap``, at least
    ``frames_floor``."""
    need = float(max_lam) * float(horizon)
    need = max(need + 2.0 * np.sqrt(max(need, 1.0)) + 16.0,
               float(frames_floor), 2.0)
    p2 = 2.0 ** np.floor(np.log2(need))
    for m in (1.0, 1.25, 1.5, 1.75, 2.0):
        if p2 * m >= need:
            return int(min(np.ceil(p2 * m), frames_cap))
    raise AssertionError("unreachable")


#: Windows of at most this many frames per stream run in float32 (light
#: tails only); longer ones, and every heavy tail, in float64.
F32_MAX_FRAMES = 1024

#: Streams per epoch whose raw transmission delays ``collect_samples``
#: returns.
SAMPLE_STREAM_CAP = 32


def _n_uniforms(delay_model: str) -> int:
    """Uniforms per frame: T + O + the accuracy coin; the Erlang-``k``
    gamma family takes ``k`` per delay."""
    if delay_model == "gamma" and float(GAMMA_SHAPE) == int(GAMMA_SHAPE):
        return 2 * int(GAMMA_SHAPE) + 1
    return 3


def _delays_from_uniforms(u: torch.Tensor, mean: torch.Tensor,
                          delay_model: str) -> torch.Tensor:
    """``u`` ``[k, ...]`` uniforms -> positive delays ``[...]`` of mean
    ``mean``, in the reference's operation order."""
    if delay_model == "mm1":
        return -torch.log1p(-u[0]) * mean
    if delay_model == "uniform":
        lo = mean * (1.0 - UNIFORM_SPREAD)
        return lo + u[0] * (2.0 * UNIFORM_SPREAD * mean)
    if delay_model == "gamma":
        k = int(GAMMA_SHAPE)
        if float(GAMMA_SHAPE) == k:
            # Erlang-k: the sum of k exponentials, added in row order.
            logs = torch.log1p(-u)
            acc = logs[0]
            for j in range(1, u.shape[0]):
                acc = acc + logs[j]
            return -acc * (mean / GAMMA_SHAPE)
    if delay_model == "lognormal":
        uc = torch.clamp(u[0], 1e-7, 1.0 - 1e-7)
        m = torch.log(mean) - 0.5 * LOGNORMAL_SIGMA * LOGNORMAL_SIGMA
        return torch.exp(m + LOGNORMAL_SIGMA * torch.special.ndtri(uc))
    if delay_model == "weibull":
        # The scale is a product with 1 / Gamma(1 + 1/k): what PyTorch's
        # CUDA division by a scalar computes, so every device agrees.
        scale = mean * (1.0 / math.gamma(1.0 + 1.0 / WEIBULL_SHAPE))
        return scale * torch.pow(-torch.log1p(-u[0]), 1.0 / WEIBULL_SHAPE)
    raise ValueError(
        f"unknown delay_model {delay_model!r}; known: {DELAY_MODELS}")


def stream_keys(keys: torch.Tensor, n_streams: int) -> torch.Tensor:
    """Per-lane keys ``[E * N, 2]`` from the epoch keys ``[E, 2]``: lane
    ``e * N + i`` has ``fold_in(keys[e], i)``."""
    idx = torch.arange(n_streams, dtype=torch.int64, device=keys.device)
    return threefry.fold_in(keys[:, None, :], idx[None, :]).reshape(-1, 2)


def draw_window(lam: torch.Tensor, mu: torch.Tensor, lane_keys: torch.Tensor,
                n_frames: int, delay_model: str):
    """Every lane's transmission times, service times and coins ``[F, L]``
    from its ``[k, F]`` threefry draw (``lam``/``mu`` ``[L]``)."""
    k = _n_uniforms(delay_model)
    ku, ko = k // 2, (k - 1) - k // 2
    u = threefry.uniform(lane_keys, (k, n_frames), lam.dtype)  # [L, k, F]
    u = u.permute(1, 2, 0)                                     # [k, F, L]
    T = _delays_from_uniforms(u[:ku], 1.0 / lam, delay_model)
    O = _delays_from_uniforms(u[ku:ku + ko], 1.0 / mu, delay_model)
    return T, O, u[-1]


def _window_sim(lam, mu, p, pol, keys, horizon: float, n_frames: int,
                delay_model: str, collect_samples: int = 0) -> dict:
    """The plain window: ``lam``/``mu``/``p`` ``[E, N]`` in the window's
    float type, ``pol`` ``[E, N]`` int, ``keys`` the epoch keys ``[E, 2]``.
    One Python loop over frames (after one that sums the arrivals),
    vectorised over the ``E * N`` lanes, in the operation order of the
    reference's ``lax.scan`` step and of the ``gi_g1_window`` kernel.
    Returns tensors: ``aopi``/``horizon``/``n_frames``/``n_completed``/
    ``n_accurate`` ``[E, N]`` and, with ``collect_samples``,
    ``delay_samples`` ``[E, min(N, SAMPLE_STREAM_CAP), capf]``."""
    e, n = lam.shape
    dtype, dev = lam.dtype, lam.device
    lam, mu, p = lam.reshape(-1), mu.reshape(-1), p.reshape(-1)
    is_lcfsp = pol.reshape(-1) == 1
    T, O, coin = draw_window(lam, mu, stream_keys(keys, n), n_frames,
                             delay_model)
    zero = torch.zeros(e * n, dtype=dtype, device=dev)
    total = zero
    for f in range(n_frames):
        total = total + T[f]
    h_eff = torch.minimum(torch.full_like(total, horizon), total)
    inf = torch.full_like(zero, math.inf)
    a = s = last_t = age0 = area = n_arr = n_done = n_acc = zero
    m = -inf
    for f in range(n_frames):
        t_f, o_f, u_f = T[f], O[f], coin[f]
        t_nxt = T[f + 1] if f + 1 < n_frames else inf
        a = a + t_f                            # arrival a_i = tau_{i+1}
        gen = a - t_f                          # generation tau_i
        s = s + o_f                            # cumsum of service times
        m = torch.maximum(m, a - (s - o_f))    # running max idle slack
        finish = torch.where(is_lcfsp, a + o_f, s + m)
        completed = torch.where(is_lcfsp, o_f < t_nxt, True)
        done = completed & (finish <= h_eff)
        valid = done & (u_f < p)
        seg = torch.where(valid, finish - last_t, zero)
        area = area + age0 * seg + 0.5 * seg * seg
        last_t = torch.where(valid, finish, last_t)
        age0 = torch.where(valid, finish - gen, age0)
        n_arr = n_arr + (a <= h_eff)
        n_done = n_done + done
        n_acc = n_acc + valid
    seg = torch.maximum(h_eff - last_t, zero)
    area = area + age0 * seg + 0.5 * seg * seg
    out = {"aopi": (area / h_eff).reshape(e, n),
           "horizon": h_eff.reshape(e, n),
           "n_frames": n_arr.reshape(e, n),
           "n_completed": n_done.reshape(e, n),
           "n_accurate": n_acc.reshape(e, n)}
    if collect_samples:
        capf = min(int(collect_samples), n_frames)
        ns = min(n, SAMPLE_STREAM_CAP)
        samp = T[:capf].reshape(capf, e, n)[:, :, :ns]
        out["delay_samples"] = samp.permute(1, 2, 0)       # [E, ns, capf]
    return out


def gi_g1_window(lam, mu, p, pol, *, seed: int = 0, t0: int = 0,
                 n_frames: int, horizon: float,
                 delay_model: str = "mm1", active=None,
                 collect_samples: int = 0, device=DEFAULT_DEVICE) -> dict:
    """Simulate ``[E, N]`` GI/G/1 streams (E epochs x N streams) as one
    window on ``device``: one ``gi_g1_window`` kernel launch on the card,
    the plain ``_window_sim`` on the CPU.

    Per (epoch ``t0+e``, stream ``i``): ``n_frames`` transmission/service
    delays from ``delay_model`` with means ``1/lam``/``1/mu`` under the key
    ``fold_in(fold_in(key(seed), t), i)``, both queueing recurrences, and
    the exact age integral truncated at ``horizon`` (or at the lane's last
    arrival, if its frame budget runs out first; the per-lane effective
    horizon is returned). Rates are clamped at 1e-6 and ``p`` to
    [1e-3, 1]. Dead lanes (``lam <= 0``, ``mu <= 0`` or masked out by
    ``active`` ``[E, N]``) run on the clamped stand-ins and are zeroed in
    every output. Up to ``F32_MAX_FRAMES`` frames a light-tailed window
    runs in float32, otherwise in float64. ``collect_samples > 0`` also
    returns ``delay_samples`` ``[E, min(N, SAMPLE_STREAM_CAP),
    collect_samples]``, the raw transmission draws. Returns host float64
    numpy ``[E, N]`` arrays ``aopi``/``horizon``/``n_frames``/
    ``n_completed``/``n_accurate``.
    """
    from ..kernels.dataplane import ops
    validate_delay_model(delay_model)
    global BATCH_DISPATCHES
    dev = resolve_device(device)
    n_frames = int(n_frames)
    use_f64 = n_frames > F32_MAX_FRAMES or delay_model in HEAVY_TAIL_MODELS
    dtype = np.float64 if use_f64 else np.float32
    lam = np.atleast_2d(np.asarray(lam, dtype))
    mu_h = np.atleast_2d(np.asarray(mu, dtype))
    live = (lam > 0.0) & (mu_h > 0.0)
    if active is not None:
        live = live & (np.atleast_2d(np.asarray(active)) > 0.0)
    e, n = lam.shape
    obs.histogram("queues.batch_elems",
                  delay_model=delay_model).observe(e * n * n_frames)
    with obs.span("queues.gi_g1_window", delay_model=delay_model,
                  epochs=e, streams=n, n_frames=n_frames):
        # The epoch keys on the host (a few dozen small operations), then
        # one copy.
        keys = threefry.fold_in(threefry.key(seed), torch.arange(
            t0, t0 + e, dtype=torch.int64)).to(dev)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        out = ops.gi_g1_window(
            put(np.maximum(lam, dtype(1e-6))),
            put(np.maximum(mu_h, dtype(1e-6))),
            put(np.clip(np.atleast_2d(np.asarray(p, dtype)), 1e-3, 1.0)),
            put(np.atleast_2d(np.asarray(pol, np.int32))),
            keys, float(horizon), n_frames, str(delay_model),
            int(collect_samples))
        out = {k: v.cpu().numpy().astype(np.float64)
               for k, v in out.items()}
        if not live.all():
            # Dead lanes ran on clamped stand-in rates: zero them out.
            samples = out.pop("delay_samples", None)
            out = {k: np.where(live, v, 0.0) for k, v in out.items()}
            if samples is not None:
                ns = samples.shape[1]
                out["delay_samples"] = np.where(
                    live[:, :ns, None], samples, 0.0)
    BATCH_DISPATCHES += 1
    obs.counter("queues.batch_dispatches", delay_model=delay_model).inc()
    return out


# ---------------------------------------------------------------------------
# Telemetry-fitted delay-model selector
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DelayFit:
    """The winning family of :func:`fit_delay_model`, the per-family
    Cramér–von Mises residuals (smaller = closer) and the winner's fitted
    shape (``{"sigma": ...}`` for lognormal, ``{"k": ...}`` for weibull)."""
    model: str
    residuals: dict
    n_samples: int
    params: dict = field(default_factory=dict)


#: CvM estimation grids of the shape-parameterized families; the defaults
#: are grid members, and the weibull grid stays below k=1 (mm1's).
LOGNORMAL_SIGMA_GRID = (0.5, 0.75, 1.0, 1.25, 1.5)
WEIBULL_SHAPE_GRID = (0.5, 0.6, 0.7, 0.8, 0.9)

_FAMILY_GRIDS = {"lognormal": ("sigma", LOGNORMAL_SIGMA_GRID),
                 "weibull": ("k", WEIBULL_SHAPE_GRID)}


def _family_cdf(x: np.ndarray, delay_model: str,
                params: dict | None = None) -> np.ndarray:
    """CDF of the unit-mean member of ``delay_model`` at ``x`` (x >= 0);
    ``params`` overrides the shape (``sigma`` / ``k``)."""
    params = params or {}
    if delay_model == "mm1":
        return -np.expm1(-x)
    if delay_model == "uniform":
        lo, width = 1.0 - UNIFORM_SPREAD, 2.0 * UNIFORM_SPREAD
        return np.clip((x - lo) / width, 0.0, 1.0)
    if delay_model == "gamma":
        # Erlang-k with mean 1 => rate k. Closed form for integer k.
        k = int(GAMMA_SHAPE)
        terms = sum((k * x) ** j / math.factorial(j) for j in range(k))
        return -np.expm1(-k * x) - np.exp(-k * x) * (terms - 1.0)
    if delay_model == "lognormal":
        from scipy.special import ndtr
        s = float(params.get("sigma", LOGNORMAL_SIGMA))
        m = -0.5 * s * s
        safe = np.maximum(x, 1e-300)
        return np.where(x > 0.0, ndtr((np.log(safe) - m) / s), 0.0)
    if delay_model == "weibull":
        k = float(params.get("k", WEIBULL_SHAPE))
        scale = 1.0 / math.gamma(1.0 + 1.0 / k)
        return -np.expm1(-np.power(np.maximum(x, 0.0) / scale, k))
    raise ValueError(
        f"unknown delay_model {delay_model!r}; known: {DELAY_MODELS}")


def family_cv2(delay_model: str, params: dict | None = None) -> float:
    """Squared coefficient of variation of a delay family (optionally at a
    fitted shape): 1 for mm1, < 1 for the light families, > 1 for the
    heavy tails."""
    validate_delay_model(delay_model)
    params = params or {}
    if delay_model == "mm1":
        return 1.0
    if delay_model == "uniform":
        return UNIFORM_SPREAD ** 2 / 3.0
    if delay_model == "gamma":
        return 1.0 / float(GAMMA_SHAPE)
    if delay_model == "lognormal":
        s = float(params.get("sigma", LOGNORMAL_SIGMA))
        return float(np.expm1(s * s))
    k = float(params.get("k", WEIBULL_SHAPE))
    g1 = math.gamma(1.0 + 1.0 / k)
    return math.gamma(1.0 + 2.0 / k) / (g1 * g1) - 1.0


def residual_prior(delay_model: str, params: dict | None = None) -> float:
    """Kingman-style residual prior ``(1 + cv^2) / 2`` of a family:
    exactly 1 for mm1."""
    return 0.5 * (1.0 + family_cv2(delay_model, params))


def fit_delay_model(samples, models: Sequence[str] = DELAY_MODELS,
                    min_samples: int = 8) -> DelayFit:
    """The (family, shape) with the smallest Cramér–von Mises residual
    against positive delay samples (zeros dropped), each family
    mean-matched to the sample mean, the shaped ones minimized over their
    grids. "mm1" below ``min_samples`` observations."""
    x = np.asarray(samples, np.float64).ravel()
    x = x[np.isfinite(x) & (x > 0.0)]
    n = x.size
    if n < min_samples:
        return DelayFit("mm1", {}, n)
    x = np.sort(x) / x.mean()                 # mean-matched, unit scale
    ecdf = (np.arange(1, n + 1) - 0.5) / n
    cvm = lambda m, prm: float(np.mean((_family_cdf(x, m, prm) - ecdf) ** 2))
    residuals: dict = {}
    params: dict = {}
    for m in models:
        grid = _FAMILY_GRIDS.get(m)
        if grid is None:
            residuals[m], params[m] = cvm(m, None), {}
        else:
            pname, values = grid
            cand = {v: cvm(m, {pname: v}) for v in values}
            v = min(cand, key=cand.get)
            residuals[m], params[m] = cand[v], {pname: float(v)}
    best = min(residuals, key=residuals.get)
    return DelayFit(best, residuals, n, params[best])
