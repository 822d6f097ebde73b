"""Delay families of the frame-uploading model: what the engine plane
needs of the JAX package's ``core/queues.py`` (its lines 148-246), copied.

Per stream, the engine plane draws transmission and service delays from
one of ``DELAY_MODELS`` under the collision-free numpy stream
``stream_seed_sequence(seed, t, i)``; ``oracle_samplers`` maps a family
to its samplers. Every family keeps the exponential model's mean 1/rate:
"uniform" and "gamma" are lighter-tailed than exponential, "lognormal"
and "weibull" heavier. The batched GI/G/1 simulator (``gi_g1_window``),
``frames_budget`` and ``fit_delay_model`` are not ported yet (ROADMAP
queue 1 item 7).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

Sampler = Callable[[np.random.Generator, int], np.ndarray]

DELAY_MODELS = ("mm1", "uniform", "gamma", "lognormal", "weibull")
UNIFORM_SPREAD = 0.9     # uniform_sampler's default
GAMMA_SHAPE = 2.0        # gamma_sampler's default
LOGNORMAL_SIGMA = 1.0    # lognormal_sampler's default
WEIBULL_SHAPE = 0.7      # weibull_sampler's default (k < 1)
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


def stream_seed_sequence(seed: int, t: int, i: int) -> np.random.SeedSequence:
    """Collision-free numpy RNG stream for (epoch ``t``, stream ``i``):
    ``SeedSequence(entropy=seed, spawn_key=(t, i))``."""
    return np.random.SeedSequence(entropy=seed, spawn_key=(t, i))
