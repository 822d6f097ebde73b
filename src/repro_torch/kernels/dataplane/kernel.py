"""ctypes binding of the data-plane CUDA kernels (``csrc/dataplane.cu``).

The library is built at the first launch (``kernels._build``), never when
this module is imported. Each launcher takes CUDA tensors whose device,
dtype, shape and contiguity the wrappers in ``ops`` have checked, launches
on PyTorch's current stream, and raises if the launch returns an error.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _build
from ...core import queues

SOURCES = (Path(__file__).resolve().parent / "csrc" / "dataplane.cu",)
DTYPES = {torch.float32: 0, torch.float64: 1}
MODELS = {name: i for i, name in enumerate(queues.DELAY_MODELS)}
TICK_CARRY = ("h_eff", "last_t", "age0", "area", "n_frames", "n_completed",
              "n_accurate", "preempts", "busy")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = {
    # dtype, model, keys, lam, mu, p, pol, family (host), horizon,
    # n_lanes, n_frames, n_streams, sample_streams, sample_frames, out,
    # samples, stream
    "dataplane_gi_g1_window": [_I, _I] + [_P] * 6 + [_D] + [_I] * 5 +
                              [_P] * 3,
    # T, O, coin, p, is_lcfsp, live, epoch, n_lanes, n_frames, out, fin,
    # done, stream
    "dataplane_tick_scan": [_P] * 6 + [_D, _I, _I] + [_P] * 4,
}


def family_constants() -> tuple[float, ...]:
    """The delay families' constants the window kernel reads, in the
    order of ``Family`` in the source: the uniform's low end and width per
    unit mean, the gamma shape (an Erlang count), lognormal's sigma^2 / 2
    and sigma, weibull's 1 / Gamma(1 + 1/k) and 1/k. Each is computed as
    ``queues._delays_from_uniforms`` computes it."""
    return (1.0 - queues.UNIFORM_SPREAD, 2.0 * queues.UNIFORM_SPREAD,
            queues.GAMMA_SHAPE,
            0.5 * queues.LOGNORMAL_SIGMA * queues.LOGNORMAL_SIGMA,
            queues.LOGNORMAL_SIGMA,
            1.0 / math.gamma(1.0 + 1.0 / queues.WEIBULL_SHAPE),
            1.0 / queues.WEIBULL_SHAPE)


class _Library:
    """The built shared library, loaded once per process at first use."""
    lib: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.lib is None:
            lib = ctypes.CDLL(str(_build.build("dataplane", SOURCES)))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dataplane_error_string.argtypes = [ctypes.c_int]
            lib.dataplane_error_string.restype = ctypes.c_char_p
            cls.lib = lib
        return cls.lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _Library.get()


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(name: str, *args) -> None:
    lib = _Library.get()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({lib.dataplane_error_string(err).decode()})")


def gi_g1_window(model: str, keys, lam, mu, p, pol, horizon: float,
                 n_frames: int, n_streams: int, sample_streams: int,
                 sample_frames: int, out, samples) -> None:
    """One window over the ``lam.numel()`` lanes from the epoch keys
    ``keys`` ``[E, 2]``; ``samples`` may be None."""
    consts = family_constants()
    family = (_D * len(consts))(*consts)          # host memory
    _launch("dataplane_gi_g1_window", _I(DTYPES[lam.dtype]),
            _I(MODELS[model]), _ptr(keys), _ptr(lam), _ptr(mu), _ptr(p),
            _ptr(pol), family, _D(horizon), _I(lam.numel()),
            _I(n_frames), _I(n_streams), _I(sample_streams),
            _I(sample_frames), _ptr(out), _ptr(samples))


def tick_scan(T, O, coin, p, is_lcfsp, live, epoch: float, out, fin,
              done) -> None:
    """``fin`` and ``done`` may both be None (no trace)."""
    n_lanes, n_frames = T.shape
    _launch("dataplane_tick_scan", _ptr(T), _ptr(O), _ptr(coin), _ptr(p),
            _ptr(is_lcfsp), _ptr(live), _D(epoch), _I(n_lanes),
            _I(n_frames), _ptr(out), _ptr(fin), _ptr(done))
