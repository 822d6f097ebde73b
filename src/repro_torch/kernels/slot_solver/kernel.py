"""ctypes binding of the slot-solver CUDA kernels (``csrc/slot_solver.cu``).

The library is built at the first launch (``kernels._build``), never when
this module is imported. Each launcher takes CUDA tensors whose device,
dtype, shape and contiguity the wrappers in ``ops`` have checked, launches
on PyTorch's current stream, and raises if the launch returns an error.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "slot_solver.cu",)
MODE_BANDWIDTH = 0
MODE_COMPUTE = 1
BASELINE_MODES = {"dos": 0, "jcab": 1}
MAX_GROUP = 8        # CTAs per server of waterfill_tiled (a portable cluster)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # b, c, eff, acc, xi, size, q*, v, n_total, n, n_m, n_r, r, m, pol, stream
    "slot_config_argmin": [_P] * 7 + [_F, _F, _I, _I, _I] + [_P] * 4,
    # mode, coef, p, pol, other, budgets, margin, order, starts, counts,
    # n, n_servers, outer, inner, final, scratch, out, stream
    "slot_waterfill": [_I] + [_P] * 5 + [_F] + [_P] * 3 + [_I] * 5 +
                      [_P] * 3,
    # k, p, pol, mu, inv_xi, budgets_b, budgets_c, margin, order, starts,
    # counts, n, n_servers, outer, inner, final, scratch, out_b, out_c,
    # stream
    "slot_waterfill_pair": [_P] * 7 + [_F] + [_P] * 3 + [_I] * 5 +
                           [_P] * 4,
    # mode, coef, p, pol, other, budgets, margin, order, starts, counts,
    # n, n_servers, group, outer, inner, final, scratch, out, stream
    "slot_waterfill_tiled": [_I] + [_P] * 5 + [_F] + [_P] * 3 + [_I] * 6 +
                            [_P] * 3,
    # b, c, eff, acc, xi, size, thresh, mode, n, n_m, n_r, m, r, stream
    "slot_baseline_argmax": [_P] * 6 + [_F] + [_I] * 4 + [_P] * 3,
}


class _Library:
    """The built shared library, loaded once per process at first use."""
    lib: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.lib is None:
            lib = ctypes.CDLL(str(_build.build("slot_solver", SOURCES)))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.slot_error_string.argtypes = [ctypes.c_int]
            lib.slot_error_string.restype = ctypes.c_char_p
            cls.lib = lib
        return cls.lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _Library.get()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(name: str, *args) -> None:
    lib = _Library.get()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({lib.slot_error_string(err).decode()})")


def config_argmin(b, c, eff, acc, xi, size, q, v: float, n_total: int,
                  r_out, m_out, pol_out) -> None:
    n, n_m, n_r = acc.shape
    _launch("slot_config_argmin", _ptr(b), _ptr(c), _ptr(eff), _ptr(acc),
            _ptr(xi), _ptr(size), _ptr(q), _F(v), _F(float(n_total)),
            _I(n), _I(n_m), _I(n_r), _ptr(r_out), _ptr(m_out),
            _ptr(pol_out))


def waterfill(mode: int, coef, p, pol, other, budgets, margin: float, order,
              starts, counts, outer: int, inner: int, final: int, scratch,
              out) -> None:
    _launch("slot_waterfill", _I(mode), _ptr(coef), _ptr(p), _ptr(pol),
            _ptr(other), _ptr(budgets), _F(margin), _ptr(order),
            _ptr(starts), _ptr(counts), _I(coef.shape[0]),
            _I(counts.shape[0]), _I(outer), _I(inner), _I(final),
            _ptr(scratch), _ptr(out))


def waterfill_pair(k, p, pol, mu, inv_xi, budgets_b, budgets_c,
                   margin: float, order, starts, counts, outer: int,
                   inner: int, final: int, scratch, out_b, out_c) -> None:
    _launch("slot_waterfill_pair", _ptr(k), _ptr(p), _ptr(pol), _ptr(mu),
            _ptr(inv_xi), _ptr(budgets_b), _ptr(budgets_c), _F(margin),
            _ptr(order), _ptr(starts), _ptr(counts), _I(k.shape[0]),
            _I(counts.shape[0]), _I(outer), _I(inner), _I(final),
            _ptr(scratch), _ptr(out_b), _ptr(out_c))


def waterfill_tiled(mode: int, coef, p, pol, other, budgets, margin: float,
                    order, starts, counts, group: int, outer: int,
                    inner: int, final: int, scratch, out) -> None:
    _launch("slot_waterfill_tiled", _I(mode), _ptr(coef), _ptr(p),
            _ptr(pol), _ptr(other), _ptr(budgets), _F(margin), _ptr(order),
            _ptr(starts), _ptr(counts), _I(coef.shape[0]),
            _I(counts.shape[0]), _I(group), _I(outer), _I(inner), _I(final),
            _ptr(scratch), _ptr(out))


def baseline_argmax(b, c, eff, acc, xi, size, threshold: float, mode: str,
                    m_out, r_out) -> None:
    n, n_m, n_r = acc.shape
    _launch("slot_baseline_argmax", _ptr(b), _ptr(c), _ptr(eff), _ptr(acc),
            _ptr(xi), _ptr(size), _F(threshold), _I(BASELINE_MODES[mode]),
            _I(n), _I(n_m), _I(n_r), _ptr(m_out), _ptr(r_out))
