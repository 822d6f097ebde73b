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
MAX_GROUP = 128      # most CTAs per server of a water-fill
MAX_CLUSTER = 16     # most CTAs of a cluster (above 8 a non-portable one)
MAX_THREADS = 256    # most threads per water-fill CTA
SLOTS = 4            # cameras a water-fill thread keeps in registers
SYNC = {"none": 0, "cluster": 1, "grid": 2}   # how a server's CTAs meet
CONFIG_THREADS = 128    # threads per CTA of config_argmin_kernel
BASELINE_THREADS = 128  # threads per CTA of baseline_argmax_kernel
# The two scans' lanes per camera (``scan_lanes``).
SCAN_MIN_LANES, SCAN_MAX_LANES, SCAN_LANES_PER_SM = 2, 32, 512

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # b, c, eff, acc, xi, size, q*, v, n_total, n, n_m, n_r, r, m, pol, stream
    "slot_config_argmin": [_P] * 7 + [_F, _F, _I, _I, _I] + [_P] * 4,
    # mode, coef, p, pol, other, budgets, margin, order, starts, counts,
    # n, n_servers, group, threads, sync, outer, inner, final, scratch,
    # slots, out, stream
    "slot_waterfill": [_I] + [_P] * 5 + [_F] + [_P] * 3 + [_I] * 8 +
                      [_P] * 4,
    # k, p, pol, mu, inv_xi, budgets_b, budgets_c, margin, order, starts,
    # counts, n, n_servers, group, threads, sync, outer, inner, final,
    # scratch, slots, out_b, out_c, stream
    "slot_waterfill_pair": [_P] * 7 + [_F] + [_P] * 3 + [_I] * 8 +
                           [_P] * 5,
    # as slot_waterfill
    "slot_waterfill_tiled": [_I] + [_P] * 5 + [_F] + [_P] * 3 + [_I] * 8 +
                            [_P] * 4,
    # b, c, eff, acc, xi, size, thresh, mode, n, n_m, n_r, m, r, stream
    "slot_baseline_argmax": [_P] * 6 + [_F] + [_I] * 4 + [_P] * 3,
}


def scan_lanes(n: int, n_sms: int) -> int:
    """Lanes per camera of config_argmin_kernel and baseline_argmax_kernel
    for ``n`` cameras on a card of ``n_sms`` SMs, as the library picks
    them: the fewest, a power of two from SCAN_MIN_LANES to
    SCAN_MAX_LANES, whose n * L lanes cover SCAN_LANES_PER_SM lanes of
    every SM (32 up to 2,000 cameras on an H100, 8 at 10,000, 2 at
    100,000)."""
    lanes = SCAN_MIN_LANES
    while lanes < SCAN_MAX_LANES and n * lanes < SCAN_LANES_PER_SM * n_sms:
        lanes *= 2
    return lanes


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
            lib.slot_scan_lanes.argtypes = [ctypes.c_int]
            lib.slot_scan_lanes.restype = ctypes.c_int
            cls.lib = lib
        return cls.lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _Library.get()


def launched_lanes(n: int) -> int:
    """The lanes per camera the built library launches the two scans with
    for ``n`` cameras on the current device (``scan_lanes`` on the card)."""
    return _Library.get().slot_scan_lanes(n)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _ptr_or_null(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


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


def _plan_args(plan, effort):
    return (_I(plan.group), _I(plan.threads), _I(SYNC[plan.sync]),
            *map(_I, effort))


def waterfill(mode: int, coef, p, pol, other, budgets, margin: float, order,
              starts, counts, plan, effort, scratch, slots, out,
              tiled: bool = False) -> None:
    """One water-fill, ``waterfill_kernel`` or (``tiled``)
    ``waterfill_tiled_kernel``, on ``plan``'s CTAs; ``slots`` is the grid
    exchange's zeroed int64 ``[S, 2 + G]`` or ``None``."""
    _launch("slot_waterfill_tiled" if tiled else "slot_waterfill",
            _I(mode), _ptr(coef), _ptr(p), _ptr(pol), _ptr(other),
            _ptr(budgets), _F(margin), _ptr(order), _ptr(starts),
            _ptr(counts), _I(coef.shape[0]), _I(counts.shape[0]),
            *_plan_args(plan, effort), _ptr(scratch), _ptr_or_null(slots),
            _ptr(out))


def waterfill_pair(k, p, pol, mu, inv_xi, budgets_b, budgets_c,
                   margin: float, order, starts, counts, plan, effort,
                   scratch, slots, out_b, out_c) -> None:
    _launch("slot_waterfill_pair", _ptr(k), _ptr(p), _ptr(pol), _ptr(mu),
            _ptr(inv_xi), _ptr(budgets_b), _ptr(budgets_c), _F(margin),
            _ptr(order), _ptr(starts), _ptr(counts), _I(k.shape[0]),
            _I(counts.shape[0]), *_plan_args(plan, effort), _ptr(scratch),
            _ptr_or_null(slots), _ptr(out_b), _ptr(out_c))


def baseline_argmax(b, c, eff, acc, xi, size, threshold: float, mode: str,
                    m_out, r_out) -> None:
    n, n_m, n_r = acc.shape
    _launch("slot_baseline_argmax", _ptr(b), _ptr(c), _ptr(eff), _ptr(acc),
            _ptr(xi), _ptr(size), _F(threshold), _I(BASELINE_MODES[mode]),
            _I(n), _I(n_m), _I(n_r), _ptr(m_out), _ptr(r_out))
