"""ctypes binding of the selective-scan CUDA kernel
(``csrc/selective_scan.cu``).

The library is built at the first launch (``kernels._build``), never when
this module is imported. ``selective_scan`` takes CUDA tensors whose
device, dtype, shape and contiguity the wrapper in ``ops`` has checked,
launches on PyTorch's current stream, and raises if the launch returns an
error. ``LANES`` is the number of lanes a channel's states are split
over (``LANES`` in csrc/selective_scan.cu), shared with the plain version
that sums y in the kernel's order (``ref.selective_scan_lanes_ref``);
``plan`` reads it back from the built library.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import MAX_STATE  # noqa: F401  (kMaxN in the source)

SOURCES = (Path(__file__).resolve().parent / "csrc" / "selective_scan.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LANES = 2               # lanes per channel

_P, _I = ctypes.c_void_p, ctypes.c_int


class _Library:
    """The built shared library, loaded once per process at first use."""
    lib: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.lib is None:
            lib = ctypes.CDLL(str(_build.build("selective_scan", SOURCES)))
            # x, dt, A, B, C, D, h0, y, h_last, dtype, b, s, inner, n, stream
            lib.selective_scan_fwd.argtypes = [_P] * 9 + [_I] * 5 + [_P]
            lib.selective_scan_fwd.restype = ctypes.c_int
            lib.selective_scan_plan.argtypes = [_P]
            lib.selective_scan_plan.restype = None
            lib.selective_scan_error_string.argtypes = [ctypes.c_int]
            lib.selective_scan_error_string.restype = ctypes.c_char_p
            cls.lib = lib
        return cls.lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _Library.get()


def plan() -> dict:
    """The built library's lanes per channel and tokens per chunk."""
    out = (ctypes.c_int * 2)()
    _Library.get().selective_scan_plan(out)
    return dict(zip(("lanes", "chunk"), out))


def selective_scan(x, dt, A, B, C, D, h0, y, h_last) -> None:
    """h0 may be None (the kernel starts from zeros)."""
    lib = _Library.get()
    b, s, inner = x.shape
    stream = _P(torch.cuda.current_stream().cuda_stream)
    err = lib.selective_scan_fwd(
        _P(x.data_ptr()), _P(dt.data_ptr()), _P(A.data_ptr()),
        _P(B.data_ptr()), _P(C.data_ptr()), _P(D.data_ptr()),
        _P(None if h0 is None else h0.data_ptr()), _P(y.data_ptr()),
        _P(h_last.data_ptr()), _I(DTYPES[x.dtype]), _I(b), _I(s), _I(inner),
        _I(A.shape[1]), stream)
    if err != 0:
        reason = lib.selective_scan_error_string(err).decode()
        raise RuntimeError(f"selective_scan launch failed: cudaError {err} "
                           f"({reason})")
