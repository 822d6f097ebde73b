"""ctypes binding of the chunkwise mLSTM CUDA kernel
(``csrc/mlstm_chunkwise.cu``).

The library is built at the first launch (``kernels._build``), never when
this module is imported. ``mlstm_chunkwise`` takes CUDA tensors whose
device, dtype, shape and contiguity the wrapper in ``ops`` has checked,
launches on PyTorch's current stream, and raises if the launch returns an
error.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "mlstm_chunkwise.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Library:
    """The built shared library, loaded once per process at first use."""
    lib: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.lib is None:
            lib = ctypes.CDLL(str(_build.build(
                "mlstm_chunkwise", SOURCES, _build.ATTENTION_FLAGS)))
            # q, k, v, cum_f, logi, o, dtype, b, s, h, d, scale, stream
            lib.mlstm_chunkwise_fwd.argtypes = ([_P] * 6 + [_I] * 5 +
                                                [_F, _P])
            lib.mlstm_chunkwise_fwd.restype = ctypes.c_int
            lib.mlstm_error_string.argtypes = [ctypes.c_int]
            lib.mlstm_error_string.restype = ctypes.c_char_p
            cls.lib = lib
        return cls.lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _Library.get()


def mlstm_chunkwise(q, k, v, cum_f, logi, out, *, scale: float) -> None:
    lib = _Library.get()
    b, s, h, d = q.shape
    stream = _P(torch.cuda.current_stream().cuda_stream)
    err = lib.mlstm_chunkwise_fwd(
        _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
        _P(cum_f.data_ptr()), _P(logi.data_ptr()), _P(out.data_ptr()),
        _I(DTYPES[q.dtype]), _I(b), _I(s), _I(h), _I(d), _F(scale), stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunkwise launch failed: cudaError {err} "
                           f"({lib.mlstm_error_string(err).decode()})")
