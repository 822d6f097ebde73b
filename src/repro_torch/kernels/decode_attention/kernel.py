"""ctypes binding of the flash decode CUDA kernel (``csrc/flash_decode.cu``).

The library is built at the first launch (``kernels._build``), never when
this module is imported. ``flash_decode`` takes CUDA tensors whose device,
dtype, shape and contiguity the wrapper in ``ops`` has checked, launches
on PyTorch's current stream, and raises if the launch returns an error.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_decode.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 227 * 1024        # a block's shared memory on the H100
MIN_BLOCK_K = 16                   # the smallest cache tile the kernel takes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def smem_bytes(g: int, d: int, block_k: int = MIN_BLOCK_K) -> int:
    """Shared memory of one CTA (``smem_bytes`` in the source)."""
    return 4 * (g * d + block_k * (d + 1) + block_k * d + g * block_k +
                g * d + 3 * g)


class _Library:
    """The built shared library, loaded once per process at first use."""
    lib: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.lib is None:
            lib = ctypes.CDLL(str(_build.build(
                "flash_decode", SOURCES, _build.ATTENTION_FLAGS)))
            # q, k_cache, v_cache, kv_len, o, dtype, b, t, h, kvh, d,
            # scale, stream
            lib.flash_decode_fwd.argtypes = ([_P] * 5 + [_I] * 6 +
                                             [_F, _P])
            lib.flash_decode_fwd.restype = ctypes.c_int
            lib.decode_error_string.argtypes = [ctypes.c_int]
            lib.decode_error_string.restype = ctypes.c_char_p
            cls.lib = lib
        return cls.lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _Library.get()


def flash_decode(q, k_cache, v_cache, kv_len, out, *, scale: float) -> None:
    lib = _Library.get()
    b, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    stream = _P(torch.cuda.current_stream().cuda_stream)
    err = lib.flash_decode_fwd(
        _P(q.data_ptr()), _P(k_cache.data_ptr()), _P(v_cache.data_ptr()),
        _P(kv_len.data_ptr()), _P(out.data_ptr()), _I(DTYPES[q.dtype]),
        _I(b), _I(t), _I(h), _I(kvh), _I(d), _F(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {err} "
                           f"({lib.decode_error_string(err).decode()})")
