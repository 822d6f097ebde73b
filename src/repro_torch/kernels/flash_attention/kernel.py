"""ctypes binding of the flash attention CUDA kernel
(``csrc/flash_attention.cu``).

The library is built at the first launch (``kernels._build``), never when
this module is imported. ``flash_attention`` takes CUDA tensors whose
device, dtype, shape and contiguity the wrapper in ``ops`` has checked,
launches on PyTorch's current stream, and raises if the launch returns an
error. ``TILINGS`` is the kernel's choice of tiles per head-dim range,
shared with the plain version of its schedule (``ref.flash_tiled_ref``)
and the tests; ``tiling`` reads it back from the built library.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (largest head dim, BQ query rows, BK keys per KV tile): the kernel's two
# tilings (``Tiling`` in csrc/flash_attention.cu).
TILINGS = ((128, 128, 64), (256, 64, 16))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Library:
    """The built shared library, loaded once per process at first use."""
    lib: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.lib is None:
            lib = ctypes.CDLL(str(_build.build(
                "flash_attention", SOURCES, _build.ATTENTION_FLAGS)))
            # q, k, v, o, dtype, b, s, t, h, kvh, d, scale, causal,
            # q_offset, stream
            lib.flash_attention_fwd.argtypes = ([_P] * 4 + [_I] * 7 +
                                                [_F, _I, _I, _P])
            lib.flash_attention_fwd.restype = ctypes.c_int
            lib.flash_attention_tiling.argtypes = [_I, _P]
            lib.flash_attention_tiling.restype = None
            lib.attn_error_string.argtypes = [ctypes.c_int]
            lib.attn_error_string.restype = ctypes.c_char_p
            cls.lib = lib
        return cls.lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _Library.get()


def tiles(d: int) -> tuple[int, int]:
    """(BQ, BK) of the tiling the kernel launches for head dim ``d``."""
    for dmax, bq, bk in TILINGS:
        if d <= dmax:
            return bq, bk
    raise ValueError(f"head dim {d} beyond the kernel's {TILINGS[-1][0]}")


def tiling(d: int) -> dict:
    """The tiling the built library launches for head dim ``d``: BQ, BK,
    warps per CTA, ring slots and chunks in flight."""
    out = (ctypes.c_int * 5)()
    _Library.get().flash_attention_tiling(_I(d), out)
    return dict(zip(("bq", "bk", "warps", "slots", "ahead"), out))


def flash_attention(q, k, v, out, *, scale: float, causal: bool,
                    q_offset: int) -> None:
    lib = _Library.get()
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    stream = _P(torch.cuda.current_stream().cuda_stream)
    err = lib.flash_attention_fwd(
        _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
        _P(out.data_ptr()), _I(DTYPES[q.dtype]), _I(b), _I(s), _I(t), _I(h),
        _I(kvh), _I(d), _F(scale), _I(int(causal)), _I(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err} "
                           f"({lib.attn_error_string(err).decode()})")
