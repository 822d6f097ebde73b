"""ctypes binding of the chunkwise mLSTM CUDA kernel
(``csrc/mlstm_chunkwise.cu``).

The library is built at the first launch (``kernels._build``), never when
this module is imported. ``mlstm_chunkwise`` takes CUDA tensors whose
device, dtype, shape and contiguity the wrapper in ``ops`` has checked,
launches on PyTorch's current stream, and raises if the launch returns an
error. ``cluster_plan`` is the host's choice of the thread-block cluster
(the value slices of one query tile), shared with the plain version that
sums the scores over the same slices (``ref.mlstm_cluster_ref``) and the
tests.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "mlstm_chunkwise.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SLICE = 256           # value columns a CTA holds in registers, at most
MAX_CLUSTER = 8       # the portable cluster size
MAX_DV = 512          # the widest slice the kernel takes (``MAX_DV``)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def slice_width(d: int, n_ranks: int) -> int:
    """Columns of each of ``n_ranks`` slices of a head dim ``d``: ceil(d /
    n_ranks) rounded up to 16 (the last slice may be narrower)."""
    return -(-(-(-d // n_ranks)) // 16) * 16


def cluster_plan(d: int) -> tuple[int, int]:
    """(R, DV): the cluster size and each CTA's columns for head dim ``d``.

    One CTA (R = 1) up to d = 256; then one CTA per ``SLICE`` columns (R =
    4, DV = 256 at xlstm-1.3b's d = 1024), capped at the portable cluster
    size 8, so DV = d / 8 above d = 2048 (512 at d = 4096)."""
    n_ranks = min(MAX_CLUSTER, -(-d // SLICE))
    return n_ranks, slice_width(d, n_ranks)


class _Library:
    """The built shared library, loaded once per process at first use."""
    lib: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.lib is None:
            lib = ctypes.CDLL(str(_build.build(
                "mlstm_chunkwise", SOURCES, _build.ATTENTION_FLAGS)))
            # q, k, v, cum_f, logi, o, dtype, b, s, h, d, n_ranks, dv,
            # scale, stream
            lib.mlstm_chunkwise_fwd.argtypes = ([_P] * 6 + [_I] * 7 +
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
    """Launch over clusters of ``cluster_plan(d)`` CTAs."""
    lib = _Library.get()
    b, s, h, d = q.shape
    n_ranks, dv = cluster_plan(d)
    stream = _P(torch.cuda.current_stream().cuda_stream)
    err = lib.mlstm_chunkwise_fwd(
        _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
        _P(cum_f.data_ptr()), _P(logi.data_ptr()), _P(out.data_ptr()),
        _I(DTYPES[q.dtype]), _I(b), _I(s), _I(h), _I(d), _I(n_ranks), _I(dv),
        _F(scale), stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunkwise launch failed: cudaError {err} "
                           f"({lib.mlstm_error_string(err).decode()})")
