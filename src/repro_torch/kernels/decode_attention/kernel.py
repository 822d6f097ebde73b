"""ctypes binding of the flash decode CUDA kernel (``csrc/flash_decode.cu``).

The library is built at the first launch (``kernels._build``), never when
this module is imported. ``flash_decode`` takes CUDA tensors whose device,
dtype, shape, contiguity and alignment the wrapper in ``ops`` has checked,
launches the split and the combine pass on PyTorch's current stream, and
raises if a launch returns an error; ``flash_decode_split`` and
``flash_decode_combine`` launch one pass each (a sequence-sharded cache's
rows on one rank, then every rank's partials). ``split_plan`` is the host's choice of
the split, shared with the plain split version (``ref.decode_split_ref``)
and the tests.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_decode.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32             # cache rows per stage of the split pass (``TILE``)
CTAS_PER_SM = 4       # the split aims at this many CTAs per SM
H100_SMS = 132

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def split_plan(b: int, t: int, kvh: int, n_sm: int = H100_SMS
               ) -> tuple[int, int]:
    """(n_split, chunk) for a cache of ``t`` rows, ``b`` sequences and
    ``kvh`` KV heads on ``n_sm`` SMs.

    Split i of a (sequence, KV head) owns rows [i * chunk, (i + 1) *
    chunk); chunk is a multiple of ``TILE``. The grid b * kvh * n_split
    aims at ``CTAS_PER_SM`` CTAs per SM, so it covers the SMs at least
    twice wherever the cache has that many tiles. The plan reads no
    ``kv_len``: the launch shape is fixed for a given cache, and splits
    beyond a sequence's length return at once."""
    want = -(-CTAS_PER_SM * n_sm // max(b * kvh, 1))
    tiles = max(-(-t // TILE), 1)
    chunk = max(tiles // want, 1) * TILE
    return max(-(-t // chunk), 1), chunk


class _Library:
    """The built shared library, loaded once per process at first use."""
    lib: ctypes.CDLL | None = None

    @classmethod
    def get(cls) -> ctypes.CDLL:
        if cls.lib is None:
            lib = ctypes.CDLL(str(_build.build(
                "flash_decode", SOURCES, _build.ATTENTION_FLAGS)))
            # q, k_cache, v_cache, kv_len, o, ws, dtype, b, t, h, kvh, d,
            # n_split, chunk, scale, stream
            lib.flash_decode_fwd.argtypes = ([_P] * 6 + [_I] * 8 +
                                             [_F, _P])
            lib.flash_decode_fwd.restype = ctypes.c_int
            # q, k_cache, v_cache, kv_len, ws, dtype, b, t, h, kvh, d,
            # n_split, chunk, scale, stream
            lib.flash_decode_split.argtypes = ([_P] * 5 + [_I] * 8 +
                                               [_F, _P])
            lib.flash_decode_split.restype = ctypes.c_int
            # ws, o, dtype, b, h, d, n_split, stream
            lib.flash_decode_combine.argtypes = [_P] * 2 + [_I] * 5 + [_P]
            lib.flash_decode_combine.restype = ctypes.c_int
            lib.decode_error_string.argtypes = [ctypes.c_int]
            lib.decode_error_string.restype = ctypes.c_char_p
            cls.lib = lib
        return cls.lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _Library.get()


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The SM count of ``device``, read once per device."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({lib.decode_error_string(err).decode()})")


def _stream():
    return _P(torch.cuda.current_stream().cuda_stream)


def flash_decode(q, k_cache, v_cache, kv_len, out, *, scale: float) -> None:
    lib = _Library.get()
    b, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    n_split, chunk = split_plan(b, t, kvh, sm_count(q.device))
    # The split pass's partials: acc[d], then the running max m and the
    # denominator l of each (sequence, q head, split).
    ws = torch.empty((b, h, n_split, d + 2), dtype=torch.float32,
                     device=q.device)
    _check(lib, lib.flash_decode_fwd(
        _P(q.data_ptr()), _P(k_cache.data_ptr()), _P(v_cache.data_ptr()),
        _P(kv_len.data_ptr()), _P(out.data_ptr()), _P(ws.data_ptr()),
        _I(DTYPES[q.dtype]), _I(b), _I(t), _I(h), _I(kvh), _I(d),
        _I(n_split), _I(chunk), _F(scale), _stream()), "flash_decode")


def flash_decode_split(q, k_cache, v_cache, kv_len, *,
                       scale: float) -> torch.Tensor:
    """The split pass alone: f32 partials [b, h, n_split, d + 2] (acc[d],
    m, l) of the cache's rows under ``split_plan``; acc is unwritten
    where l = 0."""
    lib = _Library.get()
    b, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    n_split, chunk = split_plan(b, t, kvh, sm_count(q.device))
    ws = torch.empty((b, h, n_split, d + 2), dtype=torch.float32,
                     device=q.device)
    _check(lib, lib.flash_decode_split(
        _P(q.data_ptr()), _P(k_cache.data_ptr()), _P(v_cache.data_ptr()),
        _P(kv_len.data_ptr()), _P(ws.data_ptr()), _I(DTYPES[q.dtype]),
        _I(b), _I(t), _I(h), _I(kvh), _I(d), _I(n_split), _I(chunk),
        _F(scale), _stream()), "flash_decode_split")
    return ws


def flash_decode_combine(ws, out) -> None:
    """The combine pass alone: partials ``ws`` [b, h, n, d + 2] -> ``out``
    [b, h, d]."""
    lib = _Library.get()
    b, h, n, d2 = ws.shape
    _check(lib, lib.flash_decode_combine(
        _P(ws.data_ptr()), _P(out.data_ptr()), _I(DTYPES[out.dtype]), _I(b),
        _I(h), _I(d2 - 2), _I(n), _stream()), "flash_decode_combine")
