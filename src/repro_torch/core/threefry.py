"""Threefry-2x32 counter-based random bits, as the JAX package's batched
data plane draws them (its ``jax.random`` keys under the default
``threefry2x32`` implementation with partitionable bits).

Every 32-bit word is carried in an int64 tensor and masked to 32 bits
after each add and rotate, so the arithmetic is exact on any device. The
rules, which reproduce ``jax.random`` bit for bit:

  * ``key(seed)`` is the word pair ``[seed >> 32, seed & 0xFFFFFFFF]`` of a
    64-bit seed;
  * ``fold_in(k, d)`` is ``threefry2x32(k, [0, d & 0xFFFFFFFF])`` (the data
    is first taken as a 32-bit word);
  * element ``i`` of a flat draw of ``shape`` has the counter pair
    ``[i >> 32, i & 0xFFFFFFFF]``; a 32-bit draw is the xor of the two
    output words, a 64-bit draw their concatenation (first word high);
  * a uniform in [0, 1) keeps the top mantissa bits of a draw under the
    exponent of 1.0 and subtracts 1.

The data-plane kernel (``kernels/dataplane/csrc/dataplane.cu``) carries
the same generator in 32-bit registers.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds of the key words ``(k0, k1)`` (int64
    tensors or Python ints, broadcast against the counters) over the
    counter words ``(x0, x1)``. Returns the two output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64, device=x0.device)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=x0.device)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """The key of a 64-bit integer seed: int64 ``[2]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """Fold ``data`` (an int or an integer tensor) into the key(s) ``k``
    (``[..., 2]``); returns keys of the broadcast shape ``[..., 2]``."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(k: torch.Tensor, shape, width: int = 32) -> torch.Tensor:
    """``width``-bit (32 or 64) draws of ``shape`` under each key of
    ``k`` (``[..., 2]``): int64 ``[..., *shape]``. A 64-bit draw comes
    back as its top 52 bits (``bits >> 12``), which is all a float64
    uniform keeps and fits an int64."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1)
    k1 = k[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
    if width == 32:
        bits = y0 ^ y1
    elif width == 64:
        bits = (y0 << 20) | (y1 >> 12)
    else:
        raise ValueError(f"random_bits: width {width} is not 32 or 64")
    return bits.reshape(*lead, *shape)


def uniform(k: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` under each key of ``k``
    (``[..., 2]``), float32 or float64: ``jax.random.uniform``'s."""
    if dtype == torch.float32:
        mant = random_bits(k, shape, 32) >> 9
        one = mant | 0x3F800000
        return one.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        one = random_bits(k, shape, 64) | 0x3FF0000000000000
        return one.view(torch.float64) - 1.0
    raise TypeError(f"uniform: dtype {dtype} is not float32 or float64")
