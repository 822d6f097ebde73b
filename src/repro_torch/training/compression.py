"""Gradient compression: blockwise-scaled int8, error-bounded (the JAX
package's ``training/compression.py``).

``compress_grads`` round-trips every gradient leaf through the int8 wire
format inside the train step: it models the numerics of a compressed
data-parallel all-reduce. ``torch.round`` and ``jnp.round`` both round
half to even, and the scales are the same f32 division, so the int8 codes
are bitwise the JAX package's. The explicit compressed all-reduce
(``compressed_psum``) needs a process group and waits for the port's
``sharding/``.
"""
from __future__ import annotations

import torch

from ..models.common import tree_map


def _blockwise(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block), pad


def quantize(x: torch.Tensor, block: int = 256):
    """x -> (int8 codes [n_blocks, block], f32 per-block scales
    [n_blocks, 1], pad): scale = max(max |block| / 127, 1e-12)."""
    blocks, pad = _blockwise(x.float(), block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int, shape):
    x = (q.float() * scale).reshape(-1)
    if pad:
        x = x[:-pad]
    return x.reshape(shape)


def roundtrip(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """dequantize(quantize(x)): each element within half an int8 step
    (max |block| / 254) of x, in f32."""
    q, s, pad = quantize(x, block)
    return dequantize(q, s, pad, x.shape)


def compress_grads(grads, dp_axes, block: int = 256):
    """Round-trip int8 quantization over the gradient tree (``dp_axes``
    names the data-parallel axes the wire format would cross)."""
    return tree_map(lambda g: roundtrip(g, block), grads)
