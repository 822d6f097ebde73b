"""Gradient compression: blockwise-scaled int8, error-bounded (the JAX
package's ``training/compression.py``).

``compress_grads`` round-trips every gradient leaf through the int8 wire
format inside the train step: it models the numerics of a compressed
data-parallel all-reduce. ``torch.round`` and ``jnp.round`` both round
half to even, and the scales are the same f32 division, so the int8 codes
are bitwise the JAX package's. ``compressed_psum`` is the explicit
compressed all-reduce over a process group (the JAX package's
``shard_map`` building block): a MAX all-reduce of the block maxima, one
shared scale per block, an int32 SUM of the int8 codes, the mean.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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


def compressed_psum(x: torch.Tensor, group=None, block: int = 256
                    ) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (the default group
    when None) through the int8 wire format: the block maxima all-reduced
    by MAX (f32, 1/block of the payload), the shared scale
    ``max(gmax / 127, 1e-12)``, int8 codes rounded half to even and
    clipped to [-127, 127], summed as int32, then ``total * scale / n``
    with n the ranks counted by an int32 SUM, in the JAX package's order.
    Every rank gets the same result, within max|x| / 127 of the exact
    mean per block."""
    from ..sharding import ctx
    blocks, pad = _blockwise(x.float(), block)
    gmax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    ctx.count("all_reduce", gmax)
    scale = torch.clamp(gmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    ctx.count("all_reduce", total)
    n = torch.ones((), dtype=torch.int32, device=x.device)
    dist.all_reduce(n, group=group)
    ctx.count("all_reduce", n)
    out = (total.float() * scale / n.float()).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)
