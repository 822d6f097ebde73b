"""Plain PyTorch versions of the Mamba selective scan (S6).

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = sum_n h_t[n] * C_t[n] + D * x_t

The port's counterparts of the JAX package's ``kernels/selective_scan/
ref.py``. ``selective_scan_ref`` steps over the sequence in the order of
the JAX package's Pallas kernel (``kernel.py:_scan_kernel``), in f32, and
keeps only the [b, inner, n] state: the JAX package's own reference
materialises the [b, s, inner, n] trajectory for an associative scan,
3.2 GB per layer at jamba's widths and 3,072 tokens.
``selective_scan_lanes_ref`` sums y in the CUDA kernel's order, for the
tests; nothing on the main path calls it.
"""
from __future__ import annotations

import torch

from ... import token_loop

MAX_STATE = 16      # the most states of a channel the CUDA kernel takes


def _scan(x, dt, A, B, C, D, h0, readout):
    """The recurrence over the tokens in order; ``readout(h * C_t)`` sums
    the n products of each channel, [b, inner, n] -> [b, inner]."""
    b, s, inner = x.shape
    x32, dt32 = x.float(), dt.float()
    A32, B32, C32, D32 = A.float(), B.float(), C.float(), D.float()
    h = (torch.zeros((b, inner, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    y = torch.empty((b, s, inner), dtype=torch.float32, device=x.device)

    def step(t):
        nonlocal h
        xt, dtt = x32[:, t], dt32[:, t]                          # [b, inner]
        da = torch.exp(dtt[..., None] * A32)                     # [b, i, n]
        h = da * h + (dtt * xt)[..., None] * B32[:, t, None, :]
        y[:, t] = readout(h * C32[:, t, None, :]) + D32 * xt
    token_loop.run(s, step)
    return y.to(x.dtype), h


def selective_scan_ref(x, dt, A, B, C, D, h0=None):
    """x, dt: [b, s, inner]; A: [inner, n]; B, C: [b, s, n]; D: [inner];
    h0: [b, inner, n] or None (zeros). Returns (y [b, s, inner] in x's
    dtype, h_last [b, inner, n] in f32)."""
    return _scan(x, dt, A, B, C, D, h0, lambda hc: torch.sum(hc, dim=-1))


def selective_scan_lanes_ref(x, dt, A, B, C, D, h0=None, *, lanes: int):
    """``selective_scan_ref`` with y summed in the CUDA kernel's order: the
    states of a channel split over ``lanes`` lanes, lane l holding states
    l * P .. l * P + P - 1 (those below n) with P = ceil(MAX_STATE /
    lanes), the kernel's split of its largest state, and adding its own in
    order; then the lane sums combined by a butterfly (lane l adds lane
    l ^ 1's, then l ^ 2's, ...). The states are updated exactly as
    ``selective_scan_ref`` updates them, so h_last is its bitwise."""
    if lanes < 1 or lanes & (lanes - 1) or lanes > MAX_STATE:
        raise ValueError(f"lanes={lanes}: a power of two up to {MAX_STATE}")
    n = A.shape[1]
    if n > MAX_STATE:
        raise ValueError(f"state size {n} beyond {MAX_STATE}")
    per = -(-MAX_STATE // lanes)
    valid = (torch.arange(lanes * per) < n).view(lanes, per)
    butterfly = [torch.arange(lanes) ^ off
                 for off in (1 << i for i in range(lanes.bit_length() - 1))]

    def readout(hc):
        hc = torch.nn.functional.pad(hc, (0, lanes * per - n))
        hc = hc.view(*hc.shape[:-1], lanes, per)
        acc = torch.zeros(hc.shape[:-1], dtype=torch.float32,
                          device=hc.device)
        for j in range(per):
            acc = torch.where(valid[:, j].to(hc.device), acc + hc[..., j],
                              acc)
        for partner in butterfly:
            acc = acc + acc[..., partner.to(hc.device)]
        return acc[..., 0]
    return _scan(x, dt, A, B, C, D, h0, readout)


def selective_step(x, dt, A, B, C, D, h):
    """One decode step (no kernel in either package). x, dt: [b, inner];
    B, C: [b, n]; h: [b, inner, n]. Returns (y [b, inner] in x's dtype,
    h_new [b, inner, n] in f32), with the JAX package's operation order
    ``(dt * B) * x``."""
    x32, dt32 = x.float(), dt.float()
    da = torch.exp(dt32[..., None] * A.float()[None])
    h_new = (da * h.float()
             + dt32[..., None] * B.float()[:, None, :] * x32[..., None])
    y = (torch.einsum("bin,bn->bi", h_new, C.float())
         + D.float()[None] * x32)
    return y.to(x.dtype), h_new
