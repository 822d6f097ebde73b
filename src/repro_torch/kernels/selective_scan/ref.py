"""Plain PyTorch versions of the Mamba selective scan (S6).

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = sum_n h_t[n] * C_t[n] + D * x_t

The port's counterparts of the JAX package's ``kernels/selective_scan/
ref.py``. ``selective_scan_ref`` steps over the sequence in the order of
the JAX package's Pallas kernel (``kernel.py:_scan_kernel``), in f32, and
keeps only the [b, inner, n] state: the JAX package's
``selective_scan_ref`` materialises the [b, s, inner, n] trajectory for
an associative scan, 3.2 GB per layer at jamba's widths and 3,072 tokens.
``selective_scan_chunked`` is the JAX package's function of that name
(its models' default ``ssm_impl``): chunks of ``chunk`` tokens in order,
each an associative scan that materialises only that chunk's
[b, chunk, inner, n], carrying h from chunk to chunk. It has no kernel in
either package; the models run it only where a caller asks for
``ssm_impl="chunked"`` (the trainer does).
``selective_scan_lanes_ref`` sums y in the CUDA kernel's order, for the
tests; nothing on the main path calls it.

The loops over tokens and over chunks run through ``token_loop.run``, so
the dry run counts a long sequence from a few of its steps.
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


def _combine(a1, b1, a2, b2):
    """The JAX package's ``_scan_combine``: (a1, b1) then (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def associative_scan(a, b):
    """Inclusive scan of ``_combine`` over dim 1 of (a, b), in the
    recursion of ``jax.lax.associative_scan``, so that both packages
    combine the same pairs in the same order: combine adjacent pairs
    (0, 1), (2, 3), ...; scan the reduced half recursively (its results
    are the odd positions); fix up the even positions 2, 4, ... from the
    odd ones before them and the inputs; position 0 is the input's;
    interleave. Each level holds half the previous one's elements, so the
    work and the saved activations stay near twice one input's, where a
    Hillis-Steele doubling would hold log2(length) of them."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    m = oa.shape[1]
    k = m - 1 if n % 2 == 0 else m      # odd results an input follows
    ea, eb = _combine(oa[:, :k], ob[:, :k], a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], 1), torch.cat([b[:, :1], eb], 1)

    def interleave(even, odd):
        out = torch.stack([even[:, :m], odd], 2).flatten(1, 2)
        return torch.cat([out, even[:, m:]], 1) if n % 2 else out
    return interleave(ea, oa), interleave(eb, ob)


def _associative_form(x, dt, A, B, C, D, h0):
    """The JAX package's ``selective_scan_ref`` over the whole of x: the
    [b, s, inner, n] trajectory by ``associative_scan``, h0 entered as
    ``a * h0 + h``. Returns (y in x's dtype, h_last f32)."""
    x32, dt32 = x.float(), dt.float()
    delta_a = torch.exp(dt32[..., None] * A.float()[None, None])
    delta_bx = dt32[..., None] * B.float()[:, :, None, :] * x32[..., None]
    a, h = associative_scan(delta_a, delta_bx)
    if h0 is not None:
        h = a * h0.float()[:, None] + h
    y = (torch.einsum("bsin,bsn->bsi", h, C.float())
         + D.float()[None, None] * x32)
    return y.to(x.dtype), h[:, -1]


def selective_scan_chunked(x, dt, A, B, C, D, h0=None, chunk: int = 256):
    """The JAX package's ``selective_scan_chunked``: chunks of ``chunk``
    tokens in order, each ``_associative_form`` from the h the previous
    chunk left (zeros, or h0, before the first). Where ``chunk`` does not
    divide s, one associative form over the whole sequence, as the JAX
    package falls back. Shapes as ``selective_scan_ref``; y in x's dtype,
    h_last f32."""
    b, s, inner = x.shape
    if s % chunk != 0:
        return _associative_form(x, dt, A, B, C, D, h0)
    h = (torch.zeros((b, inner, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    y = torch.empty_like(x)

    def step(c):
        nonlocal h
        part = slice(c * chunk, (c + 1) * chunk)
        y[:, part], h = _associative_form(x[:, part], dt[:, part], A,
                                          B[:, part], C[:, part], D, h)
    token_loop.run(s // chunk, step)
    return y, h


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
