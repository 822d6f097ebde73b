"""Mamba (S6) block: template, full-sequence apply (its scan is the
``selective_scan`` kernel, or ``selective_scan_chunked`` under
``ssm_impl="chunked"``) and the decode step.

Templates, key names and einsum layouts are the JAX package's
(``models/ssm.py``). The state of a cache is written in place: a prefill
given ``state`` writes the state after its last token into it (the scan's
last ``h`` and the last ``conv - 1`` rows before the convolution), and a
decode step updates it.

Under a mesh (``sharding.ctx``) the inner channels are split over the
``ssm_inner`` rule's axis, as the templates place them: each rank holds
its block of ``in_proj``'s columns and its channels of every other leaf
and of the state. The block of in_proj's 2 * inner columns is not the
rank's channels of x_in and z (at two ranks, rank 0 holds all of x_in),
so the product's columns are exchanged onto the rank's channels
(``_in_proj``, ``layers.own_channels``). The convolution, dt, the scan
and the gate run on the rank's channels; x_proj and out_proj contract
over them, so their partial sums are all-reduced.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import (selective_scan,
                                      selective_scan_chunked, selective_step)
from ..sharding import ctx as shard_ctx
from .common import CONV, EMBED, LORA, SSM_INNER, SSM_STATE, P
from .layers import einsum, own_channels

# The full-sequence scan's forms (the JAX package's ``ssm_impl`` values
# that run no Pallas kernel): "ref", the ``selective_scan`` wrapper (the
# CUDA kernel under impl="auto" on CUDA tensors, else the per-token plain
# loop), and "chunked", ``selective_scan_chunked`` whatever ``impl`` is.
SSM_IMPLS = ("ref", "chunked")


def check_ssm_impl(ssm_impl: str) -> None:
    if ssm_impl not in SSM_IMPLS:
        raise ValueError(
            f"ssm_impl={ssm_impl!r} not in {SSM_IMPLS} (the CUDA kernel runs "
            "under ssm_impl='ref' with impl='auto')")


def mamba_template(cfg):
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    dtr = cfg.resolved_dt_rank
    n = cfg.ssm_state
    return {
        "in_proj": P((d, 2 * inner), (EMBED, SSM_INNER)),
        "conv_w": P((cfg.ssm_conv, inner), (CONV, SSM_INNER),
                    init="normal", scale=0.1),
        "conv_b": P((inner,), (SSM_INNER,), init="zeros"),
        "x_proj": P((inner, dtr + 2 * n), (SSM_INNER, LORA)),
        "dt_proj": P((dtr, inner), (LORA, SSM_INNER)),
        "dt_bias": P((inner,), (SSM_INNER,), init="s4d_dt"),
        "A_log": P((inner, n), (SSM_INNER, SSM_STATE), init="s4d"),
        "D": P((inner,), (SSM_INNER,), init="ones"),
        "out_proj": P((inner, d), (SSM_INNER, EMBED)),
    }


def mamba_state_template(cfg, batch: int, dtype=None):
    """h [b, inner, n] in f32; conv [b, conv - 1, inner], the rows before
    the next token's convolution, in the caches' ``dtype``."""
    inner = cfg.ssm_expand * cfg.d_model
    return {
        "h": P((batch, inner, cfg.ssm_state),
               ("batch", SSM_INNER, SSM_STATE), init="zeros",
               dtype=torch.float32),
        "conv": P((batch, cfg.ssm_conv - 1, inner),
                  ("batch", CONV, SSM_INNER), init="zeros", dtype=dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv as the JAX package's shifted adds, summed in
    order of the tap j (not ``F.conv1d``: cuDNN takes f32 convolutions in
    TF32). x: [b, s, inner]; w: [conv, inner]."""
    conv, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, conv - 1, 0))
    out = sum(pad[:, j:j + s, :] * w[j] for j in range(conv))
    return out + b


def _inner_axis(params, cfg):
    """The mesh axis the inner channels are split over, or None."""
    inner = cfg.ssm_expand * cfg.d_model
    axis, _ = shard_ctx.split(SSM_INNER, params["conv_b"].shape[0], inner)
    if axis is not None and params["in_proj"].shape[1] != \
            2 * params["conv_b"].shape[0]:
        raise NotImplementedError(
            f"in_proj's columns {tuple(params['in_proj'].shape)} and the "
            f"channels {tuple(params['conv_b'].shape)} split unevenly")
    return axis


def _in_proj(params, x, axis):
    """(x_in, z) of the rank's channels: [..., inner_loc] each."""
    x = shard_ctx.enter_stream(x, axis)
    xz = einsum("bsd,di->bsi", x, params["in_proj"])
    if axis is not None:
        xz = own_channels(xz, axis)
    return torch.chunk(xz, 2, dim=-1)


def _dt_bc(params, xc, cfg, axis=None):
    """(dt in xc's dtype, B, C) from the convolved input. Under a mesh the
    product with x_proj is a partial sum over the rank's channels."""
    dtr, n = cfg.resolved_dt_rank, cfg.ssm_state
    dbc = einsum("...i,ir->...r", xc, params["x_proj"])
    if axis is not None:
        # Summed over the channels; dt_low, B and C then feed the rank's
        # channels only, so their gradients are partial sums.
        dbc = shard_ctx.enter(shard_ctx.psum(dbc, axis), axis)
    dt_low, B, C = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = F.softplus(einsum("...r,ri->...i", dt_low, params["dt_proj"]).float()
                    + params["dt_bias"].float())
    return dt.to(xc.dtype), B, C


def _gate_out(params, y, z, x, axis=None):
    y = y * F.silu(z.float()).to(x.dtype)
    out = einsum("...i,id->...d", y, params["out_proj"])
    return shard_ctx.exit_stream(out, axis)


def mamba_apply(params, x, cfg, *, impl: str = "auto", ssm_impl: str = "ref",
                state=None):
    """Full-sequence apply. x: [b, s, d]. Returns y, or (y, state) when
    ``state`` is given (prefill): the scan starts from ``state["h"]`` and
    the state after the last token is written into it. A prompt shorter
    than ``conv - 1`` leaves zeros (the convolution's padding) in the
    first rows of ``state["conv"]``. ``ssm_impl``: the scan's form
    (``SSM_IMPLS``)."""
    check_ssm_impl(ssm_impl)
    axis = _inner_axis(params, cfg)
    x_in, z = _in_proj(params, x, axis)
    xc = F.silu(_causal_conv(x_in, params["conv_w"], params["conv_b"])
                .float()).to(x.dtype)
    dt, B, C = _dt_bc(params, xc, cfg, axis)
    A = -torch.exp(params["A_log"].float())
    h0 = None if state is None else state["h"]
    if ssm_impl == "chunked":
        y, h_last = selective_scan_chunked(xc, dt, A, B, C, params["D"], h0)
    else:
        y, h_last = selective_scan(
            xc, dt.contiguous(), A, B.contiguous(), C.contiguous(),
            params["D"], h0, impl=impl)
    out = _gate_out(params, y, z, x, axis)
    if state is None:
        return out
    keep = min(cfg.ssm_conv - 1, x_in.shape[1])
    state["h"].copy_(h_last)
    state["conv"].zero_()
    if keep:
        state["conv"][:, -keep:] = x_in[:, -keep:].to(state["conv"].dtype)
    return out, state


def mamba_decode(params, x, cfg, state):
    """Single-token step. x: [b, 1, d]; ``state`` is updated in place."""
    axis = _inner_axis(params, cfg)
    x_in, z = _in_proj(params, x, axis)                     # [b, 1, inner]
    window = torch.cat([state["conv"], x_in.to(state["conv"].dtype)], dim=1)
    w = params["conv_w"]
    xc = sum(window[:, j, :] * w[j] for j in range(cfg.ssm_conv)) \
        + params["conv_b"]
    xc = F.silu(xc.float()).to(x.dtype)                     # [b, inner]
    dt, B, C = _dt_bc(params, xc, cfg, axis)
    A = -torch.exp(params["A_log"].float())
    y, h_new = selective_step(xc, dt, A, B, C, params["D"], state["h"])
    out = _gate_out(params, y, z[:, 0], x, axis)[:, None]
    state["h"].copy_(h_new)
    state["conv"].copy_(window[:, 1:])
    return out, state
