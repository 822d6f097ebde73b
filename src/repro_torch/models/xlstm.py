"""xLSTM blocks: the mLSTM (matrix memory; its prefill mixer is the
``mlstm_chunkwise`` kernel) and the sLSTM (scalar memory, a per-token
loop: the JAX package has no kernel for it either, its recurrence has no
matrix-unit work and few FLOPs next to the mLSTM layers).

Templates, key names and einsum layouts are the JAX package's
(``models/xlstm.py``). The recurrent states of a cache are written in
place: a prefill given ``state`` writes the state after its last token
into it, and a decode step updates it.

Under a mesh (``sharding.ctx``) both blocks split their heads over the
``heads`` rule's axis. The mLSTM's inner channels go with them (head i
owns channels [i hd, (i + 1) hd), and ``ssm_inner`` takes the same axis):
the rank's block of ``up_proj``'s columns is exchanged onto its channels
of ``xu`` and ``z`` (``layers.own_channels``, as Mamba's ``in_proj``), so
q, k, v, the state and the kernel run on the rank's heads. ``w_if``'s
rows are the rank's channels over every head: the gates are a partial sum
over the channels, reduce-scattered onto the rank's heads. ``out_norm``
is one RMS norm over the whole inner width, its sum of squares summed
over the axis (``_out_norm``: one expression with and without a mesh),
and ``down_proj``'s partial sum is all-reduced. Where the axis
does not divide the heads they stay whole (``spec_dims``'s fallback)
while the channels still split: the rank's channels of ``xu`` are
all-gathered, the gates' partial sum all-reduced, and every rank runs
every head, normalises the whole width and keeps its channels for the
row-parallel ``down_proj``. The sLSTM's recurrence is
head-local; its output is all-gathered to the model width before the
column-parallel ``ffn_up``, and ``ffn_down``'s partial sum is
all-reduced. On the sequence-parallel path each block's input is
gathered over the sequence and its output reduce-scattered back
(``ctx.enter_stream``, ``ctx.exit_stream``): the recurrences run over
the whole sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import token_loop
from ..kernels.mlstm import (mlstm, mlstm_chunkwise_xla, mlstm_final_state,
                             mlstm_step)
from ..sharding import ctx as shard_ctx
from .common import EMBED, HEAD_DIM, HEADS, MLP, SSM_INNER, P
from .layers import einsum, own_channels, rmsnorm_template


# ---------------------------------------------------------------------------
# mLSTM block (projection factor 2, as xlstm-1.3b with d_ff = 0)
# ---------------------------------------------------------------------------

def mlstm_template(cfg):
    d = cfg.d_model
    inner = 2 * d
    h = cfg.n_heads
    hd = inner // h
    return {
        "up_proj": P((d, 2 * inner), (EMBED, SSM_INNER)),
        # Block-diagonal per-head q/k/v with hd = inner / h (1024 at
        # xlstm-1.3b, not cfg.head_dim).
        "wq": P((h, hd, hd), (HEADS, None, HEAD_DIM)),
        "wk": P((h, hd, hd), (HEADS, None, HEAD_DIM)),
        "wv": P((h, hd, hd), (HEADS, None, HEAD_DIM)),
        "w_if": P((inner, 2, h), (SSM_INNER, None, HEADS), init="normal",
                  scale=0.02),
        "b_if": P((2, h), (None, HEADS), init="zeros"),
        "out_norm": rmsnorm_template(inner),
        "down_proj": P((inner, d), (SSM_INNER, EMBED)),
    }


def mlstm_state_template(cfg, batch: int, dtype=None):
    """C [b, h, hd, hd], n [b, h, hd], m [b, h]: f32 zeros (m too), whatever
    ``dtype`` the caches of other layers take."""
    inner = 2 * cfg.d_model
    h = cfg.n_heads
    hd = inner // h
    return {
        "C": P((batch, h, hd, hd), ("batch", HEADS, HEAD_DIM, HEAD_DIM),
               init="zeros", dtype=torch.float32),
        "n": P((batch, h, hd), ("batch", HEADS, HEAD_DIM), init="zeros",
               dtype=torch.float32),
        "m": P((batch, h), ("batch", HEADS), init="zeros",
               dtype=torch.float32),
    }


def _mlstm_axis(params, cfg):
    """(axis, whole): the mesh axis the mLSTM's inner channels are split
    over, or None, and whether its heads stay whole on every rank (the
    axis does not divide them) rather than going with the channels."""
    inner = 2 * cfg.d_model
    axis, _ = shard_ctx.split(SSM_INNER, params["down_proj"].shape[0],
                              inner)
    heads = shard_ctx.axis_for(HEADS, cfg.n_heads)
    if heads not in (axis, None) or (axis is not None and params[
            "up_proj"].shape[1] != 2 * params["down_proj"].shape[0]):
        raise NotImplementedError(
            f"the mLSTM's {cfg.n_heads} heads over {heads!r} and its {inner} "
            f"channels over {axis!r}: a rank's channels must be its heads' "
            "or its part of every head's")
    return axis, axis is not None and heads is None


def _mlstm_qkvif(params, xu, axis=None, whole=False):
    """q, k, v [b, s, h, hd] and the input and forget gates [b, s, h] of
    the rank's heads from its channels ``xu``. Under a mesh the gates'
    product is a partial sum over the channels: reduce-scattered onto the
    rank's heads (its backward gathers their gradients), or all-reduced
    where every rank runs every head (``whole``), whose q, k and v then
    read every rank's channels."""
    gates = einsum("bsi,igh->bsgh", xu, params["w_if"])
    if whole:
        gates = shard_ctx.psum(gates, axis)
        # Replicated consumers: the backward keeps this rank's slice.
        xu = shard_ctx.all_gather(xu, axis, dim=xu.dim() - 1,
                                  partial_grad=False)
    elif axis is not None:
        gates = shard_ctx.reduce_scatter(gates, axis, 3)
    b, s, inner = xu.shape
    h = params["wq"].shape[0]
    xh = xu.reshape(b, s, h, inner // h)
    q = einsum("bshe,hek->bshk", xh, params["wq"])
    k = einsum("bshe,hek->bshk", xh, params["wk"])
    v = einsum("bshe,hek->bshk", xh, params["wv"])
    gates = gates + params["b_if"]
    return q, k, v, gates[:, :, 0, :], gates[:, :, 1, :] + 3.0


def _mlstm_in(params, x, axis=None):
    """(xu, z): the two halves of the up projection, the rank's channels
    of each."""
    x = shard_ctx.enter_stream(x, axis)
    xz = einsum("bsd,di->bsi", x, params["up_proj"])
    if axis is not None:
        xz = own_channels(xz, axis)
    return torch.chunk(xz, 2, dim=-1)


def _out_norm(params, h, inner, axis=None, eps: float = 1e-6):
    """``out_norm``: one RMS norm over all ``inner`` channels, of which
    ``h`` holds the rank's. The sum of squares is all-reduced over
    ``axis``; with and without it the norm is this one expression, so on a
    mesh of one rank it rounds as on one card."""
    dtype = h.dtype
    x = h.float()
    ss = torch.sum(torch.square(x), dim=-1, keepdim=True)
    scale = params["out_norm"]["scale"]
    if axis is not None:
        # Each rank's channels read the whole sum and their part of the
        # replicated scale: both gradients are partial sums.
        ss = shard_ctx.enter(shard_ctx.psum(ss, axis), axis)
        _, lo = shard_ctx.split(SSM_INNER, h.shape[-1], inner)
        scale = shard_ctx.enter(scale, axis).narrow(0, lo, h.shape[-1])
    y = x * torch.rsqrt(ss / inner + eps)
    return (y * scale.float()).to(dtype)


def _mlstm_out(params, h, z, x, axis=None, whole=False):
    """The block's output from the heads' ``h`` and the rank's channels
    ``z``. Where every rank ran every head (``whole``), ``h`` is the whole
    width: normalised whole, then the rank keeps its channels (a partial
    gradient each, summed on the way back into the replicated part)."""
    inner = params["out_norm"]["scale"].shape[0]
    if whole:
        h = _out_norm(params, h, inner)
        _, lo = shard_ctx.split(SSM_INNER, z.shape[-1], inner)
        h = shard_ctx.enter(h, axis).narrow(-1, lo, z.shape[-1])
    else:
        h = _out_norm(params, h, inner, axis)
    h = h * F.silu(z.float()).to(x.dtype)
    y = einsum("bsi,id->bsd", h, params["down_proj"])
    return shard_ctx.exit_stream(y, axis)


# The chunk of ``mlstm_impl="chunkwise"`` (the JAX package's
# ``kernels.mlstm.ops.mlstm`` default).
CHUNK = 512


def mlstm_apply(params, x, cfg, *, impl: str = "auto",
                mlstm_impl: str = "ref", state=None):
    """Full-sequence mLSTM block. x: [b, s, d]. ``mlstm_impl="chunkwise"``
    runs the mixer as ``mlstm_chunkwise_xla`` (chunks of ``CHUNK``), else
    ``impl`` picks the kernel or the parallel form.

    With ``state`` (prefill), the state after the last token is written
    into it in closed form (``kernels.mlstm.mlstm_final_state``) from the
    same q/k/v and gates, and ``(y, state)`` is returned: the state the
    JAX package rebuilds by scanning ``mlstm_step`` from m = -1e30, which
    ignores the C and n it is given."""
    axis, whole = _mlstm_axis(params, cfg)
    xu, z = _mlstm_in(params, x, axis)
    b, s = xu.shape[:2]
    q, k, v, ig, fg = (t.contiguous()
                       for t in _mlstm_qkvif(params, xu, axis, whole))
    if mlstm_impl == "chunkwise":
        h = mlstm_chunkwise_xla(q, k, v, ig, fg, chunk=CHUNK)
    else:
        h = mlstm(q, k, v, ig, fg, impl=impl)                 # [b,s,h,hd]
    y = _mlstm_out(params, h.reshape(b, s, -1), z, x, axis, whole)
    if state is None:
        return y
    for key, val in zip(("C", "n", "m"), mlstm_final_state(k, v, ig, fg)):
        state[key].copy_(val)
    return y, state


def mlstm_decode(params, x, cfg, state):
    """Single-token step. x: [b, 1, d]; ``state`` is updated in place."""
    b = x.shape[0]
    axis, whole = _mlstm_axis(params, cfg)
    xu, z = _mlstm_in(params, x, axis)
    q, k, v, ig, fg = _mlstm_qkvif(params, xu, axis, whole)
    h, _ = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0],
                      state["C"], state["n"], state["m"])
    return _mlstm_out(params, h.reshape(b, 1, -1), z, x, axis,
                      whole), state


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, exp gating, per-head recurrent weights)
# ---------------------------------------------------------------------------

def slstm_template(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    ff = _slstm_ff(cfg)
    return {
        # 4 gates (z, i, f, o) from input and recurrent h (block-diagonal).
        "w_x": P((d, 4, h, hd), (EMBED, None, HEADS, HEAD_DIM)),
        "r_h": P((h, hd, 4, hd), (HEADS, HEAD_DIM, None, HEAD_DIM),
                 init="normal", scale=0.02),
        "bias": P((4, h, hd), (None, HEADS, HEAD_DIM), init="zeros"),
        "ffn_up": P((d, ff), (EMBED, MLP)),
        "ffn_down": P((ff, d), (MLP, EMBED)),
    }


def slstm_state_template(cfg, batch: int, dtype=None):
    h = cfg.n_heads
    hd = cfg.d_model // h

    def z():
        return P((batch, h, hd), ("batch", HEADS, HEAD_DIM), init="zeros",
                 dtype=torch.float32)
    return {"c": z(), "n": z(), "h": z(),
            "m": P((batch, h), ("batch", HEADS), init="zeros",
                   dtype=torch.float32)}


def _slstm_cell(params, xt, state):
    """One sLSTM step. xt: [b, 4, h, hd], the input projection. Returns
    (h, new state) as new tensors."""
    c, n, hh, m = state["c"], state["n"], state["h"], state["m"]
    rec = einsum("bhd,hdge->bghe", hh.to(xt.dtype), params["r_h"])
    g = (xt + rec + params["bias"]).float()
    z_t = torch.tanh(g[:, 0])
    i_t = g[:, 1]
    f_t = g[:, 2] + 3.0
    o_t = torch.sigmoid(g[:, 3])
    # Stabilised exponential gating (per head: one shared max state m).
    i_max = torch.amax(i_t, dim=-1)
    f_max = torch.amax(f_t, dim=-1)
    m_new = torch.maximum(f_max + m, i_max)
    ip = torch.exp(i_t - m_new[..., None])
    fp = torch.exp(f_t + (m - m_new)[..., None])
    c_new = fp * c + ip * z_t
    n_new = fp * n + ip
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_ff(cfg) -> int:
    return max((4 * cfg.d_model) // 3 // 128 * 128, 128)


def _slstm_axis(params, cfg):
    """The mesh axis the sLSTM's heads are split over, or None."""
    axis, _ = shard_ctx.split(HEADS, params["w_x"].shape[2], cfg.n_heads)
    return axis


def _slstm_ffn(params, y, x, cfg, axis=None):
    """The block's FFN over ``y``, the heads' outputs of this rank: under
    a mesh they are all-gathered to the model width first, and the GELU
    MLP is split over its columns as ``layers.swiglu`` is."""
    if axis is not None:
        y = shard_ctx.all_gather(y, axis, dim=y.dim() - 1,
                                 partial_grad=False)
    mlp, _ = shard_ctx.split(MLP, params["ffn_up"].shape[1], _slstm_ff(cfg))
    if mlp is not None:
        y = shard_ctx.enter(y, mlp)
    y = einsum("bsd,df->bsf", y, params["ffn_up"])
    # jax.nn.gelu's default is the tanh approximation.
    y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
    y = einsum("bsf,fd->bsd", y, params["ffn_down"])
    return shard_ctx.exit_stream(y, mlp)


def slstm_apply(params, x, cfg, *, state=None):
    """Full-sequence sLSTM, a loop over the tokens. x: [b, s, d].

    Starts from ``state`` when given (the prefill: the cache's state, as
    in the JAX package), then writes the last token's state into it and
    returns ``(y, state)``; from zeros otherwise, returning ``y``."""
    axis = _slstm_axis(params, cfg)
    x_in = shard_ctx.enter_stream(x, axis)
    b, s, d = x_in.shape
    h, hd = params["w_x"].shape[2], d // cfg.n_heads
    xg = einsum("bsd,dghe->bsghe", x_in, params["w_x"])       # [b,s,4,h,hd]
    st = state
    if st is None:
        zero = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
        st = {"c": zero, "n": zero, "h": zero,
              "m": torch.zeros((b, h), dtype=torch.float32, device=x.device)}

    def step(t):
        nonlocal st
        h_out, st = _slstm_cell(params, xg[:, t], st)
        return h_out
    hs = token_loop.run(s, step)
    y = torch.stack(hs, dim=1).reshape(b, s, h * hd).to(x.dtype)
    y = _slstm_ffn(params, y, x, cfg, axis)
    if state is None:
        return y
    for key, val in st.items():
        state[key].copy_(val)
    return y, state


def slstm_decode(params, x, cfg, state):
    """Single-token step. x: [b, 1, d]; ``state`` is updated in place."""
    b = x.shape[0]
    axis = _slstm_axis(params, cfg)
    x_in = shard_ctx.enter_stream(x, axis)
    xg = einsum("bsd,dghe->bsghe", x_in, params["w_x"])[:, 0]
    h_out, new = _slstm_cell(params, xg, state)
    for key, val in new.items():
        state[key].copy_(val)
    y = h_out.reshape(b, 1, -1).to(x.dtype)
    return _slstm_ffn(params, y, x, cfg, axis), state
