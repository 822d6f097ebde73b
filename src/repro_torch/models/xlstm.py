"""xLSTM blocks: the mLSTM (matrix memory; its prefill mixer is the
``mlstm_chunkwise`` kernel) and the sLSTM (scalar memory, a per-token
loop: the JAX package has no kernel for it either, its recurrence has no
matrix-unit work and few FLOPs next to the mLSTM layers).

Templates, key names and einsum layouts are the JAX package's
(``models/xlstm.py``). The recurrent states of a cache are written in
place: a prefill given ``state`` writes the state after its last token
into it, and a decode step updates it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mlstm import (mlstm, mlstm_chunkwise_xla, mlstm_final_state,
                             mlstm_step)
from .common import EMBED, HEAD_DIM, HEADS, MLP, SSM_INNER, P
from .layers import einsum, rmsnorm, rmsnorm_template


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


def _mlstm_qkvif(params, xu):
    b, s, inner = xu.shape
    h = params["wq"].shape[0]
    xh = xu.reshape(b, s, h, inner // h)
    q = einsum("bshe,hek->bshk", xh, params["wq"])
    k = einsum("bshe,hek->bshk", xh, params["wk"])
    v = einsum("bshe,hek->bshk", xh, params["wv"])
    gates = einsum("bsi,igh->bsgh", xu, params["w_if"]) + params["b_if"]
    return q, k, v, gates[:, :, 0, :], gates[:, :, 1, :] + 3.0


def _mlstm_in(params, x):
    """(xu, z): the two halves of the up projection."""
    xz = einsum("bsd,di->bsi", x, params["up_proj"])
    return torch.chunk(xz, 2, dim=-1)


def _mlstm_out(params, h, z, x):
    h = rmsnorm(params["out_norm"], h)
    h = h * F.silu(z.float()).to(x.dtype)
    return einsum("bsi,id->bsd", h, params["down_proj"])


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
    b, s, _ = x.shape
    xu, z = _mlstm_in(params, x)
    q, k, v, ig, fg = (t.contiguous() for t in _mlstm_qkvif(params, xu))
    if mlstm_impl == "chunkwise":
        h = mlstm_chunkwise_xla(q, k, v, ig, fg, chunk=CHUNK)
    else:
        h = mlstm(q, k, v, ig, fg, impl=impl)                 # [b,s,h,hd]
    y = _mlstm_out(params, h.reshape(b, s, -1), z, x)
    if state is None:
        return y
    for key, val in zip(("C", "n", "m"), mlstm_final_state(k, v, ig, fg)):
        state[key].copy_(val)
    return y, state


def mlstm_decode(params, x, cfg, state):
    """Single-token step. x: [b, 1, d]; ``state`` is updated in place."""
    b = x.shape[0]
    xu, z = _mlstm_in(params, x)
    q, k, v, ig, fg = _mlstm_qkvif(params, xu)
    h, _ = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0],
                      state["C"], state["n"], state["m"])
    return _mlstm_out(params, h.reshape(b, 1, -1), z, x), state


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, exp gating, per-head recurrent weights)
# ---------------------------------------------------------------------------

def slstm_template(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    ff = max((4 * d) // 3 // 128 * 128, 128)
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


def _slstm_ffn(params, y, x):
    y = einsum("bsd,df->bsf", y, params["ffn_up"])
    # jax.nn.gelu's default is the tanh approximation.
    y = F.gelu(y.float(), approximate="tanh").to(x.dtype)
    return einsum("bsf,fd->bsd", y, params["ffn_down"])


def slstm_apply(params, x, cfg, *, state=None):
    """Full-sequence sLSTM, a loop over the tokens. x: [b, s, d].

    Starts from ``state`` when given (the prefill: the cache's state, as
    in the JAX package), then writes the last token's state into it and
    returns ``(y, state)``; from zeros otherwise, returning ``y``."""
    b, s, d = x.shape
    h = cfg.n_heads
    xg = einsum("bsd,dghe->bsghe", x, params["w_x"])          # [b,s,4,h,hd]
    st = state
    if st is None:
        zero = torch.zeros((b, h, d // h), dtype=torch.float32,
                           device=x.device)
        st = {"c": zero, "n": zero, "h": zero,
              "m": torch.zeros((b, h), dtype=torch.float32, device=x.device)}
    hs = []
    for t in range(s):
        h_out, st = _slstm_cell(params, xg[:, t], st)
        hs.append(h_out)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    y = _slstm_ffn(params, y, x)
    if state is None:
        return y
    for key, val in st.items():
        state[key].copy_(val)
    return y, state


def slstm_decode(params, x, cfg, state):
    """Single-token step. x: [b, 1, d]; ``state`` is updated in place."""
    b, _, d = x.shape
    xg = einsum("bsd,dghe->bsghe", x, params["w_x"])[:, 0]
    h_out, new = _slstm_cell(params, xg, state)
    for key, val in new.items():
        state[key].copy_(val)
    return _slstm_ffn(params, h_out.reshape(b, 1, d).to(x.dtype), x), state
