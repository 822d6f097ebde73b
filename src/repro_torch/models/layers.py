"""Primitive layers: RMS and layer norms, rotary embeddings, SwiGLU and
GELU MLPs, embeddings, and the training loss (``softmax_xent``).

Dtypes follow the JAX package's promotion: the norms compute in f32
and return their input's dtype, and a product of a bf16 activation with an
f32 weight is taken in f32 (``jnp.promote_types``). ``torch.einsum``
refuses mixed dtypes instead of promoting, so :func:`einsum` casts both
operands to their promoted type first.

Under a mesh (``sharding.ctx``) the layers run on this rank's slices and
issue the tensor-parallel collectives GSPMD inserts in the JAX package:
the vocab-sharded embedding is a masked local lookup summed over
``model``; ``unembed`` keeps the local vocab columns and ``softmax_xent``
reduces its max, sum of exponentials and label logit over ``model``; the
MLPs' output products are partial sums all-reduced over ``model`` (a bias
added once, after); ``own_channels`` moves a column-parallel block of
two halves onto the rank's channels of each. A dim split over no mesh
axis runs as on one card. The embedding's output, the MLPs' input and
output and the unembedding's input are the residual stream's: on the
sequence-parallel path they pass through ``ctx.enter_stream`` and
``ctx.exit_stream``, whose collectives split and gather its sequence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding import ctx
from .common import EMBED, MLP, VOCAB, P


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over two operands promoted to one dtype, as
    ``jnp.einsum`` promotes them."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def rmsnorm_template(d: int):
    return {"scale": P((d,), (EMBED,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def layernorm_template(d: int):
    return {"scale": P((d,), (EMBED,), init="ones"),
            "bias": P((d,), (EMBED,), init="zeros")}


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


def rope_frequencies(head_dim: int, theta: float = 1e4,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               dims: int | None = None) -> torch.Tensor:
    """Rotate the first ``dims`` features of ``x`` [..., seq, heads, hd]
    by split halves; ``positions`` [..., seq] are absolute positions."""
    hd = x.shape[-1]
    dims = dims or hd
    freqs = rope_frequencies(dims, theta, device=x.device)     # [dims/2]
    angles = positions[..., None].float() * freqs               # [.., s, d/2]
    cos = torch.cos(angles)[..., None, :]                       # [.., s, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x[..., :dims].float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if dims < hd:
        return torch.cat([out.to(x.dtype), x[..., dims:]], dim=-1)
    return out.to(x.dtype)


def swiglu_template(d: int, ff: int):
    return {"wi_gate": P((d, ff), (EMBED, MLP)),
            "wi_up": P((d, ff), (EMBED, MLP)),
            "wo": P((ff, d), (MLP, EMBED))}


def swiglu(params, x: torch.Tensor, width: int | None = None
           ) -> torch.Tensor:
    """``width``: the global MLP width, needed under a mesh whose model
    axis has extent > 1 (``ctx.split``)."""
    axis, _ = ctx.split(MLP, params["wi_gate"].shape[-1], width)
    x = ctx.enter_stream(x, axis)
    gate = einsum("...d,df->...f", x, params["wi_gate"])
    up = einsum("...d,df->...f", x, params["wi_up"])
    h = F.silu(gate.float()).to(x.dtype) * up
    y = einsum("...f,fd->...d", h, params["wo"])
    return ctx.exit_stream(y, axis)


def own_channels(xz: torch.Tensor, axis) -> torch.Tensor:
    """[x | z] of this rank's channels from its block of the columns of a
    column-parallel product whose columns are two halves x and z of
    ``inner`` channels each (Mamba's ``in_proj``, the mLSTM's
    ``up_proj``). In chunks of c = inner / tp columns the product's
    columns are x_0 .. x_{tp-1}, z_0 .. z_{tp-1}; rank r holds chunks 2r
    and 2r + 1 and needs x_r and z_r (chunks r and tp + r), so chunk k
    goes to rank k % tp and comes from rank k // 2."""
    m = ctx.mesh()
    tp, r = m.extent(axis), m.coord(axis)
    c = xz.shape[-1] // 2
    held = sorted((k % tp, k) for k in (2 * r, 2 * r + 1))   # (to, chunk)
    send, recv = [0] * tp, [0] * tp
    for dest, _ in held:
        send[dest] += c
    for k in (r, tp + r):
        recv[k // 2] += c
    parts = [xz[..., (k - 2 * r) * c:(k - 2 * r + 1) * c] for _, k in held]
    # Chunks arrive by source rank, x_r's (r // 2) never after z_r's.
    # Contiguous, as the product is: the halves' strides, and so the
    # products' rounding in the backward pass, stay those of one card.
    return ctx.all_to_all_v(torch.cat(parts, dim=-1), axis, xz.dim() - 1,
                            send, recv).contiguous()


def gelu_mlp_template(d: int, ff: int):
    return {"wi": P((d, ff), (EMBED, MLP)),
            "bi": P((ff,), (MLP,), init="zeros"),
            "wo": P((ff, d), (MLP, EMBED)),
            "bo": P((d,), (EMBED,), init="zeros")}


def gelu_mlp(params, x: torch.Tensor, width: int | None = None
             ) -> torch.Tensor:
    """The audio family's FFN: ``jax.nn.gelu``'s default, the tanh
    approximation, taken in f32 and cast back to the stream's dtype."""
    axis, _ = ctx.split(MLP, params["wi"].shape[-1], width)
    x = ctx.enter_stream(x, axis)
    h = einsum("...d,df->...f", x, params["wi"]) + params["bi"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = einsum("...f,fd->...d", h, params["wo"])
    return ctx.exit_stream(y, axis) + ctx.stream_param(params["bo"])


def embedding_template(vocab: int, d: int):
    return {"table": P((vocab, d), (VOCAB, EMBED), init="embed", scale=0.02)}


def embed(params, tokens: torch.Tensor, vocab: int | None = None
          ) -> torch.Tensor:
    """Rows of the table for ``tokens``; over a vocab-sharded table, a
    lookup of the local rows (zeros for tokens held elsewhere) summed over
    the vocab axis. ``vocab``: the table's global rows (the padded
    vocabulary), needed under a mesh (``ctx.split``)."""
    table = params["table"]
    axis, lo = ctx.split(VOCAB, table.shape[0], vocab)
    if axis is None:
        return ctx.exit_stream(table[tokens.long()], None)
    ids = tokens.long() - lo
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    out = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return ctx.exit_stream(out, axis)


def unembed_template(d: int, vocab: int):
    return {"w": P((d, vocab), (EMBED, VOCAB), init="fan_in")}


def unembed(params, x: torch.Tensor, vocab: int | None = None
            ) -> torch.Tensor:
    """Logits over this rank's vocab columns (all of them on one card)."""
    axis, _ = ctx.split(VOCAB, params["w"].shape[-1], vocab)
    x = ctx.enter_stream(x, axis)
    return einsum("...d,dv->...v", x, params["w"])


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_real: int, z_loss: float = 1e-4,
                 vocab: int | None = None) -> torch.Tensor:
    """Mean per-token cross-entropy with padded-vocabulary masking and a
    z-loss (``z_loss * logz**2``), in f32.

    ``vocab_real``: the true vocabulary size; logit columns at or beyond it
    (padding for divisibility) are set to -1e30 before the logsumexp, as
    the JAX package masks them (in the logits' dtype, then cast to
    f32). The logsumexp is ``torch.logsumexp``'s own decomposition (the
    max, an infinite max taken as 0, the sum of exponentials): over
    vocab-sharded logits (``unembed`` under a mesh) the padding mask reads
    the global column index, and the max, the sum and the label's logit
    are reduced over the vocab axis, so every rank of it holds the whole
    loss. ``vocab``: the global (padded) columns, needed under a mesh."""
    v = logits.shape[-1]
    axis, lo = ctx.split(VOCAB, v, vocab)
    cols = torch.arange(lo, lo + v, device=logits.device)
    if vocab_real < lo + v:
        logits = torch.where(cols < vocab_real, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=logits.device))
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    if axis:
        m = ctx.pmax(m, axis)
    m = m.masked_fill(m.abs() == float("inf"), 0.0)
    sumexp = torch.sum(torch.exp(logits - m), dim=-1)
    ids = labels.long()[..., None] - lo
    ll = torch.gather(logits, -1, ids.clamp(0, v - 1)).squeeze(-1)
    if axis:
        sumexp = ctx.psum(sumexp, axis)
        mine = ((ids >= 0) & (ids < v)).squeeze(-1)
        ll = ctx.psum(torch.where(mine, ll, torch.zeros_like(ll)), axis)
    logz = torch.log(sumexp) + m.squeeze(-1)
    loss = logz - ll
    if z_loss:
        loss = loss + z_loss * torch.square(logz)
    return torch.mean(loss)
