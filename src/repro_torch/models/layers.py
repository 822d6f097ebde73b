"""Primitive layers: RMS and layer norms, rotary embeddings, SwiGLU and
GELU MLPs, embeddings, and the training loss (``softmax_xent``).

Dtypes follow the JAX package's promotion: the norms compute in f32
and return their input's dtype, and a product of a bf16 activation with an
f32 weight is taken in f32 (``jnp.promote_types``). ``torch.einsum``
refuses mixed dtypes instead of promoting, so :func:`einsum` casts both
operands to their promoted type first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    gate = einsum("...d,df->...f", x, params["wi_gate"])
    up = einsum("...d,df->...f", x, params["wi_up"])
    h = F.silu(gate.float()).to(x.dtype) * up
    return einsum("...f,fd->...d", h, params["wo"])


def gelu_mlp_template(d: int, ff: int):
    return {"wi": P((d, ff), (EMBED, MLP)),
            "bi": P((ff,), (MLP,), init="zeros"),
            "wo": P((ff, d), (MLP, EMBED)),
            "bo": P((d,), (EMBED,), init="zeros")}


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """The audio family's FFN: ``jax.nn.gelu``'s default, the tanh
    approximation, taken in f32 and cast back to the stream's dtype."""
    h = einsum("...d,df->...f", x, params["wi"]) + params["bi"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return einsum("...f,fd->...d", h, params["wo"]) + params["bo"]


def embedding_template(vocab: int, d: int):
    return {"table": P((vocab, d), (VOCAB, EMBED), init="embed", scale=0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed_template(d: int, vocab: int):
    return {"w": P((d, vocab), (EMBED, VOCAB), init="fan_in")}


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    return einsum("...d,dv->...v", x, params["w"])


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_real: int, z_loss: float = 1e-4) -> torch.Tensor:
    """Mean per-token cross-entropy with padded-vocabulary masking and a
    z-loss (``z_loss * logz**2``), in f32.

    ``vocab_real``: the true vocabulary size; logit columns at or beyond it
    (padding for divisibility) are set to -1e30 before the logsumexp, as
    the JAX package masks them (in the logits' dtype, then cast to
    f32)."""
    v = logits.shape[-1]
    if vocab_real < v:
        mask = torch.arange(v, device=logits.device) < vocab_real
        logits = torch.where(mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=logits.device))
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    loss = logz - ll
    if z_loss:
        loss = loss + z_loss * torch.square(logz)
    return torch.mean(loss)
