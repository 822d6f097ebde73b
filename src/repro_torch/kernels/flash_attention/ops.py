"""Wrapper of the flash attention kernel (training / prefill attention).

``attention`` takes the plain PyTorch version (``ref.mha_ref``) for
tensors on the CPU and launches the CUDA kernel for tensors on a CUDA
device, after checking device, dtype, shape and contiguity; there is no
fallback from the kernel to the plain version. ``impl`` is read as in
``kernels.attention_common``: ``"torch"`` asks for the plain version on
any device (the comparison runs on the card use it). As in the
JAX package's dispatch, a ragged ``kv_len`` takes the plain version: the
kernel has no per-sequence length, and the serving engine's prefill does
not pass one. ``launches`` counts kernel launches (the plain version never
counts).
"""
from __future__ import annotations

import torch

from ..attention_common import (check_head_dim, check_impl, check_operands,
                                refuse_grad, use_kernel)
from . import kernel, ref

launches = {"flash_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              q_offset: int | None = None, kv_len=None,
              impl: str = "auto") -> torch.Tensor:
    """q: [b, s, h, d]; k, v: [b, t, kvh, d] -> [b, s, h, d] in q's dtype.
    See ``ref.mha_ref`` for the semantics."""
    if kv_len is not None:
        check_impl(impl)
    if kv_len is not None or not use_kernel(impl, q, k, v):
        return ref.mha_ref(q, k, v, causal=causal, scale=scale,
                           q_offset=q_offset, kv_len=kv_len)
    refuse_grad("attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"attention: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    check_head_dim(d)
    check_operands("attention", {"q": q, "k": k, "v": v})
    for key, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"attention: {key} is not 16-byte aligned (the "
                             "kernel copies 16-byte units)")
    scale = scale if scale is not None else d ** -0.5
    q_offset = (t - s) if q_offset is None else int(q_offset)
    out = torch.empty_like(q)
    kernel.flash_attention(q, k, v, out, scale=float(scale), causal=causal,
                           q_offset=q_offset)
    launches["flash_attention"] += 1
    return out
