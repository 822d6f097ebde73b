"""Wrapper of the flash decode kernel (one query token vs a KV cache).

``decode_attention`` takes the plain PyTorch version (``ref.decode_ref``)
for tensors on the CPU and launches the CUDA kernel for tensors on a CUDA
device, after checking device, dtype, shape and contiguity; there is no
fallback from the kernel to the plain version. ``impl`` is read as in
``kernels.attention_common``. ``launches`` counts wrapper calls that
launch the kernel, one per call although the kernel runs as two passes
(split, then combine); the plain version never counts.
"""
from __future__ import annotations

import torch

from ..attention_common import (check_head_dim, check_operands,
                                refuse_grad, use_kernel)
from . import kernel, ref

launches = {"flash_decode": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     impl: str = "auto") -> torch.Tensor:
    """q: [b, h, d]; caches: [b, t, kvh, d]; kv_len: int32 [b] ->
    [b, h, d] in q's dtype."""
    if not use_kernel(impl, q, k_cache, v_cache, kv_len):
        return ref.decode_ref(q, k_cache, v_cache, kv_len)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    if (q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape
            or kv_len.shape != (q.shape[0],)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kvh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"fit the cache {tuple(k_cache.shape)}")
    check_head_dim(d)
    check_operands("decode_attention",
                   {"q": q, "k_cache": k_cache, "v_cache": v_cache})
    if kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
        raise TypeError(f"decode_attention: kv_len must be contiguous "
                        f"int32, got {kv_len.dtype}")
    for key, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {key} is not 16-byte "
                             "aligned (the kernel copies 16-byte units)")
    out = torch.empty_like(q)
    kernel.flash_decode(q, k_cache, v_cache, kv_len, out, scale=d ** -0.5)
    launches["flash_decode"] += 1
    return out
