"""Wrapper of the flash decode kernel (one query token vs a KV cache).

``decode_attention`` takes the plain PyTorch version (``ref.decode_ref``)
for tensors on the CPU and launches the CUDA kernel for tensors on a CUDA
device, after checking device, dtype, shape and contiguity; there is no
fallback from the kernel to the plain version. ``impl`` is read as in
``kernels.attention_common``.

``decode_split`` and ``decode_combine`` are the kernel's two passes apart,
for a cache whose rows are split over ranks: the split pass over one
rank's rows gives the partials ``[b, h, n_split, d + 2]`` (acc[d], the
running max m, the denominator l; f32), and the combine pass merges the
partials of any number of splits, such as every rank's put side by side
in row order. On the CPU they are ``ref.decode_partials_ref`` (under the
card's ``kernel.split_plan``) and ``ref.combine_partials``.

``launches`` counts wrapper calls that launch a kernel: one per
``decode_attention`` call although its kernel runs as two passes (split,
then combine), one per ``decode_split`` and per ``decode_combine`` call;
the plain versions never count.
"""
from __future__ import annotations

import torch

from ..attention_common import (check_head_dim, check_operands,
                                refuse_grad, use_kernel)
from . import kernel, ref

launches = {"flash_decode": 0, "flash_decode_split": 0,
            "flash_decode_combine": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(name, q, k_cache, v_cache, kv_len) -> None:
    """The kernel's operand checks (shapes, dtypes, contiguity,
    alignment)."""
    refuse_grad(name, q, k_cache, v_cache)
    if (q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape
            or kv_len.shape != (q.shape[0],)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not "
                         f"fit the cache {tuple(k_cache.shape)}")
    check_head_dim(d)
    check_operands(name, {"q": q, "k_cache": k_cache, "v_cache": v_cache})
    if kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
        raise TypeError(f"{name}: kv_len must be contiguous "
                        f"int32, got {kv_len.dtype}")
    for key, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte "
                             "aligned (the kernel copies 16-byte units)")


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     impl: str = "auto") -> torch.Tensor:
    """q: [b, h, d]; caches: [b, t, kvh, d]; kv_len: int32 [b] ->
    [b, h, d] in q's dtype."""
    if not use_kernel(impl, q, k_cache, v_cache, kv_len):
        return ref.decode_ref(q, k_cache, v_cache, kv_len)
    _check("decode_attention", q, k_cache, v_cache, kv_len)
    out = torch.empty_like(q)
    kernel.flash_decode(q, k_cache, v_cache, kv_len, out,
                        scale=q.shape[-1] ** -0.5)
    launches["flash_decode"] += 1
    return out


def decode_split(q, k_cache, v_cache, kv_len, *,
                 impl: str = "auto") -> torch.Tensor:
    """The split pass over a cache block: q [b, h, d]; caches [b, t, kvh,
    d]; kv_len int32 [b], the keys of the block to read (<= 0: none) ->
    f32 partials [b, h, n_split, d + 2], ``kernel.split_plan``'s splits.
    Where a split is empty, l = 0 and its acc is not to be read (zeros on
    the CPU, unwritten on the card)."""
    if not use_kernel(impl, q, k_cache, v_cache, kv_len):
        b, t, kvh = k_cache.shape[:3]
        m, l, acc = ref.decode_partials_ref(
            q, k_cache, v_cache, kv_len, *kernel.split_plan(b, t, kvh))
        return torch.cat([acc, m[..., None], l[..., None]], dim=-1)
    _check("decode_split", q, k_cache, v_cache, kv_len)
    ws = kernel.flash_decode_split(q, k_cache, v_cache, kv_len,
                                   scale=q.shape[-1] ** -0.5)
    launches["flash_decode_split"] += 1
    return ws


def decode_combine(ws, dtype, *, impl: str = "auto") -> torch.Tensor:
    """The combine pass: partials ``ws`` f32 [b, h, n, d + 2] -> [b, h, d]
    in ``dtype``; a row with no live split gives zeros."""
    if ws.dim() != 4 or ws.shape[-1] < 3:
        raise ValueError(f"decode_combine: partials {tuple(ws.shape)}")
    if not use_kernel(impl, ws):
        d = ws.shape[-1] - 2
        return ref.combine_partials(ws[..., d], ws[..., d + 1],
                                    ws[..., :d]).to(dtype)
    refuse_grad("decode_combine", ws)
    if ws.dtype != torch.float32 or not ws.is_contiguous():
        raise TypeError(f"decode_combine: partials must be contiguous "
                        f"float32, got {ws.dtype}")
    if dtype not in kernel.DTYPES:
        raise TypeError(f"decode_combine: dtype {dtype}")
    out = torch.empty(ws.shape[:2] + (ws.shape[-1] - 2,), dtype=dtype,
                      device=ws.device)
    kernel.flash_decode_combine(ws, out)
    launches["flash_decode_combine"] += 1
    return out
