"""Wrapper of the selective-scan kernel (every Mamba layer's prefill).

``selective_scan`` takes the plain PyTorch version
(``ref.selective_scan_ref``) for tensors on the CPU and launches the CUDA
kernel for tensors on a CUDA device, after checking device, dtype, shape
and contiguity; there is no fallback from the kernel to the plain version.
``impl`` is read as in ``kernels.attention_common``: ``"torch"`` asks for
the plain version on any device (the comparison runs on the card use it).
``launches`` counts kernel launches (the plain version never counts). The
decode step (``ref.selective_step``) has no kernel in either package.
"""
from __future__ import annotations

import torch

from ..attention_common import (DTYPES, check_operands, refuse_grad,
                                use_kernel)
from . import kernel, ref

launches = {"selective_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _f32(name: str, t: torch.Tensor) -> torch.Tensor:
    """f32 or bf16 -> f32 (exact); other dtypes raise."""
    if t.dtype not in DTYPES:
        raise TypeError(f"selective_scan: {name} is {t.dtype}; the kernel "
                        "takes float32 or bfloat16")
    return t.float()


def selective_scan(x, dt, A, B, C, D, h0=None, *, impl: str = "auto"):
    """x, dt: [b, s, inner] (f32 or bf16, one dtype); A: [inner, n]; B, C:
    [b, s, n]; D: [inner]; h0: [b, inner, n] f32 or None (zeros). Returns
    (y [b, s, inner] in x's dtype, h_last [b, inner, n] f32). See
    ``ref.selective_scan_ref``."""
    tensors = [x, dt, A, B, C, D] + ([] if h0 is None else [h0])
    if not use_kernel(impl, *tensors):
        return ref.selective_scan_ref(x, dt, A, B, C, D, h0)
    refuse_grad("selective_scan", *tensors)
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan: shapes x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}")
    b, s, inner = x.shape
    n = A.shape[1]
    if (dt.shape != x.shape or A.shape[0] != inner
            or B.shape != (b, s, n) or C.shape != (b, s, n)
            or D.shape != (inner,)
            or (h0 is not None and h0.shape != (b, inner, n))):
        raise ValueError(
            f"selective_scan: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, D {tuple(D.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}")
    if not 1 <= n <= kernel.MAX_STATE:
        raise ValueError(f"selective_scan: state size {n}; the kernel takes "
                         f"1 to {kernel.MAX_STATE}")
    if b > 65535:
        raise ValueError(f"selective_scan: batch {b} exceeds the grid's "
                         "65535")
    check_operands("selective_scan", {"x": x, "dt": dt})
    for key, t in (("A", A), ("B", B), ("C", C), ("D", D), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"selective_scan: {key} is not contiguous")
    if h0 is not None and h0.dtype != torch.float32:
        raise TypeError(f"selective_scan: h0 is {h0.dtype}; the state is "
                        "float32")
    y = torch.empty_like(x)
    h_last = torch.empty((b, inner, n), dtype=torch.float32, device=x.device)
    kernel.selective_scan(x, dt, _f32("A", A), _f32("B", B), _f32("C", C),
                          _f32("D", D), h0, y, h_last)
    launches["selective_scan"] += 1
    return y, h_last
