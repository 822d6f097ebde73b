"""Dispatch policy and operand checks shared by the attention wrappers
(``flash_attention.ops`` and ``decode_attention.ops``).

``impl`` is ``"auto"`` (the CUDA kernel for CUDA tensors, the plain
version for CPU tensors) or ``"torch"`` (the plain version on any device:
the comparison runs on the card use it). There is no fallback from the
kernel to the plain version.
"""
from __future__ import annotations

import torch

IMPLS = ("auto", "torch")
DTYPES = (torch.float32, torch.bfloat16)


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")


def use_kernel(impl: str, *tensors: torch.Tensor) -> bool:
    """True where the CUDA kernel runs: CUDA tensors under ``auto``. CPU
    tensors take the plain version; other devices and mixed devices
    raise."""
    check_impl(impl)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"attention: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"attention: unsupported device {dev}")
    return impl == "auto" and dev.type == "cuda"


def check_head_dim(d: int) -> None:
    if d < 16 or d > 256 or d % 16:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 16 "
                         "from 16 to 256")


def check_operands(name: str, tensors: dict) -> None:
    """One dtype (f32 or bf16) for all of ``tensors``, each contiguous."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPES:
        raise TypeError(f"{name}: dtypes {sorted(map(str, dtypes))}; the "
                        "kernel takes float32 or bfloat16, one for all")
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
