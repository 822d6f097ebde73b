"""Dispatch policy and operand checks shared by the attention wrappers
(``flash_attention.ops`` and ``decode_attention.ops``).

``impl`` is ``"auto"`` (the CUDA kernel for CUDA tensors, the plain
version for CPU tensors) or ``"torch"`` (the plain version on any device:
the comparison runs on the card use it). There is no fallback from the
kernel to the plain version. The kernels have no backward pass: under
autograd, a launch on an operand that requires grad raises
(``refuse_grad``) instead of returning a result with no ``grad_fn``.
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


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel would launch on operands that autograd tracks.
    The kernels write their outputs through ctypes into fresh tensors, so
    a result would carry no ``grad_fn`` and a loss taken through it would
    silently lose every gradient that flows through the kernel. Training
    runs the plain versions (``impl="torch"``), which are differentiable;
    serving runs under ``torch.no_grad()``, where nothing is refused."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.is_floating_point() and t.requires_grad
           for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward pass and an operand "
            "requires grad; use impl=\"torch\" (the differentiable plain "
            "version) to train, or run under torch.no_grad()")


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
