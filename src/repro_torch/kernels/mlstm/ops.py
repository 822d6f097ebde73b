"""Wrapper of the chunkwise mLSTM kernel (the mLSTM's prefill mixer).

``mlstm`` takes the plain PyTorch version (``ref.mlstm_parallel_ref``) for
tensors on the CPU and launches the CUDA kernel for tensors on a CUDA
device, after checking device, dtype, shape and contiguity; there is no
fallback from the kernel to the plain version. ``impl`` is read as in
``kernels.attention_common``: ``"torch"`` asks for the plain version on
any device (the comparison runs on the card use it). As in the JAX
package, ``F = cumsum(logsigmoid(f))`` is computed outside the kernel, in
f32. ``launches`` counts kernel launches (the plain version never counts).
The decode step (``ref.mlstm_step``) has no kernel in either package.
"""
from __future__ import annotations

import torch

from ..attention_common import check_operands, refuse_grad, use_kernel
from . import kernel, ref

launches = {"mlstm_chunkwise": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check_head_dim(d: int) -> None:
    """The mLSTM's own head-dim check: its heads are wider than attention's
    (1024 at xlstm-1.3b)."""
    if d < 16 or d > 4096 or d % 16:
        raise ValueError(f"mlstm head dim {d}: the kernel takes multiples "
                         "of 16 from 16 to 4096")


def mlstm(q, k, v, i_gate, f_gate, *, impl: str = "auto") -> torch.Tensor:
    """q, k, v: [b, s, h, d]; i_gate, f_gate: [b, s, h] pre-activations ->
    [b, s, h, d] in q's dtype. See ``ref.mlstm_parallel_ref``."""
    if not use_kernel(impl, q, k, v, i_gate, f_gate):
        return ref.mlstm_parallel_ref(q, k, v, i_gate, f_gate)
    refuse_grad("mlstm", q, k, v, i_gate, f_gate)
    if (q.dim() != 4 or k.shape != q.shape or v.shape != q.shape
            or i_gate.shape != q.shape[:3] or f_gate.shape != q.shape[:3]):
        raise ValueError(f"mlstm: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, gates "
                         f"{tuple(i_gate.shape)} / {tuple(f_gate.shape)}")
    b, s, h, d = q.shape
    check_head_dim(d)
    if b * h > 65535:
        raise ValueError(f"mlstm: b * h = {b * h} exceeds the grid's 65535")
    check_operands("mlstm", {"q": q, "k": k, "v": v, "i_gate": i_gate,
                             "f_gate": f_gate})
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"mlstm: {key} is not 16-byte aligned (the "
                             "kernel copies 16-byte units)")
    cum_f = torch.cumsum(torch.nn.functional.logsigmoid(f_gate.float()),
                         dim=1)
    out = torch.empty_like(q)
    kernel.mlstm_chunkwise(q, k, v, cum_f, i_gate.float(), out,
                           scale=d ** -0.5)
    launches["mlstm_chunkwise"] += 1
    return out
