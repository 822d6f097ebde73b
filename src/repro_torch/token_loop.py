"""The per-token loops of the plain versions: the sLSTM's recurrence
(``models.xlstm.slstm_apply``) and the Mamba scan
(``kernels.selective_scan.ref.selective_scan_ref``), and the chunked
Mamba scan's loop over its chunks (``selective_scan_chunked``: a step is
then a chunk).

Each runs its tokens through ``run``, which is the plain loop. The dry
run (``launch.dryrun``) alone sets a hook here for the time it counts a
step: the hook runs a few tokens and counts the rest
(``dryrun.scaled_loop``), so a 32k-token cell is not traced token by
token. Serving and training never set it.

The hook is the process's, not a thread's or a context's: remat's
recompute runs the loop again inside the backward pass, which the
autograd engine runs on a thread of its own for CUDA tensors. The dry
run owns the process while it counts (it also joins the default process
group).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

_hook: Optional[Callable] = None


def run(n: int, step: Callable) -> list:
    """``[step(t) for t in range(n)]``: ``step`` runs token t (its carry
    lives in the caller's closure) and returns that token's output, or
    None."""
    if _hook is None:
        return [step(t) for t in range(n)]
    return _hook(n, step)


@contextlib.contextmanager
def hooked(hook: Callable):
    """Run every loop through ``hook(n, step)`` inside the block."""
    global _hook
    if _hook is not None:
        raise RuntimeError("a token-loop hook is already set")
    _hook = hook
    try:
        yield
    finally:
        _hook = None
