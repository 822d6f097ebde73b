"""Device policy of the port.

Entry points take ``device=`` and default to ``"cuda"``. Without a CUDA
device they raise instead of carrying on on the CPU: a CPU run has to be
asked for by name (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE
                   ) -> torch.device:
    """Return ``device`` as a ``torch.device``; raise when it names CUDA
    and no CUDA device is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
