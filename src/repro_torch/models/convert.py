"""Carry a parameter or cache tree of the JAX package into the port.

The port keeps the JAX package's key names and layouts (einsum layouts
``[d, h, hd]``, ``[h, hd, d]``, stacked ``[L, ...]``), so a tree of numpy
arrays (``jax.tree.map(np.asarray, params)``) becomes the port's tree by a
leaf-wise copy: no transpose can slip in.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .common import tree_map


def params_from_numpy(tree, device=DEFAULT_DEVICE,
                      dtype: torch.dtype | None = None):
    """Copy a nested dict of numpy arrays (parameters, or a cache with its
    int32 ``len``) onto ``device`` (CUDA unless the CPU is asked for by
    name) as tensors; floating leaves are cast to
    ``dtype`` when it is given, integer leaves keep their type."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":          # ml_dtypes: no torch view
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return tree_map(leaf, tree)

