"""Logical axes -> mesh axes, dim by dim (the JAX package's
``sharding/spec.py``, copied: it imports nothing of JAX but the port keeps
its own copy).

``spec_dims`` is the placement: the same lists as the JAX package's, so a
``PartitionSpec`` there and a placement here can be compared as lists.
``mesh_dims`` is what the port's model code asks when it decides which
collective to issue: the same guards, except that a mesh axis of extent 1
still counts, so a mesh of one card runs every collective of the sharded
program over groups of one rank instead of skipping them.
"""
from __future__ import annotations

import numpy as np


def _resolve(shape, axes, rules: dict, keep_unit: bool):
    mesh_sizes = rules.get("_mesh_sizes", {})
    used: set = set()
    out = []
    for dim, ax in zip(shape, axes):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            out.append(None)
            continue
        maxes = (m,) if isinstance(m, str) else tuple(m)
        extent = int(np.prod([mesh_sizes.get(a, 1) for a in maxes]))
        if ((extent <= 1 and not keep_unit) or dim % extent != 0
                or any(a in used for a in maxes)):
            out.append(None)
            continue
        used.update(maxes)
        out.append(m)
    return out


def spec_dims(shape, axes, rules: dict):
    """Per-dim mesh assignment with divisibility + no-duplicate guards.

    A mesh axis may appear at most once in a PartitionSpec; when two logical
    dims map to the same mesh axis the earlier dim wins (templates order
    EXPERTS before EMBED etc. so the intended winner comes first).
    """
    return _resolve(shape, axes, rules, keep_unit=False)


def mesh_dims(shape, axes, rules: dict):
    """``spec_dims`` with mesh axes of extent 1 kept: the axes the port's
    collectives run over. Slicing a dim over an axis of extent 1 takes
    all of it, so both give the same local shapes."""
    return _resolve(shape, axes, rules, keep_unit=True)


def axes_of(entry) -> tuple:
    """A placement entry (a mesh axis, a tuple of them, or None) as a
    tuple of mesh axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, dims, mesh_sizes: dict) -> tuple:
    """The shape of one rank's slice of ``shape`` under placement
    ``dims``."""
    out = []
    for n, entry in zip(shape, dims):
        extent = int(np.prod([mesh_sizes.get(a, 1) for a in axes_of(entry)]))
        out.append(n // extent)
    return tuple(out)
