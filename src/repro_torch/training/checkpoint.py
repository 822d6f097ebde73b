"""Atomic checkpoints with a content hash per leaf (the JAX package's
``training/checkpoint.py`` and its on-disk format).

Layout (one directory per step)::

    <dir>/step_000000123.tmp-<nonce>/  # written first
        meta.json                      # tree structure, shapes, dtypes, hash
        leaf_00000.npy ...             # one file per leaf
    <dir>/step_000000123/              # atomic rename when complete

Writes are crash-safe: a partially written checkpoint never shadows a
complete one (rename is atomic on POSIX), and restore verifies each
leaf's sha256. Leaves are written in ``jax.tree.leaves``' order (dict keys
sorted, tuples and lists in order), so a checkpoint written by either
package restores in the other, leaf for leaf.

bf16 leaves: numpy has no bf16, and the JAX package's ``np.save`` of an
ml_dtypes bf16 array writes 2-byte void records ('V2') holding the raw
bf16 bits, with "bfloat16" as the leaf's dtype in ``meta.json``. The port
writes the same: the bits as 'V2' records and "bfloat16" in the meta, so
the bytes and the hash are the JAX package's, and it reads such a leaf
back as bf16 by its meta dtype. (The JAX package's own ``restore`` cannot
load a 'V2' leaf.)
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import uuid
from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


def _flatten(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order: dicts by sorted key, tuples and
    lists in order, None holds no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flatten(t)]
    return [] if tree is None else [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves``, in ``_flatten``'s order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return None if like is None else next(leaves)


def _treedef(tree) -> str:
    """The structure as ``str(jax.tree.structure(tree))`` writes it."""
    def rec(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {rec(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(rec(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(rec(x) for x in t) + "]"
        return "None" if t is None else "*"
    return f"PyTreeDef({rec(tree)})"


def _to_numpy(leaf):
    """(array as written, its meta dtype): a bf16 tensor as 'V2' records
    of its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def save(path: str, step: int, tree, keep: int = 3) -> str:
    """Atomically write a checkpoint of ``tree`` (nested dicts, tuples or
    lists of tensors or arrays) for ``step``; keep the newest ``keep``.
    Returns the final directory."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:09d}")
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    meta = {"step": step, "treedef": _treedef(tree), "leaves": []}
    for i, leaf in enumerate(_flatten(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        meta["leaves"].append({
            "file": fname, "shape": list(arr.shape), "dtype": dtype,
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        })
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.isdir(final):
        # A complete checkpoint for this step already exists (a restarted
        # run re-reaching the same step): keep it, drop ours.
        shutil.rmtree(tmp, ignore_errors=True)
        _cleanup(path, keep)
        return final
    os.rename(tmp, final)                         # atomic commit
    _cleanup(path, keep)
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and ".tmp" not in d]
    return max(steps) if steps else None


def restore(path: str, tree_like, step: Optional[int] = None,
            device=DEFAULT_DEVICE, verify: bool = True):
    """Load the checkpoint of ``step`` (the latest by default) into the
    structure of ``tree_like``, each leaf a tensor of its stored dtype on
    ``device`` (CUDA unless the CPU is asked for by name). Returns (tree,
    step). Raises ``FileNotFoundError`` without a checkpoint and
    ``IOError`` on a leaf whose sha256 differs from its meta's."""
    device = resolve_device(device)
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    n_like = len(_flatten(tree_like))
    if n_like != len(meta["leaves"]):
        raise ValueError(f"checkpoint/tree structure mismatch: "
                         f"{len(meta['leaves'])} leaves stored, {n_like} "
                         "asked for")
    out = []
    for info in meta["leaves"]:
        arr = np.load(os.path.join(d, info["file"]))
        if verify:
            h = hashlib.sha256(arr.tobytes()).hexdigest()
            if h != info["sha256"]:
                raise IOError(f"corrupt leaf {info['file']}")
        out.append(_from_numpy(arr, info["dtype"]).to(device))
    return _unflatten(tree_like, iter(out)), step


def _cleanup(path: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and ".tmp" not in d)
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)
    # Garbage-collect orphaned tmp dirs from crashed writers.
    for d in os.listdir(path):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(path, d), ignore_errors=True)
