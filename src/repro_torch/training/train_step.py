"""The train step: microbatch-accumulated gradients and AdamW (the JAX
package's ``training/train_step.py``).

Gradients are taken by autograd in the parameters' dtype and cast to f32;
microbatches accumulate into an f32 tree, scaled by 1 / n_microbatches
(the JAX package unrolls n <= 2 and scans beyond; here both are one
Python loop). Remat happens inside the model's per-period checkpointing
(``models.transformer._remat``). The model must run its plain versions
(``build(cfg, impl="torch")``, or CPU tensors): the CUDA kernels have no
backward pass and refuse to run under autograd.

Optional int8 gradient compression (``training.compression``) models the
data-parallel all-reduce's wire format; as in the JAX package it applies
only when ``dp_axes`` names data-parallel axes.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.common import tree_leaves, tree_map
from . import optimizer as opt_mod
from .compression import compress_grads


def split_microbatches(batch: dict, n: int) -> dict:
    """[gb, ...] -> [n, gb / n, ...] for every leaf (tensors or numpy
    arrays)."""
    def sp(x):
        gb = x.shape[0]
        assert gb % n == 0, (gb, n)
        return x.reshape(n, gb // n, *x.shape[1:])
    return {k: sp(v) for k, v in batch.items()}


def _value_and_grad(model, params, batch):
    """(loss, f32 gradient tree) of ``model.loss`` at ``params``, the
    gradients taken in the parameters' dtype (autograd on detached aliases
    of the leaves) and cast to f32 one leaf at a time."""
    gparams = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = model.loss(gparams, batch)
        grads = list(torch.autograd.grad(loss, tree_leaves(gparams)))
    grads.reverse()
    # tree_map visits the leaves in tree_leaves' order: pop from the end of
    # the reversed list, so each low-precision gradient is freed once cast.
    return loss.detach(), tree_map(lambda p: grads.pop().float(), params)


def make_train_step(model, opt_cfg: opt_mod.AdamWConfig,
                    n_microbatches: int = 1, compression: bool = False,
                    dp_axes: Optional[tuple] = None,
                    pre_constrain: Optional[Callable] = None,
                    donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"loss", "grad_norm", "lr"} as 0-d tensors.

    ``pre_constrain``: an optional params -> params map applied once
    before the microbatch loop (the JAX package reshards FSDP weights
    there; on one card it is any map the caller wants applied once), the
    gradients taken at its output. ``donate=True`` lets the optimizer
    write the new parameters and moments into the given trees
    (``optimizer.update``), as the JAX launcher donates them."""

    def compute_grads(params, batch):
        if n_microbatches == 1:
            return _value_and_grad(model, params, batch)
        mbs = split_microbatches(batch, n_microbatches)
        loss = None
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        for i in range(n_microbatches):
            l, grads = _value_and_grad(model, params,
                                       {k: v[i] for k, v in mbs.items()})
            loss = l.float() if loss is None else loss + l
            gacc = tree_map(lambda a, g: a.add_(g), gacc, grads)
            del grads
        inv = 1.0 / n_microbatches
        return loss * inv, tree_map(lambda g: g.mul_(inv), gacc)

    def train_step(params, opt_state, batch):
        gparams = pre_constrain(params) if pre_constrain else params
        loss, grads = compute_grads(gparams, batch)
        if compression and dp_axes:
            grads = compress_grads(grads, dp_axes)
        params, opt_state, metrics = opt_mod.update(
            params, grads, opt_state, opt_cfg, donate=donate)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(model):
    """Returns eval_step(params, batch) -> the loss under
    ``torch.no_grad()`` (a model built with ``impl="auto"`` runs its CUDA
    kernels here)."""
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch)
    return eval_step
