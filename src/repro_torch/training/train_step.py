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

Over a mesh (``spmd``: a :class:`MeshStep`) every rank holds its slices
of the parameters, optimizer state and batch rows. The model runs on the
FSDP-gathered layout (gathered once before the microbatch loop when the
gather is hoisted, per microbatch otherwise); gradients are summed over
the data axes (an all-reduce, or a reduce-scatter onto the FSDP shards;
a leaf whose forward layout is split over a data axis, like the experts,
already holds the sum) and averaged; the loss is averaged over the data
axes and the clip's norm reduces each leaf over its own mesh axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..models.common import tree_leaves, tree_map
from ..sharding import ctx as shard_ctx
from ..sharding import rules as rules_mod
from ..sharding.spec import axes_of, mesh_dims
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


@dataclasses.dataclass
class MeshStep:
    """How a train step runs over a mesh: the stored layout (``rules``,
    FSDP included) of ``template``'s leaves, the forward layout the model
    runs on (``rules.gathered``), and whether the FSDP gather is hoisted
    out of the microbatch loop."""
    mesh: object
    rules: dict
    template: dict
    hoist: bool = False

    def __post_init__(self):
        self.model_rules = rules_mod.gathered(self.rules)
        self.dp_axes = tuple(axes_of(self.rules["batch"]))
        self.dp = math.prod(self.mesh.shape.get(a, 1) for a in self.dp_axes)
        self.stored = tree_map(lambda p: mesh_dims(p.shape, p.axes,
                                                   self.rules), self.template)
        self.forward = tree_map(lambda p: mesh_dims(p.shape, p.axes,
                                                    self.model_rules),
                                self.template)

    def gather(self, params):
        """The forward layout of stored slices: each FSDP dim gathered
        over its data axis (and a data split that moved to another dim,
        like the router's under FSDP, taken there). No autograd."""
        m = self.mesh

        def leaf(t, st, fw):
            for d, (s, f) in enumerate(zip(st, fw)):
                for a in reversed(axes_of(s)):
                    if a not in axes_of(f):
                        t = shard_ctx.gather_dim(t, a, d, m)
            for d, (s, f) in enumerate(zip(st, fw)):
                for a in axes_of(f):
                    if a not in axes_of(s):
                        t = shard_ctx.slice_dim(t, a, d, m)
            return t.contiguous()
        return tree_map(leaf, params, self.stored, self.forward)

    def reduce(self, grads):
        """Forward-layout gradients -> the stored layout, summed over the
        data axes where the forward pass did not already sum them, then
        divided by the data extent. In place where it can."""
        m = self.mesh

        def leaf(g, st, fw):
            fw_axes = {a for f in fw for a in axes_of(f)}
            for a in self.dp_axes:
                if a in fw_axes:
                    continue
                dims = [d for d, s in enumerate(st) if a in axes_of(s)]
                if dims:
                    g = shard_ctx.scatter_dim(g, a, dims[0], m)
                else:
                    g = shard_ctx.all_reduce(g.contiguous(), a, m=m)
            for d, (s, f) in enumerate(zip(st, fw)):
                for a in axes_of(f):
                    if a not in axes_of(s):
                        g = shard_ctx.gather_dim(g, a, d, m)
            for d, (s, f) in enumerate(zip(st, fw)):
                for a in axes_of(s):
                    if a not in axes_of(f) and a in fw_axes:
                        g = shard_ctx.slice_dim(g, a, d, m)
            return g.contiguous().mul_(1.0 / self.dp)
        return tree_map(leaf, grads, self.stored, self.forward)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data axes of a per-rank value."""
        return shard_ctx.all_reduce(x.detach().clone(), self.dp_axes,
                                    m=self.mesh) / self.dp


def make_train_step(model, opt_cfg: opt_mod.AdamWConfig,
                    n_microbatches: int = 1, compression: bool = False,
                    dp_axes: Optional[tuple] = None,
                    pre_constrain: Optional[Callable] = None,
                    donate: bool = False, spmd: Optional[MeshStep] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"loss", "grad_norm", "lr"} as 0-d tensors.

    ``pre_constrain``: an optional params -> params map applied once
    before the microbatch loop (the JAX package reshards FSDP weights
    there; on one card it is any map the caller wants applied once), the
    gradients taken at its output. ``donate=True`` lets the optimizer
    write the new parameters and moments into the given trees
    (``optimizer.update``), as the JAX launcher donates them.

    ``spmd``: run over a mesh (module docstring). Each rank passes its
    slices and its batch rows; ``pre_constrain`` defaults to the hoisted
    FSDP gather when ``spmd.hoist``, and the step's metrics are the same
    on every rank."""
    hoisted = spmd is not None and spmd.hoist
    if hoisted and pre_constrain is None:
        pre_constrain = spmd.gather
    per_micro = spmd is not None and not hoisted

    def grads_of(params, mb):
        if per_micro:
            params = spmd.gather(params)
        if spmd is None:
            return _value_and_grad(model, params, mb)
        with shard_ctx.activation_rules(spmd.model_rules):
            loss, grads = _value_and_grad(model, params, mb)
        return loss, spmd.reduce(grads) if per_micro else grads

    def compute_grads(params, batch):
        if n_microbatches == 1:
            return grads_of(params, batch)
        mbs = split_microbatches(batch, n_microbatches)
        loss = gacc = None
        for i in range(n_microbatches):
            l, grads = grads_of(params, {k: v[i] for k, v in mbs.items()})
            if gacc is None:
                gacc = tree_map(lambda g: torch.zeros(
                    g.shape, dtype=torch.float32, device=g.device), grads)
            loss = l.float() if loss is None else loss + l
            gacc = tree_map(lambda a, g: a.add_(g), gacc, grads)
            del grads
        inv = 1.0 / n_microbatches
        return loss * inv, tree_map(lambda g: g.mul_(inv), gacc)

    def train_step(params, opt_state, batch):
        gparams = pre_constrain(params) if pre_constrain else params
        loss, grads = compute_grads(gparams, batch)
        placements = mesh = None
        if spmd is not None:
            if hoisted:
                grads = spmd.reduce(grads)
            loss = spmd.mean(loss)
            placements, mesh = spmd.stored, spmd.mesh
        if compression and dp_axes:
            grads = compress_grads(grads, dp_axes)
        params, opt_state, metrics = opt_mod.update(
            params, grads, opt_state, opt_cfg, donate=donate,
            placements=placements, mesh=mesh)
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
