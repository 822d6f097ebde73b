"""Parameter templates shared by the port's models.

A model is described by a *template*: a nested dict whose leaves are
:class:`P` (shape, logical axes, initializer). ``init_params`` turns a
template into a tree of tensors on a device. The templates, their key
names and their einsum layouts (``[d, h, hd]``, ``[h, hd, d]``, stacked
``[L, ...]``) are those of the JAX package's ``models/common.py``, so a
parameter tree made there carries over leaf by leaf
(``models.convert.params_from_numpy``).

``init_params`` draws from a ``torch.Generator`` with the same
initializer kinds and scales as the JAX package; the values differ from
threefry's, so parity between the two packages comes from converting one
tree, never from initialising twice.

Under a mesh a template is also *placed* (``pspec_tree``: a ``spec_dims``
list per leaf), *sliced* (``shard_tree``: the rank's part of a full tree;
``gather_tree`` undoes it), *allocated locally* (``local_template``,
``init_sharded``) or *abstracted* (``abstract_params``: meta tensors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

# Logical axis vocabulary (the JAX package's names; ``sharding.rules`` maps
# them onto mesh axes).
EMBED = "embed"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"
VOCAB = "vocab"
EXPERTS = "experts"
EXPERT_MLP = "expert_mlp"
LAYERS = "layers"          # stacked layer dimension
CACHE_SEQ = "cache_seq"
SSM_INNER = "ssm_inner"
SSM_STATE = "ssm_state"
CONV = "conv"
LORA = "lora"              # low-rank dims (Mamba's dt rank)


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf template."""
    shape: tuple
    axes: tuple                 # logical axis name (or None) per dim
    init: str = "fan_in"        # fan_in | normal | zeros | ones | embed
    #                             | s4d | s4d_dt
    scale: Optional[float] = None
    dtype: Optional[Any] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (``P`` templates or
    tensors) in sorted-key order (``jax.tree.map``'s), keeping the
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (``jax.tree.leaves``'s order for
    dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _fan_in(p: P) -> int:
    fan_in = p.shape[0] if len(p.shape) == 1 else int(np.prod(p.shape[:-1]))
    # A stacked leaf's leading LAYERS dim is not a contraction dim.
    if p.axes and p.axes[0] == LAYERS and len(p.shape) > 2:
        fan_in = int(np.prod(p.shape[1:-1]))
    return fan_in


def _initializer(p: P, generator: torch.Generator, dtype, device):
    dtype = p.dtype or dtype

    def normal(std):
        return (torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=device) * std
                ).to(dtype)

    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "embed":
        return normal(p.scale if p.scale is not None else 1.0)
    if p.init == "normal":
        return normal(p.scale if p.scale is not None else 0.02)
    if p.init == "fan_in":
        scale = p.scale if p.scale is not None else 1.0
        return normal(scale / math.sqrt(max(_fan_in(p), 1)))
    if p.init == "s4d":
        # S4D-real A_log: log(1..n) broadcast over inner (and layers).
        row = torch.log(torch.arange(1, p.shape[-1] + 1, dtype=torch.float32,
                                     device=device))
        return row.to(dtype).expand(p.shape).contiguous()
    if p.init == "s4d_dt":
        # Mamba's dt bias: the inverse softplus of a log-uniform dt in
        # [1e-3, 1e-1].
        u = torch.rand(p.shape, generator=generator, dtype=torch.float32,
                       device=device)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo)
        return torch.log(torch.expm1(dt)).to(dtype)
    raise ValueError(f"unknown init {p.init!r}")


def init_params(template, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=DEFAULT_DEVICE):
    """Materialise a template on ``device`` (CUDA unless the CPU is asked
    for by name), drawing the random leaves from ``generator`` in
    sorted-key order (the generator must live on ``device``)."""
    device = resolve_device(device)
    return tree_map(lambda p: _initializer(p, generator, dtype, device),
                    template)


def count_params(template) -> int:
    return sum(p.size for p in tree_leaves(template))


def stack_template(template, n: int):
    """Add a leading LAYERS dim of extent n to every leaf."""
    return tree_map(
        lambda p: P((n,) + tuple(p.shape), (LAYERS,) + tuple(p.axes),
                    p.init, p.scale, p.dtype), template)



def abstract_params(template, dtype: torch.dtype = torch.float32):
    """Meta tensors of every leaf's global shape: the dry-run's stand-in,
    no allocation."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype or dtype,
                                          device="meta"), template)


def pspec_tree(template, rules: dict):
    """Logical axes -> a placement per leaf (``spec_dims`` lists: a mesh
    axis, a tuple of them, or None per dim). Dims whose size does not
    divide the mapped extent stay unsharded."""
    from ..sharding.spec import spec_dims
    return tree_map(lambda p: spec_dims(p.shape, p.axes, rules), template)


def local_template(template, rules: dict):
    """The template of one rank's slices under ``rules`` (every dim cut by
    its placement's extent), for allocating caches and parameters
    locally."""
    from ..sharding.spec import local_shape, spec_dims
    sizes = rules.get("_mesh_sizes", {})

    def loc(p: P):
        shape = local_shape(p.shape, spec_dims(p.shape, p.axes, rules),
                            sizes)
        return dataclasses.replace(p, shape=shape)
    return tree_map(loc, template)


def _slice_leaf(t: torch.Tensor, dims, mesh) -> torch.Tensor:
    from ..sharding.spec import axes_of
    for d, entry in enumerate(dims):
        axes = axes_of(entry)
        if axes:
            n = t.shape[d] // mesh.extent(axes)
            t = t.narrow(d, mesh.coord(axes) * n, n)
    return t


def shard_by(tree, placements, mesh):
    """This rank's slice of every leaf of a full tree (tensors on any
    device) under a placement tree: contiguous copies on
    ``mesh.device``."""
    return tree_map(lambda t, s: _slice_leaf(t, s, mesh).to(
        mesh.device).contiguous().clone(), tree, placements)


def shard_tree(tree, template, rules: dict, mesh):
    """``shard_by`` with the placements of ``template`` under ``rules``
    (the carry-over of a full tree: ``convert.params_from_numpy`` then
    ``shard_tree``)."""
    return shard_by(tree, pspec_tree(template, rules), mesh)


def gather_tree(tree, template, rules: dict, mesh):
    """The full leaves from every rank's slices (``shard_tree``'s inverse;
    a collective: every rank calls it and gets the whole tree)."""
    from ..sharding import ctx
    from ..sharding.spec import axes_of

    def gather(t, dims):
        for d, entry in enumerate(dims):
            # Ranks of an axis hold consecutive blocks within the block of
            # the axes before it: gather the innermost axis first.
            for a in reversed(axes_of(entry)):
                t = ctx.gather_dim(t, a, d, mesh)
        return t.contiguous()
    return tree_map(gather, tree, pspec_tree(template, rules))


def init_sharded(template, rules: dict, mesh, seed: int,
                 dtype: torch.dtype = torch.float32):
    """Materialise only this rank's slices on ``mesh.device``, each leaf
    drawn from a generator seeded by (``seed``, the leaf's index, the
    slice's index): ranks that hold the same slice hold the same values,
    so replicated leaves agree and the ranks together hold one model. The
    initializer's scale is the full leaf's (fan-in over the global
    shape). For models no card can hold whole; the values differ from
    ``init_params``'s."""
    from ..sharding.spec import axes_of, local_shape, spec_dims
    sizes = rules.get("_mesh_sizes", {})
    out = []
    for i, p in enumerate(tree_leaves(template)):
        dims = spec_dims(p.shape, p.axes, rules)
        shard = 0
        for entry in dims:
            axes = axes_of(entry)
            if axes:
                shard = shard * mesh.extent(axes) + mesh.coord(axes)
        gen = torch.Generator(device=mesh.device).manual_seed(
            (seed * 1_000_003 + i) * 4099 + shard)
        q = dataclasses.replace(p, shape=local_shape(p.shape, dims, sizes))
        if p.init == "fan_in":
            scale = p.scale if p.scale is not None else 1.0
            q = dataclasses.replace(q, init="normal",
                                    scale=scale / math.sqrt(
                                        max(_fan_in(p), 1)))
        out.append(_initializer(q, gen, dtype, mesh.device))
    out.reverse()
    return tree_map(lambda p: out.pop(), template)
