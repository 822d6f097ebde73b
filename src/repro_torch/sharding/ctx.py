"""The rules a model runs under, and the collectives its code issues (the
JAX package's ``sharding/ctx.py``).

The JAX package threads the rules to the model through a context
variable, and GSPMD turns its ``constrain`` hints into collectives. The
port's SPMD is explicit: each rank holds the local slice of every tensor,
``constrain`` only checks a local shape against the rules, and the model
code calls the collectives below where GSPMD would resolve the layout.
Outside ``activation_rules`` (or under rules of a shape-only mesh) the
model runs unsharded and none of them is reached.

Each collective is a ``torch.autograd.Function`` whose backward is its
conjugate:

  psum        all-reduce SUM of a partial sum (row-parallel products, the
              vocab-sharded lookup and loss). Backward: identity, since
              every rank of the axis holds the whole loss. Not
              ``torch.distributed.nn.functional.all_reduce``, whose
              backward all-reduces the gradient again.
  enter       identity; backward all-reduce SUM: the entry of a
              replicated activation into column-parallel products, each
              rank's gradient a partial sum.
  pmean       all-reduce mean, backward the same: a value averaged over
              the data axes inside a loss that the train step averages
              over them too (the MoE's aux loss).
  all_gather / reduce_scatter
              a pair: the gather of a sharded input (FSDP weights, the
              router) has a reduce-scatter backward; ``partial_grad=False``
              gathers a sharded result that replicated code consumes, and
              its backward keeps this rank's slice.
  all_to_all  the expert-parallel exchange, and the decode's exchange of
              a split cache's partials; backward the inverse one.
  all_to_all_v
              an exchange of uneven parts (Mamba's in_proj block onto
              the rank's own channels); backward the reverse exchange.

``pmax`` and ``all_reduce`` (no autograd) serve the loss's max and the
train step's reductions. Every call counts, per kind, one call and the
bytes of its result (``counts``), also over a group of one rank: nothing
is skipped at world 1.

The sequence-parallel residual (``{"act_seq": AXIS}``, Korthikanti et
al.'s sequence parallelism; the JAX package constrains the stream to
``("batch", "act_seq", None)`` after every full-sequence block and GSPMD
places the collectives). Inside ``sequence_parallel(s)`` on a mesh where
the rule resolves (``seq_axis``), the residual stream [b, s / n, d]
between sublayers holds this rank's block of the sequence, so its norms
and adds run on its tokens. The model code marks each sublayer's entry
and exit of the stream, and the choice of collective is made here:

  enter_stream  the normed stream into a sublayer: ``enter`` off the
                path; on it the sequence's all-gather, whose backward
                reduce-scatters the gradient where the sublayer's
                products split over the stream's axis (Megatron's
                replacement of ``enter``'s all-reduce) and keeps the
                rank's block where the sublayer runs whole on every rank.
  exit_stream   the sublayer's output back onto the stream: ``psum`` off
                the path; on it a reduce-scatter over the sequence, or
                the rank's block of an output that is whole on every rank
                (backward: the gradient's all-gather).
  exit_columns  an output held as the rank's block of the model width
                (the MoE's all-to-all path): its all-gather off the path,
                an all-to-all onto the rank's tokens on it.
  stream_param  a parameter read on the rank's tokens (a norm's scale, a
                bias added after the exit): its gradient summed over the
                axis on the path.

``stream_split`` and ``stream_gather`` take a whole sequence onto the
stream and back (the encoder's input and output). Off the path, at an
extent of 1 as the JAX package's placement resolves it, every one of
them is today's collective or the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist

from .spec import axes_of, local_shape, mesh_dims

_RULES = contextvars.ContextVar("activation_rules", default=None)

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
counts = {k: {"calls": 0, "bytes": 0} for k in KINDS}


def reset_counts() -> None:
    for k in KINDS:
        counts[k] = {"calls": 0, "bytes": 0}


def count(kind: str, t: torch.Tensor) -> None:
    """Count one call of ``kind`` and the bytes of its result ``t``."""
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += t.numel() * t.element_size()


@contextlib.contextmanager
def activation_rules(rules: dict):
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def current() -> dict | None:
    return _RULES.get()


def mesh():
    """The mesh of the current rules, or None (no rules, or a shape-only
    mesh)."""
    rules = _RULES.get()
    return None if rules is None else rules.get("_mesh")


def axis_for(logical: str, size: int):
    """The mesh axis (or tuple) a dim of ``size`` along logical axis
    ``logical`` is split over under the current rules, extents of 1
    included (``spec.mesh_dims``); None when unsharded or outside a
    mesh."""
    if mesh() is None:
        return None
    return mesh_dims((size,), (logical,), _RULES.get())[0]


def split_of(axis):
    """(mesh axis, extent, this rank's index along it) of a split over
    ``axis`` of the current mesh, or None where ``axis`` is None or no
    mesh is current."""
    m = mesh()
    if m is None or axis is None:
        return None
    return axis, m.extent(axis), m.coord(axis)


def split(logical: str, n_local: int, n_global: int | None = None):
    """(mesh axis, this rank's first global index) of a dim of
    ``n_local`` local entries along ``logical``, or (None, 0) when it is
    not split. The global size comes from ``n_global`` or, when the rules'
    axis has extent 1, from the local one; over a larger extent a local
    size alone cannot tell a split dim from an unsplit one, so it must be
    given."""
    m = mesh()
    if m is None:
        return None, 0
    if n_global is None:
        rule = _RULES.get().get(logical)
        if rule is not None and m.extent(rule) > 1:
            raise ValueError(f"the global size of {logical!r} is needed "
                             f"over a mesh axis of extent {m.extent(rule)}")
        n_global = n_local
    axis = axis_for(logical, n_global)
    if axis is None:
        if n_local != n_global:
            raise ValueError(f"{logical!r}: {n_local} local entries, "
                             f"{n_global} global, and no split")
        return None, 0
    if n_global // m.extent(axis) != n_local:
        raise ValueError(f"{logical!r}: {n_local} local entries are not a "
                         f"slice of {n_global} over {axis!r}")
    return axis, m.coord(axis) * n_local


def constrain(x: torch.Tensor, axes, shape=None) -> torch.Tensor:
    """Check that ``x`` is this rank's slice of a tensor of global
    ``shape`` (None entries unchecked) laid out along logical ``axes``;
    return ``x``. No data moves. A no-op outside a mesh or without a
    shape."""
    rules = _RULES.get()
    if rules is None or rules.get("_mesh") is None or shape is None:
        return x
    full = [1 if n is None else n for n in shape]
    want = local_shape(full, mesh_dims(full, axes, rules),
                       rules["_mesh_sizes"])
    for i, (got, n, w) in enumerate(zip(x.shape, shape, want)):
        if n is not None and got != w:
            raise ValueError(f"constrain: dim {i} of {tuple(x.shape)} is "
                             f"{got}, the rules give {w} of {n} along "
                             f"{axes[i]!r}")
    return x


def _groups(m, axes):
    return [m.group(a) for a in axes_of(axes)]


def all_reduce(x: torch.Tensor, axes, op=dist.ReduceOp.SUM,
               m=None) -> torch.Tensor:
    """All-reduce ``x`` in place over each mesh axis of ``axes`` in turn
    (no autograd); returns it."""
    m = m or mesh()
    for g in _groups(m, axes):
        dist.all_reduce(x, op=op, group=g)
        count("all_reduce", x)
    return x


def _own(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy for an in-place collective."""
    return x.clone(memory_format=torch.contiguous_format)


def pmax(x: torch.Tensor, axes, m=None) -> torch.Tensor:
    """The max over ``axes`` of a tensor that needs no gradient."""
    return all_reduce(_own(x.detach()), axes, dist.ReduceOp.MAX, m)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, m):
        return all_reduce(_own(x), axes, m=m)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, m):
        ctx.axes, ctx.m = axes, m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_own(g), ctx.axes, m=ctx.m), None, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, m):
        ctx.axes, ctx.m = axes, m
        return all_reduce(_own(x), axes, m=m) / m.extent(axes)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(_own(g), ctx.axes, m=ctx.m)
                / ctx.m.extent(ctx.axes), None, None)


def psum(x, axes):
    """All-reduce SUM over ``axes``; identity backward."""
    return _Psum.apply(x, axes, mesh())


def enter(x, axes):
    """Identity; all-reduce SUM of the gradient over ``axes``."""
    return _Enter.apply(x, axes, mesh())


def pmean(x, axes):
    """All-reduce mean over ``axes``, forward and backward."""
    return _Pmean.apply(x, axes, mesh())


def gather_dim(x: torch.Tensor, axis: str, dim: int, m) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over mesh axis ``axis`` of mesh
    ``m`` (no autograd)."""
    n = m.shape[axis]
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=m.group(axis))
    count("all_gather", out)
    return out.movedim(0, dim)


def scatter_dim(x: torch.Tensor, axis: str, dim: int, m) -> torch.Tensor:
    """Reduce-scatter (SUM) ``x`` along ``dim`` over mesh axis ``axis``
    (no autograd)."""
    n = m.shape[axis]
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=m.group(axis))
    count("reduce_scatter", out)
    return out.movedim(0, dim)


def slice_dim(x: torch.Tensor, axis: str, dim: int, m) -> torch.Tensor:
    """This rank's slice of ``dim`` along mesh axis ``axis``."""
    n = x.shape[dim] // m.shape[axis]
    return x.narrow(dim, m.coord(axis) * n, n).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, partial_grad, m):
        ctx.axis, ctx.dim, ctx.partial, ctx.m = axis, dim, partial_grad, m
        return gather_dim(x, axis, dim, m).contiguous()

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = scatter_dim(g, ctx.axis, ctx.dim, ctx.m)
        else:
            g = slice_dim(g, ctx.axis, ctx.dim, ctx.m)
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, m):
        ctx.axis, ctx.dim, ctx.m = axis, dim, m
        return scatter_dim(x, axis, dim, m).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (gather_dim(g, ctx.axis, ctx.dim, ctx.m).contiguous(), None,
                None, None)


def all_gather(x, axis: str, dim: int, *, partial_grad: bool = True):
    """Concatenate the ranks' ``x`` along ``dim`` over mesh axis
    ``axis`` (rank order). Backward: reduce-scatter when each rank's
    gradient is a partial sum (``partial_grad``), else this rank's slice
    of the gradient."""
    return _AllGather.apply(x, axis, dim, partial_grad, mesh())


def reduce_scatter(x, axis: str, dim: int):
    """Sum over mesh axis ``axis`` and keep this rank's slice of ``dim``;
    backward all-gather."""
    return _ReduceScatter.apply(x, axis, dim, mesh())


def _a2a(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
         m) -> torch.Tensor:
    n = m.shape[axis]
    xs = x.movedim(split_dim, 0)
    xs = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:])).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=m.group(axis))
    count("all_to_all", out)
    # out[i] is rank i's chunk; put the rank index before concat_dim and
    # merge the two (rank-major, as a tiled JAX all_to_all concatenates).
    out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(out.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                        * shape[concat_dim + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim, m):
        ctx.args = (axis, split_dim, concat_dim, m)
        return _a2a(x, axis, split_dim, concat_dim, m)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim, m = ctx.args
        return _a2a(g, axis, concat_dim, split_dim, m), None, None, None, \
            None


def all_to_all(x, axis: str, split_dim: int, concat_dim: int):
    """Split ``split_dim`` into one chunk per rank of ``axis``, send chunk
    i to rank i, and concatenate what arrives along ``concat_dim`` in rank
    order (``jax.lax.all_to_all(..., tiled=True)``)."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim, mesh())


def _a2a_v(x: torch.Tensor, axis: str, dim: int, send: list, recv: list,
           m) -> torch.Tensor:
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((sum(recv),) + tuple(xs.shape[1:]))
    dist.all_to_all_single(out, xs, output_split_sizes=list(recv),
                           input_split_sizes=list(send),
                           group=m.group(axis))
    count("all_to_all", out)
    return out.movedim(0, dim)


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, send, recv, m):
        ctx.args = (axis, dim, send, recv, m)
        return _a2a_v(x, axis, dim, send, recv, m)

    @staticmethod
    def backward(ctx, g):
        axis, dim, send, recv, m = ctx.args
        return _a2a_v(g, axis, dim, recv, send, m), None, None, None, None, \
            None


def all_to_all_v(x, axis: str, dim: int, send, recv):
    """Send the first ``send[0]`` entries of ``dim`` to rank 0 of mesh
    axis ``axis``, the next ``send[1]`` to rank 1, and so on; concatenate
    what arrives along ``dim`` in rank order (``recv[i]`` entries from
    rank i). Backward: the reverse exchange."""
    return _AllToAllV.apply(x, axis, dim, tuple(send), tuple(recv), mesh())


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, m):
        ctx.axis, ctx.dim, ctx.m = axis, dim, m
        return slice_dim(x, axis, dim, m)

    @staticmethod
    def backward(ctx, g):
        return (gather_dim(g, ctx.axis, ctx.dim, ctx.m).contiguous(), None,
                None, None)


# The rules' key of the stream's mesh axis inside ``sequence_parallel``
# (kept in the rules so that ``_remat``'s recompute, which re-enters
# them, takes the same path).
_SEQ = "_act_seq"


def seq_axis(s: int):
    """The mesh axis the residual stream of a sequence of ``s`` tokens is
    split over under the current rules: the ``act_seq`` rule's, or None
    where the JAX package's placement of ``("batch", "act_seq", None)``
    resolves it to replication (no mesh, no rule, an extent of 1, ``s``
    not a multiple of the extent, or an axis the batch takes first)."""
    m = mesh()
    rule = None if m is None else _RULES.get().get("act_seq")
    if rule is None:
        return None
    sizes = _RULES.get()["_mesh_sizes"]
    axes = axes_of(rule)
    extent = math.prod(sizes.get(a, 1) for a in axes)
    batch = [a for a in axes_of(_RULES.get().get("batch"))
             if sizes.get(a, 1) > 1]
    if extent <= 1 or s % extent or any(a in batch for a in axes):
        return None
    if len(axes) != 1:
        raise NotImplementedError(
            f"act_seq over {rule!r}: the sequence-parallel residual splits "
            "over one mesh axis")
    return axes[0]


@contextlib.contextmanager
def sequence_parallel(s: int):
    """The full-sequence path of ``s`` tokens (training, prefill, the
    encoder): inside it the stream is split as ``seq_axis(s)`` says.
    Yields that axis, or None."""
    axis = seq_axis(s)
    if axis is None:
        yield None
        return
    with activation_rules({**_RULES.get(), _SEQ: axis}):
        yield axis


def stream_axis():
    """The mesh axis the residual stream is split over here, or None."""
    rules = _RULES.get()
    return None if rules is None else rules.get(_SEQ)


def stream_extent() -> int:
    """The number of blocks of the stream's sequence (1 off the path)."""
    axis = stream_axis()
    return 1 if axis is None else mesh().extent(axis)


def enter_stream(x: torch.Tensor, axis) -> torch.Tensor:
    """The normed stream ``x`` [b, s_loc, d] into a sublayer whose
    products are split over ``axis`` (None: whole on every rank); returns
    the sublayer's input over the whole sequence (module docstring)."""
    sp = stream_axis()
    if sp is None:
        return enter(x, axis) if axis else x
    rest = tuple(a for a in axes_of(axis) if a != sp)
    x = all_gather(x, sp, 1, partial_grad=len(rest) < len(axes_of(axis)))
    return enter(x, rest) if rest else x


def exit_stream(y: torch.Tensor, axis) -> torch.Tensor:
    """A sublayer's output ``y`` [b, s, d], a partial sum over ``axis``
    (None: whole on every rank), back onto the stream."""
    sp = stream_axis()
    if sp is None:
        return psum(y, axis) if axis else y
    rest = tuple(a for a in axes_of(axis) if a != sp)
    if rest:
        y = psum(y, rest)
    if sp in axes_of(axis):
        return reduce_scatter(y, sp, 1)
    return stream_split(y)


def exit_columns(y: torch.Tensor, axis) -> torch.Tensor:
    """A sublayer's output held as this rank's block of columns
    ``y`` [b, s, d / n] over ``axis`` (None: all of them), whole, back
    onto the stream: the columns' all-gather, or on the path over the
    same axis one all-to-all from the columns onto the rank's tokens."""
    if axis is None:
        return stream_split(y)
    if stream_axis() == axis:
        return all_to_all(y, axis, 1, 2)
    return stream_split(all_gather(y, axis, dim=2, partial_grad=False))


def stream_param(p: torch.Tensor) -> torch.Tensor:
    """A parameter read on the stream's own tokens: identity; on the
    path its gradient, a partial sum over the ranks' tokens, is summed
    over the stream's axis."""
    sp = stream_axis()
    return p if sp is None else enter(p, sp)


def stream_split(x: torch.Tensor) -> torch.Tensor:
    """A sequence [b, s, d] whole on every rank onto the stream: the
    rank's block (backward: the gradient's all-gather)."""
    sp = stream_axis()
    return x if sp is None else _Slice.apply(x, sp, 1, mesh())


def stream_gather(x: torch.Tensor) -> torch.Tensor:
    """The stream whole on every rank, for consumers that run whole
    (backward: the rank's block of the gradient)."""
    sp = stream_axis()
    return x if sp is None else all_gather(x, sp, 1, partial_grad=False)
