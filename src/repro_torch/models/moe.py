"""Mixture-of-experts FFN with GShard-style capacity.

The JAX package's ``models/moe.py``: a router picks each token's top-k
experts, each expert takes at most ``capacity`` tokens per sequence (per
group of ``MOE_GROUP`` tokens for long sequences) in token order, and a
token past an expert's capacity is dropped there (gate 0). The JAX
package dispatches and combines with one-hot [b, s, e, c] einsums; here
the same slots are filled and read by index (a one-hot product of f32
values moves each value exactly, so the expert inputs are the same).

Routing reproduces the reference's decisions bitwise on the same logits:
the top k come from a stable descending sort (``jax.lax.top_k`` puts the
lower index first on a tie; ``torch.topk`` promises no order), and an
expert's slot is the count of earlier choices of it over the flattened
[s * k] axis, token-major.

Under a mesh whose expert axis has extent > 1 (and is a data axis, as the
JAX package requires) ``moe_apply`` takes ``_moe_apply_a2a``, the JAX
package's ``shard_map`` path written with explicit collectives: a local
dispatch, an all-to-all onto the rank's experts, the experts over the
local expert-MLP columns, a reduce-scatter over ``model`` on d, the
all-to-all back, the combine, an all-gather over ``model`` and the aux
loss averaged over the data axes. Under experts on a non-data axis of
extent > 1 it takes ``_moe_apply_local_experts`` (the JAX package's
einsum path, which GSPMD partitions there): every rank of that axis holds
the same tokens, routes them with the gathered router and runs only its
own experts, and the partial combines are all-reduced over the axis.
Otherwise the experts are local and the expert-MLP columns' partial sums
are all-reduced over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding import ctx
from ..sharding.spec import mesh_dims
from .common import EMBED, EXPERT_MLP, EXPERTS, P
from .layers import einsum, swiglu, swiglu_template

# Group-limited routing: capacity and slots are per group of <= 2048
# tokens, not per sequence, when a sequence is a longer multiple of it.
MOE_GROUP = 2048


def moe_template(cfg, n_experts_padded: int | None = None):
    d = cfg.d_model
    e = n_experts_padded or cfg.n_experts
    eff = cfg.expert_d_ff
    t = {
        "router": P((d, e), (EMBED, EXPERTS), init="normal", scale=0.02),
        "wi_gate": P((e, d, eff), (EXPERTS, EMBED, EXPERT_MLP)),
        "wi_up": P((e, d, eff), (EXPERTS, EMBED, EXPERT_MLP)),
        "wo": P((e, eff, d), (EXPERTS, EXPERT_MLP, EMBED)),
    }
    if cfg.n_shared_experts:
        t["shared"] = swiglu_template(d, cfg.n_shared_experts * eff)
    return t


def _routing(params, x, cfg, capacity: int):
    """Routing of x [b, s, d]: (expert [b, s, k] int64, slot [b, s, k]
    int64, kept [b, s, k] bool, gate [b, s, k] f32 (0 where dropped),
    aux). The reference's dispatch[b, s, e, c] is 1 exactly where
    e = expert, c = slot and kept; its combine holds the gate there."""
    e = params["router"].shape[1]
    k = cfg.top_k
    logits = einsum("bsd,de->bse", x, params["router"]).float()
    if e > cfg.n_experts:                     # padded experts never win
        pad = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    gates_all = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.sort(gates_all, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    b, s = top_idx.shape[:2]
    oh = F.one_hot(top_idx.reshape(b, s * k), e)           # [b, s*k, e]
    slot = torch.gather(torch.cumsum(oh, dim=1) - oh, 2,
                        top_idx.reshape(b, s * k, 1)).reshape(b, s, k)
    kept = slot < capacity
    gate = torch.where(kept, top_vals, torch.zeros_like(top_vals))
    frac_tokens = torch.mean(oh.reshape(b, s, k, e)[:, :, 0].float(),
                             dim=(0, 1))
    mean_prob = torch.mean(gates_all, dim=(0, 1))
    aux = cfg.n_experts * torch.sum(frac_tokens * mean_prob)
    return top_idx, slot, kept, gate, aux


def _experts(params, xin, dtype):
    """Expert SwiGLUs on [e, ..., d] buffers (weights [e, d, f])."""
    e, d = xin.shape[0], xin.shape[-1]
    flat = xin.reshape(e, -1, d)
    g = einsum("end,edf->enf", flat, params["wi_gate"])
    u = einsum("end,edf->enf", flat, params["wi_up"])
    h = F.silu(g.float()).to(dtype) * u
    return einsum("enf,efd->end", h, params["wo"]).reshape(
        xin.shape[:-1] + (-1,))


def _dispatch(x, expert, slot, kept, capacity: int, e: int):
    """[b, s, d] -> the experts' buffers [e, b, capacity, d]: slot c of
    expert e's buffer for sequence b holds the token that took it; a
    dropped choice writes to a spare slot past the last."""
    b, s, d = x.shape
    k = expert.shape[-1]
    rows = torch.arange(b, device=x.device)[:, None, None]
    dest = ((expert * b + rows) * (capacity + 1)
            + torch.where(kept, slot, torch.full_like(slot, capacity)))
    src = x[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
    buf = x.new_zeros((e * b * (capacity + 1), d))
    buf.index_copy_(0, dest.reshape(-1), src)
    return buf.view(e, b, capacity + 1, d)[:, :, :capacity]


def _combine(yout, expert, slot, kept, gate, dtype):
    """Each token's kept choices of ``yout`` [e, b, c, d], weighted by
    their gates (cast to the stream's dtype first, as the reference casts
    its combine tensor)."""
    rows = torch.arange(expert.shape[0], device=yout.device)[:, None, None]
    picked = yout[expert, rows, torch.where(kept, slot,
                                            torch.zeros_like(slot))]
    return torch.sum(gate.to(dtype)[..., None] * picked, dim=2)


def _shared(params, x, cfg):
    return swiglu(params["shared"], x,
                  width=cfg.n_shared_experts * cfg.expert_d_ff)


def moe_apply(params, x, cfg, *, capacity_factor: float | None = None):
    """x: [b, s, d] -> ([b, s, d], aux loss). ``capacity_factor`` defaults
    to the config's; decode passes ``n_experts / top_k`` (dropless).
    Under a mesh the model must have been built with the mesh's
    expert-parallel degree (``build(cfg, ep_degree=...)``)."""
    b0, d = x.shape[0], x.shape[2]
    # The whole sequence: on the sequence-parallel path x is the stream's
    # block of it, and each path gathers it on entry (``group``).
    s0 = x.shape[1] * ctx.stream_extent()
    b, s = b0, s0
    if s0 > MOE_GROUP and s0 % MOE_GROUP == 0:
        b, s = b0 * s0 // MOE_GROUP, MOE_GROUP

    def group(t):
        return t.reshape(b, s, d)

    def ungroup(y):
        return y.reshape(b0, s0, y.shape[-1])

    ep_axis, ff_axis, e = None, None, params["router"].shape[1]
    m = ctx.mesh()
    if m is not None:
        rule = ctx.current().get(EXPERTS)
        e = cfg.padded_experts(m.extent(rule) if rule else 1)
        # The experts' leaves' own placement: where the experts and the
        # expert-MLP columns share a mesh axis, the experts take it.
        axes, shape = (EXPERTS, EMBED, EXPERT_MLP), (e, d, cfg.expert_d_ff)
        ctx.constrain(params["wi_gate"], axes, shape)
        ep_axis, _, ff_axis = mesh_dims(shape, axes, ctx.current())
    k = cfg.top_k
    cap_f = capacity_factor or cfg.capacity_factor
    capacity = min(max(int(cap_f * s * k / e), 1), s * k)

    dp_axes = ctx.current().get("batch") if m is not None else None
    dp_axes = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes or ())
    if ep_axis is not None and m.extent(ep_axis) > 1:
        if ep_axis not in dp_axes:
            y, aux = _moe_apply_local_experts(
                params, x, cfg, capacity, ep_axis, ff_axis, dp_axes, group,
                ungroup)
        else:
            y, aux = _moe_apply_a2a(params, x, cfg, capacity, ep_axis,
                                    ff_axis, dp_axes, group, ungroup)
    else:
        # The router reads the whole sequence and its gates enter the
        # expert-MLP split below, so its input's gradient is whole on
        # every rank; the experts' input is the split products' own.
        xr = group(ctx.enter_stream(x, None))
        expert, slot, kept, gate, aux = _routing(params, xr, cfg, capacity)
        xe = xr if ff_axis is None else group(ctx.enter_stream(x, ff_axis))
        yout = _experts(params, _dispatch(xe, expert, slot, kept, capacity,
                                          e), x.dtype)       # [e, b, c, d]
        if ff_axis is not None:
            # Each rank's outputs are partial sums over its expert-MLP
            # columns, so the gates' gradients are too.
            gate = ctx.enter(gate, ff_axis)
        y = _combine(yout, expert, slot, kept, gate, x.dtype)
        y = ctx.exit_stream(ungroup(y), ff_axis)
        if dp_axes:
            aux = ctx.pmean(aux, dp_axes)
    if "shared" in params:
        y = y + _shared(params, x, cfg)
    return y, aux


def _moe_apply_a2a(params, x, cfg, capacity: int, ep_axis: str, ff_axis,
                   dp_axes: tuple, group, ungroup):
    """Expert parallelism with explicit all-to-alls (the JAX package's
    ``shard_map`` path): x is this rank's batch rows [b_loc, s, d] (of
    the stream: gathered whole, ``group`` taking it to the routing's
    groups); the router is gathered whole (its gradient reduce-scattered
    back), the routing is per sequence and so the same decisions as on
    one card. Returns the output before the shared expert, and aux."""
    x = group(ctx.enter_stream(x, None))
    dtype = x.dtype
    router = ctx.all_gather(params["router"], ep_axis, dim=1)
    e = router.shape[1]
    expert, slot, kept, gate, aux = _routing({"router": router}, x, cfg,
                                             capacity)
    xin = _dispatch(x, expert, slot, kept, capacity, e)  # [E, b_loc, c, d]
    # [E, b_loc, c, d] -> [E/ep, b_loc*ep, c, d]: the EP all-to-all.
    xin = ctx.all_to_all(xin, ep_axis, 0, 1)
    if ff_axis is not None:
        xin = ctx.enter(xin, ff_axis)
    yo = _experts(params, xin, dtype)
    if ff_axis is not None:
        # The partial sums over the expert-MLP columns, reduce-scattered
        # on d: the return all-to-all and the combine run on d/TP.
        yo = ctx.reduce_scatter(yo, ff_axis, dim=3)
    yo = ctx.all_to_all(yo, ep_axis, 1, 0)          # [E, b_loc, c, d/TP]
    if ff_axis is not None:
        # The combine reads this rank's d/TP columns: the gates' gradients
        # are partial sums over them.
        gate = ctx.enter(gate, ff_axis)
    y = _combine(yo, expert, slot, kept, gate, dtype)
    y = ctx.exit_columns(ungroup(y), ff_axis)
    return y, ctx.pmean(aux, dp_axes)


def _moe_apply_local_experts(params, x, cfg, capacity: int, ep_axis: str,
                             ff_axis, dp_axes: tuple, group, ungroup):
    """Experts over ``ep_axis``, not a data axis (the JAX package's einsum
    path): each rank of the axis holds the same batch rows x [b, s, d],
    routes them with the router gathered whole (the same decisions as on
    one card), dispatches to its own experts only, and combines their
    outputs; the other experts' choices weigh 0 here, and the all-reduce
    over the axis sums the ranks' combines. No all-to-all. Returns the
    output before the shared expert, and aux."""
    dtype = x.dtype
    m = ctx.mesh()
    n = m.extent(ep_axis)
    xe = group(ctx.enter_stream(x, ep_axis))
    router = ctx.all_gather(params["router"], ep_axis, dim=1)
    expert, slot, kept, gate, aux = _routing({"router": router}, xe, cfg,
                                             capacity)
    e_loc = params["wi_gate"].shape[0]
    lo = m.coord(ep_axis) * e_loc
    local = (expert >= lo) & (expert < lo + e_loc)
    mine = torch.where(local, expert - lo, torch.zeros_like(expert))
    kept = kept & local
    gate = torch.where(local, gate, torch.zeros_like(gate))
    axes = (ep_axis,)
    if ff_axis is not None:
        xe = ctx.enter(xe, ff_axis)
        gate = ctx.enter(gate, ff_axis)
        axes = (ep_axis, ff_axis)
    yout = _experts(params, _dispatch(xe, mine, slot, kept, capacity,
                                      e_loc), dtype)   # [e_loc, b, c, d]
    y = ctx.exit_stream(ungroup(_combine(yout, mine, slot, kept, gate,
                                         dtype)), axes)
    # Every rank of the axis computes the same aux loss from the whole
    # router, and the router's and x's gradients are summed over the axis:
    # count its gradient once (the forward value is unchanged).
    aux = aux.detach() + (aux - aux.detach()) / n
    if dp_axes:
        aux = ctx.pmean(aux, dp_axes)
    return y, aux
