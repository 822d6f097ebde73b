"""Mixture-of-experts FFN with GShard-style capacity, on one card.

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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def moe_apply(params, x, cfg, *, capacity_factor: float | None = None):
    """x: [b, s, d] -> ([b, s, d], aux loss). ``capacity_factor`` defaults
    to the config's; decode passes ``n_experts / top_k`` (dropless)."""
    b0, s0, d = x.shape
    if s0 > MOE_GROUP and s0 % MOE_GROUP == 0:
        x = x.reshape(b0 * s0 // MOE_GROUP, MOE_GROUP, d)
    b, s, _ = x.shape
    e = params["router"].shape[1]
    k = cfg.top_k
    cap_f = capacity_factor or cfg.capacity_factor
    capacity = min(max(int(cap_f * s * k / e), 1), s * k)
    expert, slot, kept, gate, aux = _routing(params, x, cfg, capacity)

    # Dispatch: slot c of expert e's buffer for sequence b holds the token
    # that took it; a dropped choice writes to a spare slot past the last.
    rows = torch.arange(b, device=x.device)[:, None, None]
    dest = ((expert * b + rows) * (capacity + 1)
            + torch.where(kept, slot, torch.full_like(slot, capacity)))
    src = x[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
    buf = x.new_zeros((e * b * (capacity + 1), d))
    buf.index_copy_(0, dest.reshape(-1), src)
    xin = buf.view(e, b, capacity + 1, d)[:, :, :capacity]
    yout = _experts(params, xin, x.dtype)                    # [e, b, c, d]

    # Combine: each token's kept choices, weighted by their gates (cast to
    # x's dtype first, as the reference casts its combine tensor).
    picked = yout[expert, rows, torch.where(kept, slot,
                                            torch.zeros_like(slot))]
    y = torch.sum(gate.to(x.dtype)[..., None] * picked, dim=2)
    if "shared" in params:
        y = y + swiglu(params["shared"], x)
    if s != s0:
        y = y.reshape(b0, s0, d)
    return y, aux


def _moe_apply_a2a(*args, **kwargs):
    """Expert parallelism over a mesh (the JAX package's shard_map path
    with all-to-alls): the port runs on one card."""
    raise NotImplementedError("expert-parallel MoE over a mesh is not "
                              "ported yet: ROADMAP queue 1 entry 5 "
                              "(sharding/)")
