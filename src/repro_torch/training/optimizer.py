"""AdamW with a configurable state dtype, on nested-dict trees of tensors
(the JAX package's ``training/optimizer.py``; no ``torch.optim``).

``torch.optim.AdamW`` is not used: it has no clip by the global norm and
applies the weight decay as ``p * (1 - lr * wd)`` before the Adam step,
where this one adds ``wd * p`` to the Adam step and clips first, as the
JAX package does. The update math runs in f32 whatever the parameters'
and the state's dtypes; the first and second moments are stored in
``state_dtype`` (bf16 for very large models) and every result is cast back
to its leaf's dtype. ``update`` returns new trees unless it is asked to
write in place (``donate=True``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.common import tree_leaves, tree_map
from ..models.registry import DTYPES


# Elements updated at a time by ``update(..., donate=True)``.
DONATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"        # bfloat16 for very large models
    warmup_steps: int = 100
    schedule: str = "cosine"            # cosine | constant
    total_steps: int = 10000


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), f32: a linear warmup
    over ``warmup_steps``, then constant or a cosine decay to 0.1 x lr at
    ``total_steps``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, step) * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(params, cfg: AdamWConfig) -> dict:
    """{"m", "v": zeros like ``params`` in ``state_dtype``, "step": a 0-d
    int32 on the parameters' device}."""
    dt = DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, placements=None, mesh=None) -> torch.Tensor:
    """The f32 L2 norm over every leaf of ``tree``.

    Over a mesh, ``tree`` holds this rank's slices and ``placements`` a
    tree of their placements (``spec`` lists, mesh axes of extent 1
    included): each leaf's squared norm is summed over the mesh axes that
    leaf is sharded on, and only those, so a replicated leaf counts once.
    The leaves are then summed in order, as on one card."""
    from ..sharding import ctx
    from ..sharding.spec import axes_of
    specs = [None] * len(tree_leaves(tree)) if placements is None else \
        tree_leaves(placements)
    total = None
    for x, dims in zip(tree_leaves(tree), specs):
        sq = torch.sum(torch.square(x.float()))
        axes = [a for entry in (dims or ()) for a in axes_of(entry)]
        if axes:
            sq = ctx.all_reduce(sq, axes, m=mesh)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def update(params, grads, state, cfg: AdamWConfig, *, donate: bool = False,
           placements=None, mesh=None):
    """One AdamW step. Returns (params, state, metrics) with metrics
    {"grad_norm", "lr"} (0-d f32 tensors). Over a mesh every tree holds
    this rank's slices, and ``placements`` and ``mesh`` reach the clip's
    ``global_norm``.

    ``donate=True`` writes the new parameters, ``m`` and ``v`` into the
    given tensors leaf by leaf and returns those trees, as the JAX
    launcher donates its buffers to the jitted step: a full-width model's
    f32 moments would not fit twice on the card. Otherwise new trees are
    returned and the inputs are left as they were."""
    step = state["step"] + 1
    gnorm = global_norm(grads, placements, mesh)
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    else:
        scale = 1.0
    t = step.float()
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, t), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, t), t)
    lr = lr_at(cfg, step)

    @torch.no_grad()
    def adamw(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            step_ = step_ + cfg.weight_decay * p.float()
        return p.float() - lr * step_, m32, v32

    def upd(p, g, m, v):
        if not donate:
            new_p, m32, v32 = adamw(p, g, m, v)
            return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)
        # In place, a slice of DONATE_CHUNK elements at a time: the same
        # elementwise math (so the same bits), with its f32 temporaries
        # bounded by the slice, not the leaf (a stacked FFN weight of a
        # full-width model is 3.2 GB in f32, and the math holds several).
        flat = [p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)]
        for i in range(0, p.numel(), DONATE_CHUNK):
            part = [t[i:i + DONATE_CHUNK] for t in flat]
            for dst, new in zip((part[0], part[2], part[3]), adamw(*part)):
                dst.copy_(new)
        return p, m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t3: t3[i], out)  # noqa: E731
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, metrics
