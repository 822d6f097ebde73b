"""Cell planning: (arch x input shape x mesh) -> a step over the rank's
slices and its placements (the JAX package's ``launch/specs.py``).

``plan_cell`` builds the model with the mesh's expert-parallel degree,
the sharding rules, the abstract inputs (meta tensors of the global
shapes: no allocation) and the step function with its in and out
placements (``spec_dims`` lists, equal to the JAX package's
``PartitionSpec``s). There is no ``lower``/``compile``: the step runs
eagerly on each rank's slices (``CellPlan.shard`` cuts them from full
trees), issuing the collectives of ``sharding.ctx``. A plan is accounted
(FLOPs, bytes, memory, collectives per device) by running one rank's
step on fake tensors over a fake group: ``launch.dryrun``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from ..configs.base import InputShape, ModelConfig
from ..models import build
from ..models.common import (abstract_params, init_params, local_template,
                             pspec_tree, shard_by)
from ..models.registry import DTYPES
from ..sharding import ctx as shard_ctx
from ..sharding import rules as rules_mod
from ..sharding.spec import axes_of, spec_dims
from ..training import optimizer as opt_mod
from ..training.train_step import MeshStep, make_train_step

# The hoist rule's budget: gather the FSDP weights once per step when
# their gathered (TP-only) layout fits this much per device.
HOIST_GIB = 6.0


def default_microbatches(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    """Per-device activation budget heuristic: keep the live per-microbatch
    token count per device near a target so layer activations + remat
    stash fit alongside params/optimizer."""
    if shape.kind != "train":
        return 1
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    tokens_per_chip = shape.global_batch * shape.seq_len // dp
    target = 8192 if cfg.d_model <= 4096 else \
        4096 if cfg.d_model <= 7168 else 2048
    n = max(1, tokens_per_chip // target)
    # Must divide the per-shard batch.
    per_shard = max(shape.global_batch // dp, 1)
    while per_shard % n:
        n -= 1
    return max(n, 1)


def opt_config(cfg: ModelConfig) -> opt_mod.AdamWConfig:
    big = cfg.name in ("dbrx-132b", "jamba-1.5-large-398b")
    return opt_mod.AdamWConfig(
        state_dtype="bfloat16" if big else "float32")


@dataclasses.dataclass
class CellPlan:
    cfg: ModelConfig
    shape: InputShape
    mesh: Any
    rules: dict
    model: Any
    step_fn: Callable
    args: tuple                  # abstract arguments (meta tensors)
    in_shardings: tuple          # placement trees, one per argument
    out_shardings: Any
    donate: tuple
    kind: str
    spmd: Optional[MeshStep] = None
    n_microbatches: Optional[int] = None     # a train plan's

    def shard(self, *trees) -> tuple:
        """This rank's slices of full trees given in ``args``' order (a
        None passes through): the step's inputs."""
        return tuple(None if t is None else shard_by(t, s, self.mesh)
                     for t, s in zip(trees, self.in_shardings))

    def cache(self, **kw) -> dict:
        """A zeroed decode cache of this rank's slices (prefill and decode
        plans); ``kw``: the model's ``cache_template`` options (the
        encoder-decoder's ``enc_len``, which the decode step then takes
        too)."""
        tmpl = self.model.cache_template(self.shape.global_batch,
                                         self.shape.seq_len, **kw)
        return init_params(local_template(tmpl, self.rules),
                           torch.Generator(device=self.mesh.device),
                           DTYPES[self.cfg.dtype], self.mesh.device)


def _batch_abstract(cfg: ModelConfig, shape: InputShape, kind: str):
    gb, s = shape.global_batch, shape.seq_len
    dt = DTYPES[cfg.dtype]
    meta = lambda *sh, dtype=torch.int32: torch.empty(  # noqa: E731
        sh, dtype=dtype, device="meta")
    out = {}
    if kind == "decode":
        out["tokens"] = meta(gb)
        return out
    out["tokens"] = meta(gb, s)
    if kind == "train":
        out["labels"] = meta(gb, s)
    if cfg.family == "vlm":
        out["vision_embeds"] = meta(gb, cfg.n_vision_tokens, cfg.d_model,
                                    dtype=dt)
    if cfg.family == "audio":
        out["audio_embeds"] = meta(gb, s, cfg.d_model, dtype=dt)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape, model=None,
                kind: Optional[str] = None):
    """Abstract inputs for a cell: the batch, and for prefill and decode
    the cache too (meta tensors of the global shapes)."""
    kind = kind or shape.kind
    batch = _batch_abstract(cfg, shape, kind)
    if kind == "train":
        return batch
    model = model or build(cfg)
    dt = DTYPES[cfg.dtype]
    cache_tmpl = model.cache_template(shape.global_batch, shape.seq_len,
                                      dtype=dt)
    return batch, abstract_params(cache_tmpl, dt)


def plan_cell(cfg: ModelConfig, shape: InputShape, mesh, *,
              impl: Optional[str] = None, ssm_impl: Optional[str] = None,
              mlstm_impl: str = "ref",
              rule_overrides: Optional[dict] = None,
              n_microbatches: Optional[int] = None,
              hoist_fsdp_gather: Optional[bool] = None) -> CellPlan:
    """Plan ``cfg`` at ``shape`` on ``mesh``. ``impl`` defaults to the
    kernels for prefill and decode (``"auto"``) and to the plain versions
    for training (``"torch"``: the kernels have no backward pass), and
    ``ssm_impl`` (``models.registry.SSM_IMPLS``) to the chunked Mamba scan
    for training (``"chunked"``, the JAX package's default) and to
    ``"ref"`` for prefill and decode (the ``selective_scan`` kernel). The
    hoist rule is the JAX package's: with FSDP and more than one
    microbatch, gather the weights once per step when their gathered
    layout fits ``HOIST_GIB`` a device. Prefill and decode plans keep
    the weights in the gathered layout (``embed`` unsharded, unless
    ``rule_overrides`` shard it): a serving step then issues only the
    collectives of the activations, where the JAX package's plan
    all-gathers the FSDP weights on every call. A cache whose rows the
    rules split (``cache_seq``; ``{"cache_seq": "model", "kv_heads":
    None}`` splits them where the kv heads divide the axis) must have a
    length the axis divides."""
    kind = shape.kind
    if kind != "train":
        rule_overrides = {"embed": None, **(rule_overrides or {})}
    rules = rules_mod.make_rules(cfg, mesh, overrides=rule_overrides)
    batch_sh = rules_mod.batch_shardings(cfg, mesh, rules, shape, kind)
    if kind == "prefill":
        batch_sh.pop("labels")
    impl = impl or ("torch" if kind == "train" else "auto")
    ssm_impl = ssm_impl or ("chunked" if kind == "train" else "ref")
    model = build(cfg, impl=impl, ssm_impl=ssm_impl, mlstm_impl=mlstm_impl,
                  ep_degree=rules_mod.ep_degree(mesh))
    dt = DTYPES[cfg.dtype]
    tmpl = model.template()
    params_abs = abstract_params(tmpl, dt)
    params_sh = pspec_tree(tmpl, rules)

    if kind == "train":
        from .roofline import tree_device_bytes
        ocfg = opt_config(cfg)
        nm = n_microbatches or default_microbatches(cfg, shape, mesh)
        if hoist_fsdp_gather is None:
            gathered_gib = tree_device_bytes(
                tmpl, rules_mod.gathered(rules)) / 2**30
            hoist_fsdp_gather = nm > 1 and gathered_gib <= HOIST_GIB
        spmd = MeshStep(mesh, rules, tmpl,
                        hoist=bool(hoist_fsdp_gather and cfg.fsdp))
        step = make_train_step(model, ocfg, n_microbatches=nm, donate=True,
                               spmd=spmd)
        sdt = DTYPES[ocfg.state_dtype]
        opt_abs = {"m": abstract_params(tmpl, sdt),
                   "v": abstract_params(tmpl, sdt),
                   "step": torch.empty((), dtype=torch.int32,
                                       device="meta")}
        opt_sh = {"m": params_sh, "v": params_sh, "step": []}
        metrics_sh = {"loss": [], "grad_norm": [], "lr": []}
        return CellPlan(
            cfg, shape, mesh, rules, model, step,
            args=(params_abs, opt_abs, _batch_abstract(cfg, shape, kind)),
            in_shardings=(params_sh, opt_sh, batch_sh),
            out_shardings=(params_sh, opt_sh, metrics_sh),
            donate=(0, 1), kind=kind, spmd=spmd, n_microbatches=nm)

    seq_axis = model.cache_rows_axis(rules)
    extent = math.prod(mesh.shape.get(a, 1) for a in axes_of(seq_axis))
    if shape.seq_len % extent:
        # The model reads the cache rows' split from the rules alone:
        # they must divide evenly. (A cross layer's source rows stay whole
        # where they do not: ``models.attention.cache_rows_axis``.)
        raise ValueError(f"a cache of {shape.seq_len} rows does not split "
                         f"over {seq_axis!r} of extent {extent}")
    spmd = MeshStep(mesh, rules, tmpl)
    cache_tmpl = model.cache_template(shape.global_batch, shape.seq_len,
                                      dtype=dt)
    cache_abs = abstract_params(cache_tmpl, dt)
    cache_sh = pspec_tree(cache_tmpl, rules)

    def run(method, **defaults):
        def step(params, inputs, cache, **kw):
            gparams = spmd.gather(params)
            with torch.no_grad(), \
                    shard_ctx.activation_rules(spmd.model_rules):
                return method(gparams, inputs, cache, **{**defaults, **kw})
        return step

    if kind == "prefill":
        logits_sh = spec_dims((shape.global_batch, 1, cfg.padded_vocab),
                              ("batch", None, "vocab"), rules)
        return CellPlan(
            cfg, shape, mesh, rules, model, run(model.prefill),
            args=(params_abs, _batch_abstract(cfg, shape, kind), cache_abs),
            in_shardings=(params_sh, batch_sh, cache_sh),
            out_shardings=(logits_sh, cache_sh), donate=(2,), kind=kind,
            spmd=spmd)

    vocab_sh = spec_dims((shape.global_batch, cfg.padded_vocab),
                         ("batch", "vocab"), rules)
    tokens_abs = torch.empty((shape.global_batch,), dtype=torch.int32,
                             device="meta")
    # The encoder's frames of the plan's cache (``cache_template``'s
    # default): under a mesh a rank's cross caches cannot tell them.
    enc = {"enc_len": shape.seq_len} if cfg.enc_layers else {}
    return CellPlan(
        cfg, shape, mesh, rules, model, run(model.decode_step, **enc),
        args=(params_abs, tokens_abs, cache_abs),
        in_shardings=(params_sh, batch_sh["tokens"], cache_sh),
        out_shardings=(vocab_sh, cache_sh), donate=(2,), kind=kind,
        spmd=spmd)

