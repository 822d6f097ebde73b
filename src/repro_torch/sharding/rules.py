"""Logical-axis -> mesh-axis rules, the per-architecture sharding policy
(the JAX package's ``sharding/rules.py``, the same keys and values).

Mesh axes: ("data", "model") single pod, ("pod", "data", "model") multi-pod.

  DP/FSDP : batch over (pod, data); weight EMBED dim over data when
            cfg.fsdp (the train step gathers those dims before the model
            runs and reduce-scatters their gradients).
  TP      : heads / mlp / expert_mlp / vocab / ssm_inner over model.
  EP      : experts over data (padded to the EP degree).
  SP      : the decode cache's sequence over model when kv_heads cannot be
            split over it (the JAX package's split-KV decode; the port's
            is ``models.attention``'s and ``models.mla``'s).

Divisibility and duplicate-mesh-axis conflicts are resolved per leaf by
``spec.spec_dims`` (first dim wins); anything unresolvable is replicated.
A placement here is the list ``spec_dims`` returns, the port's
``PartitionSpec``.
"""
from __future__ import annotations

from .spec import spec_dims


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def ep_degree(mesh) -> int:
    return mesh.shape["data"]


def make_rules(cfg, mesh, *, shard_cache_seq=None,
               overrides: dict | None = None) -> dict:
    sizes = dict(mesh.shape)
    tp = sizes.get("model", 1)
    dp = data_axes(mesh)
    kv_shardable = cfg.n_kv_heads % tp == 0
    if shard_cache_seq is None:
        shard_cache_seq = not kv_shardable
    rules = {
        "_mesh_sizes": sizes,
        # The port's mesh with its process groups, or None for a
        # shape-only mesh (accounting): the model then runs unsharded.
        "_mesh": mesh if getattr(mesh, "device_mesh", None) is not None
        else None,
        "batch": dp,
        "seq": None,
        "embed": "data" if cfg.fsdp else None,
        "heads": "model",
        "kv_heads": "model" if kv_shardable else None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "data",
        "expert_mlp": "model",
        "cache_seq": "model" if shard_cache_seq else None,
        "ssm_inner": "model",
        "ssm_state": None,
        "conv": None,
        "lora": None,
        "layers": None,
    }
    if overrides:
        rules.update(overrides)
    return rules


def gathered(rules: dict) -> dict:
    """The rules of the layout the model runs on: the FSDP dims gathered
    (``embed`` unsharded), everything else as in ``rules``."""
    out = dict(rules)
    out["embed"] = None
    return out


def named(mesh, template_tree, rules):
    """P-template tree -> placement tree (``spec_dims`` lists)."""
    from ..models.common import pspec_tree
    return pspec_tree(template_tree, rules)


def array_sharding(mesh, shape, axes, rules) -> list:
    """The placement of a plain array described by logical axes."""
    return spec_dims(shape, axes, rules)


def batch_shardings(cfg, mesh, rules, shape, kind: str) -> dict:
    """Placements of the input batch dict of a given shape cell."""
    gb, s = shape.global_batch, shape.seq_len
    out = {}
    if kind == "decode":
        out["tokens"] = array_sharding(mesh, (gb,), ("batch",), rules)
    else:
        out["tokens"] = array_sharding(mesh, (gb, s), ("batch", "seq"),
                                       rules)
        out["labels"] = out["tokens"]
    if cfg.family == "vlm" and kind != "decode":
        out["vision_embeds"] = array_sharding(
            mesh, (gb, cfg.n_vision_tokens, cfg.d_model),
            ("batch", "seq", "embed_act"), rules)
    if cfg.family == "audio" and kind != "decode":
        out["audio_embeds"] = array_sharding(
            mesh, (gb, s, cfg.d_model), ("batch", "seq", "embed_act"),
            rules)
    if kind == "decode":
        out.pop("labels", None)
    return out
