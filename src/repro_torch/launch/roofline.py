"""The analytic half of the roofline: active parameters and model FLOPs
per step (the JAX package's ``launch/roofline.py``), with the H100's
constants.

    MODEL_FLOPS = 6 N D (train) / 2 N D (prefill) / 2 N B (decode)

N the active (per-token) parameters, D the tokens of a step, B the decode
batch. ``model_flops / (step seconds x PEAK_FLOPS_BF16)`` is a train
step's model FLOPs utilisation (MFU). The terms that read the dry-run's
compiled records (HLO FLOPs, bytes, collectives, the per-device memory)
wait for the port's ``sharding/``.
"""
from __future__ import annotations

from ..models import build

# NVIDIA H100 80GB HBM3 (SXM), per card: HBM3 bandwidth, the f32 (non
# tensor core) peak and the dense bf16 tensor-core peak.
HBM_BW = 3.35e12               # bytes/s
PEAK_FLOPS_F32 = 67e12         # FLOP/s
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense
CARD = "NVIDIA H100 80GB HBM3"

# The JAX package counts parameters with the experts padded for an
# expert-parallel degree of 16 (the padding cancels in the active count,
# the router's columns do not).
EP_DEGREE = 16


def active_params(cfg) -> float:
    """Active (per-token) parameter count: the total with experts padded
    for ``EP_DEGREE``, minus the routed experts a token does not use."""
    model = build(cfg, impl="torch")
    if cfg.is_moe and not cfg.enc_layers:
        model.ep_pad = cfg.padded_experts(EP_DEGREE) or None
    total = model.param_count()
    if not cfg.is_moe:
        return total
    # Routed expert params (wi_gate + wi_up + wo) per MoE layer.
    e_pad = cfg.padded_experts(EP_DEGREE)
    per_expert = 3 * cfg.d_model * cfg.expert_d_ff
    n_moe_layers = sum(1 for i in range(cfg.n_layers)
                       if (cfg.moe_period == 1 or i % cfg.moe_period == 1))
    routed = n_moe_layers * e_pad * per_expert
    used = n_moe_layers * cfg.top_k * per_expert
    return total - routed + used


def model_flops(cfg, shape) -> float:
    """Global useful FLOPs per step of ``shape`` (``configs.InputShape``):
    6ND (train) / 2ND (prefill) / 2N per sequence (decode: one token)."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
