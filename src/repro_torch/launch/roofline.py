"""Roofline analysis (the JAX package's ``launch/roofline.py``) with the
H100's constants: three terms per (arch x shape x mesh).

    compute term    = FLOPs_per_device / PEAK_FLOPS                [s]
    memory term     = bytes_per_device / HBM_BW                    [s]
    collective term = collective_bytes_per_device / LINK_BW        [s]

    MODEL_FLOPS = 6 N D (train) / 2 N D (prefill) / 2 N B (decode)

N the active (per-token) parameters, D the tokens of a step, B the decode
batch. ``model_flops / (step seconds x PEAK_FLOPS_BF16)`` is a train
step's model FLOPs utilisation (MFU).

The per-device half is accounting over the sharding rules on a
shape-only mesh: the bytes a device stores (``tree_device_bytes``), an
analytic fused-kernel HBM traffic per step (``fused_memory_bytes``) and
the score tensor a fused attention kernel never writes
(``attention_score_bytes``). ``terms_from_record`` reads a dry-run
record (FLOPs, bytes and collective bytes per device, memory), which
``launch.dryrun`` writes; ``build_table`` reads a directory of them:

    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun \
        results/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os


from .. import configs
from ..configs.base import SHAPES
from ..models import build

# NVIDIA H100 80GB HBM3 (SXM), per card: HBM3 bandwidth, the f32 (non
# tensor core) peak and the dense bf16 tensor-core peak.
HBM_BW = 3.35e12               # bytes/s
PEAK_FLOPS_F32 = 67e12         # FLOP/s
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense
CARD = "NVIDIA H100 80GB HBM3"
# The compute term's peak: dense bf16, as the JAX package's is its chip's.
PEAK_FLOPS = PEAK_FLOPS_BF16
# NVLink 4 on the H100 SXM: 18 links, 900 GB/s a card in both directions
# together (NVIDIA's data sheet), 450 GB/s each way.
LINK_BW = 450e9                # bytes/s
HBM_BYTES = 80e9               # the card's memory

# The JAX package counts parameters with the experts padded for an
# expert-parallel degree of 16 (the padding cancels in the active count,
# the router's columns do not).
EP_DEGREE = 16


def active_params(cfg) -> float:
    """Active (per-token) parameter count: the total with experts padded
    for ``EP_DEGREE``, minus the routed experts a token does not use."""
    total = build(cfg, impl="torch", ep_degree=EP_DEGREE).param_count()
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


def _shard_extent(spec, mesh_sizes) -> int:
    n = 1
    for ax in spec:
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else ax
        for a in axes:
            n *= mesh_sizes.get(a, 1)
    return n


def tree_device_bytes(template, rules, dtype_size=2) -> float:
    """Per-device stored bytes of a P-template under the sharding rules.

    The dtype of a leaf counts as in the JAX package: by the name
    ``str(p.dtype)`` ("float32", "int32", "bfloat16"), else
    ``dtype_size``. Neither package's templates carry such a name (the JAX
    package's are ``jnp.float32``-style classes, the port's torch dtypes),
    so every leaf counts at ``dtype_size`` (ROADMAP section 3)."""
    from ..models.common import pspec_tree, tree_leaves
    specs = pspec_tree(template, rules)
    sizes = rules["_mesh_sizes"]
    total = 0.0
    for p, s in zip(tree_leaves(template), tree_leaves(specs)):
        ds = {"float32": 4, "int32": 4, "bfloat16": 2}.get(
            str(p.dtype), dtype_size) if p.dtype is not None else dtype_size
        total += p.size * ds / _shard_extent(s, sizes)
    return total


class _ShapeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)


def fused_memory_bytes(cfg, shape, mesh_sizes) -> float:
    """Analytic per-device HBM traffic per step, assuming fused kernels:
    weight reads per pass, optimizer-state read/write, one activation save
    + recompute per layer (full remat), cache read(+write) at decode."""
    from ..sharding.rules import make_rules
    from .specs import default_microbatches, opt_config
    mesh = _ShapeMesh(mesh_sizes)
    rules = make_rules(cfg, mesh)
    model = build(cfg, impl="torch", ep_degree=mesh_sizes.get("data", 1))
    p_dev = tree_device_bytes(model.template(), rules)
    dp = mesh_sizes.get("pod", 1) * mesh_sizes.get("data", 1)
    tokens_dev = shape.global_batch * shape.seq_len / min(
        dp, shape.global_batch)
    act_unit = cfg.d_model * 2.0                     # bf16 per token

    if shape.kind == "train":
        nm = default_microbatches(cfg, shape, mesh)
        st = 4 if opt_config(cfg).state_dtype == "float32" else 2
        w_traffic = (2 * nm + 2) * p_dev             # fwd+bwd reads, update
        opt_traffic = (4 * st / 2 + 2) * p_dev       # m,v rw + param rw
        act_traffic = cfg.n_layers * tokens_dev * act_unit * 8
        return w_traffic + opt_traffic + act_traffic
    cache_dev = tree_device_bytes(
        model.cache_template(shape.global_batch, shape.seq_len), rules)
    if shape.kind == "prefill":
        return 2 * p_dev + cfg.n_layers * tokens_dev * act_unit * 4 \
            + cache_dev
    # decode: weights + full cache read (+ small write)
    return 2 * p_dev + cache_dev


def attention_score_bytes(cfg, shape, n_devices: int) -> float:
    """Per-device bytes of ONE layer's materialized f32 score tensor, the
    fused-attention memory correction (the mLSTM's parallel form gets the
    same)."""
    dp = min(shape.global_batch, max(n_devices // 16, 1))
    b_local = max(shape.global_batch // max(dp, 1), 1)
    heads_local = max(cfg.n_heads // 16, 1) if cfg.n_heads % 16 == 0 \
        else cfg.n_heads
    s = shape.seq_len
    if shape.kind == "decode":
        return 2.0 * b_local * heads_local * s * 4
    return 2.0 * b_local * heads_local * float(s) * s * 4


def terms_from_record(rec: dict) -> dict:
    """The roofline terms of one dry-run record (the JAX package's
    format: arch, shape, n_devices, the extrapolated or full-HLO FLOPs,
    bytes and collective bytes per device, memory in GiB)."""
    cfg = configs.get(rec["arch"])
    shape = SHAPES[rec["shape"]]
    chips = rec["n_devices"]
    mesh_sizes = ({"pod": 2, "data": 16, "model": 16} if chips == 512
                  else {"data": 16, "model": 16})
    ex = rec.get("extrapolated") or {
        "flops": rec["cost_full_hlo"]["flops"],
        "bytes": rec["cost_full_hlo"]["bytes"],
        "coll": rec["collectives_full_hlo"]["total_bytes"]}
    t_compute = ex["flops"] / PEAK_FLOPS
    t_memory_hlo = ex["bytes"] / HBM_BW          # pre-fusion upper bound
    t_memory = fused_memory_bytes(cfg, shape, mesh_sizes) / HBM_BW
    t_coll = ex["coll"] / LINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    useful = mf / max(ex["flops"] * chips, 1e-9)
    bound = max(t_compute, t_memory, t_coll)
    # Roofline fraction: useful work at peak vs the achievable step time.
    frac = (mf / chips / PEAK_FLOPS) / max(bound, 1e-12)
    score_corr = attention_score_bytes(cfg, shape, chips) / 2**30
    mem = rec["memory"]
    per_chip_raw = mem["argument_gib"] + mem["temp_gib"]
    per_chip_fused = mem["argument_gib"] + max(
        mem["temp_gib"] - score_corr, 0.0)
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": rec.get("mesh_name", "single"), "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_memory_hlo_s": t_memory_hlo, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf, "hlo_flops_per_dev": ex["flops"],
        "useful_fraction": useful, "roofline_fraction": frac,
        "mem_per_chip_raw_gib": per_chip_raw,
        "mem_per_chip_fused_gib": per_chip_fused,
        "fits_80gb_fused": per_chip_fused <= HBM_BYTES / 2**30,
    }


def suggestion(t: dict) -> str:
    if t["dominant"] == "collective":
        return ("reduce resharding: fuse all-gathers (FSDP prefetch), "
                "overlap collectives with compute, or compress grads")
    if t["dominant"] == "memory":
        if t["shape"].startswith("decode") or t["shape"].startswith("long"):
            return ("decode is cache-BW bound: shrink KV (MLA/GQA/quant) "
                    "or raise batch to amortize weight reads")
        return ("cut HBM traffic: fused attention kernel, tighter remat "
                "policy, bf16 activations end-to-end")
    return ("raise tensor-core utilization: bigger microbatches, fewer "
            "one-hot matmuls (MoE gather dispatch), lighter remat")


def build_table(dryrun_dir: str):
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "skipped" in rec or "error" in rec:
            continue
        t = terms_from_record(rec)
        t["suggestion"] = suggestion(t)
        rows.append(t)
    return rows


def to_markdown(rows, title="Roofline") -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | useful | roofline | mem/chip (fused) |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [f"### {title}\n", hdr]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"],
                                         r["mesh"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_fraction']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['mem_per_chip_fused_gib']:.1f} GiB |\n")
    return "".join(out)


def device_gib(cfg, mesh_sizes, dtype_size: int = 2) -> float:
    """GiB of parameters a device stores under the production rules (the
    model built with the mesh's expert-parallel degree)."""
    from ..sharding.rules import make_rules
    rules = make_rules(cfg, _ShapeMesh(mesh_sizes))
    model = build(cfg, impl="torch", ep_degree=mesh_sizes.get("data", 1))
    return tree_device_bytes(model.template(), rules, dtype_size) / 2**30


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun")
    ap.add_argument("--out", default="results/roofline")
    args = ap.parse_args(argv)
    rows = build_table(args.dryrun)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out + ".json", "w") as f:
        json.dump(rows, f, indent=1)
    md = to_markdown(rows)
    with open(args.out + ".md", "w") as f:
        f.write(md)
    print(md)
    worst = sorted(rows, key=lambda r: r["roofline_fraction"])[:5]
    print("\nworst roofline fractions:")
    for r in worst:
        print(f"  {r['arch']} {r['shape']} {r['mesh']}: "
              f"{r['roofline_fraction']:.3f} ({r['dominant']}) -> "
              f"{r['suggestion']}")
    return rows


if __name__ == "__main__":
    main()
