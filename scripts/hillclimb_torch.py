"""The hill-climb variants of ``scripts/scripts_hillclimb{,2,3}.py`` on the
PyTorch port: each run is one cell (architecture x shape x mesh) with its
changes, counted by ``repro_torch.launch.dryrun.measure_cell`` (one rank's
step on fake tensors over a fake process group; no card) and read by
``repro_torch.launch.roofline.terms_from_record``.

    PYTHONPATH=src python scripts/hillclimb_torch.py [FILTER ...]

A run goes when its name holds one of the FILTERs (all of them with
none). Each record, or the error a run raised, is written to
``results/hillclimb_torch/NAME.json``; a record already there is kept.
One line a run is printed: extrapolated FLOPs and collective bytes, the
roofline terms, the dominant one and the roofline fraction.

The 14 runs, in the three scripts' order:
  A  yi-34b train_4k: heads padded to 64, remat "dots", the hoisted FSDP
     gather, 2 microbatches, the sequence-parallel residual
     (``{"act_seq": "model"}``);
  B  xlstm-1.3b prefill_32k: the chunkwise mLSTM, TP-only weights, one
     (16, 1) island;
  C  dbrx-132b decode_32k: TP-only weights.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch.dryrun import measure_cell  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.roofline import terms_from_record  # noqa: E402

OUT_DIR = Path("results/hillclimb_torch")
SINGLE = make_production_mesh(multi_pod=False)
ISLAND = Mesh(("data", "model"), (16, 1))


def runs() -> list:
    """(name, config, shape name, measure_cell keywords, mesh) of the 14
    runs."""
    yi = configs.get("yi-34b")
    yi_dots = dataclasses.replace(yi, pad_heads_to=64, remat="dots")
    xl, dbrx = configs.get("xlstm-1.3b"), configs.get("dbrx-132b")
    tp_only = {"rule_overrides": {"embed": None}}
    return [
        ("A_yi34b_train__baseline", yi, "train_4k", {}, SINGLE),
        ("A_yi34b_train__pad_heads64",
         dataclasses.replace(yi, pad_heads_to=64), "train_4k", {}, SINGLE),
        ("A_yi34b_train__pad_heads64_remat_dots", yi_dots, "train_4k", {},
         SINGLE),
        ("B_xlstm_prefill__baseline", xl, "prefill_32k", {}, SINGLE),
        ("B_xlstm_prefill__chunkwise", xl, "prefill_32k",
         {"mlstm_impl": "chunkwise"}, SINGLE),
        ("C_dbrx_decode__baseline", dbrx, "decode_32k", {}, SINGLE),
        ("C_dbrx_decode__no_fsdp", dbrx, "decode_32k", tp_only, SINGLE),
        ("A_yi34b_train__pad64_dots_hoist", yi_dots, "train_4k",
         {"hoist_fsdp_gather": True}, SINGLE),
        ("B_xlstm_prefill__chunk_nofsdp", xl, "prefill_32k",
         {"mlstm_impl": "chunkwise", **tp_only}, SINGLE),
        ("C_dbrx_decode__splitkv", dbrx, "decode_32k", tp_only, SINGLE),
        ("A_yi34b_train__pad64_dots_nm2", yi_dots, "train_4k",
         {"n_microbatches": 2}, SINGLE),
        ("A_yi34b_train__pad64_dots_nm2_hoist", yi_dots, "train_4k",
         {"n_microbatches": 2, "hoist_fsdp_gather": True}, SINGLE),
        ("A_yi34b_train__pad64_dots_sp", yi_dots, "train_4k",
         {"rule_overrides": {"act_seq": "model"}}, SINGLE),
        ("B_xlstm_prefill__chunk_island", xl, "prefill_32k",
         {"mlstm_impl": "chunkwise"}, ISLAND),
    ]


def measure(name, cfg, shape, kw, mesh, **measure_kw) -> dict:
    """One run's record with its roofline terms (``"terms"``), or
    ``{"variant", "error", "traceback"}`` where it raised."""
    try:
        rec = measure_cell(cfg, shape, mesh, **kw, **measure_kw)
        rec["mesh_name"] = "island" if mesh.shape == ISLAND.shape \
            else "single"
        rec["variant"] = name
        rec["terms"] = terms_from_record(rec)
    except Exception as e:  # a failed run is recorded, the next one runs
        rec = {"variant": name, "error": str(e),
               "traceback": traceback.format_exc()}
    return rec


def summary(rec: dict) -> str:
    """The run's printed line."""
    name = rec["variant"]
    if "error" in rec:
        return f"{name}: FAIL {rec['error']}"
    t = rec["terms"]
    ext = rec.get("extrapolated", {})
    flops = ext.get("flops", rec["cost_full_hlo"]["flops"])
    coll = ext.get("coll", rec["collectives_full_hlo"]["total_bytes"])
    return (f"{name}: flops={flops:.3e} coll={coll:.3e} "
            f"tC={t['t_compute_s']:.3e} tM={t['t_memory_s']:.3e} "
            f"tX={t['t_collective_s']:.3e} dom={t['dominant']} "
            f"frac={t['roofline_fraction']:.3f}")


def main(argv=None) -> None:
    filters = sys.argv[1:] if argv is None else argv
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, cfg, shape, kw, mesh in runs():
        if filters and not any(f in name for f in filters):
            continue
        path = OUT_DIR / f"{name}.json"
        if path.exists():
            print("skip (exists)", name)
            continue
        rec = measure(name, cfg, SHAPES[shape], kw, mesh)
        print(summary(rec), flush=True)
        path.write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
