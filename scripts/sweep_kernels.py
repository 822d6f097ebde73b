#!/usr/bin/env python3
"""Sweep the tile constants of CUDA kernels of the port on one GPU.

    python3 scripts/sweep_kernels.py [--out chiprun_out/sweep.json]
        [--only flash_attention|selective_scan|waterfill|end_to_end|argmin]
        [--tree DIR]

For each variant it rewrites the constants in a copy of the kernel's
source (under the gitignored ``src/repro_torch/_build/sweep/``), builds
it (all variants in parallel, one nvcc each), holds it against the plain
version at the sweep's shapes and times it with CUDA events:

  flash_attention - ``Tiling<128>`` (warps of 16 query rows, keys per KV
                    tile, ring slots, chunks in flight), and design
                    experiments on the first tiling (FA_EXPERIMENTS), at
                    qwen2.5-3b's prefill widths (b=1, h=16, kvh=2, d=128,
                    causal, f32) for s = t = 6, 192 and 2048;
  selective_scan  - ``LANES`` (lanes per channel) and ``CHUNK`` (tokens per
                    staged chunk) at jamba's widths (b=1, inner 16384,
                    n 16, f32) for s = 6 and 2048;
  waterfill       - the water-fill teams (G CTAs of T threads per server,
                    meeting through a cluster or a grid barrier) at the
                    shapes of the main paths (FILL_SHAPES, loop effort),
                    through the wrappers' pins (no source copies): each
                    team held bitwise against the plain version, timed
                    by CUDA events (wrapper) and the profiler (device),
                    and at the host rule's plan also at two more efforts,
                    which give the time of one bisection step and of one
                    fill sum; then end_to_end;
  end_to_end      - one profiled MIN slot at N=100,000 on S=32 (device
                    time by kernel), LBCD's per-slot split at N=10,000 on
                    S=32 (virtual solve, first-fit, per-server solve; 2
                    slots), the launch-bound paper cell's slots/s (LBCD
                    fused and ``:nofuse``, energy-aware LBCD; 25 slots;
                    on a tree with obs also OBS_PAIRS pairs of each with
                    obs off and on, the order alternating),
                    and the slots/s of LBCD and DOS at N=10,000 and MIN
                    and JCAB at N=100,000 (2-4 slots).
  argmin          - config_argmin (N=30, 1,000, 10,000) and
                    baseline_argmax (DOS and JCAB at N=100,000) with the
                    lane rules of ARGMIN_VARIANTS, each held
                    index-bitwise
                    to the plain version (planted ties and a ragged N
                    too), timed with the L2 warm and flushed, with its
                    registers and SASS entry loops.
``--tree DIR`` times the default plans of another checkout's water-fills
(or, with ``--only argmin``, its scans) instead (a parent commit unpacked
with ``git archive``), for a comparison on one card in one call.

It prints one line per variant (times, registers and spills from ptxas)
and the fastest at the longest shape, and writes all of it as JSON. The
sources in the repository are not changed: the chosen constants are
written into them by hand.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

# (WARPS, BK, NS, AHEAD): every one keeps >= 8 warps per SM and fits the
# shared memory at d = 128 in f32.
FA_VARIANTS = [(8, 64, 4, 2), (8, 32, 4, 2), (4, 32, 4, 2), (8, 32, 6, 4),
               (8, 64, 3, 2)]
# Design experiments on the first tiling: (tag, [(pattern, replacement)]).
# Each isolates one cost: the tile-local P.V accumulator, the unrolling of
# the q.k loop, the rounding add of the operand split (truncation keeps
# the bar but is not the plain version's split: never shipped), the cross
# terms of 3xTF32, the ordering of the mma products.
FA_EXPERIMENTS = [
    ("direct_pv", [(r"constexpr bool kLocal = DMAX <= 128;",
                    "constexpr bool kLocal = false;")]),
    ("qk_unroll4", [(r"#pragma unroll 2\n  for \(int kk = 0; kk < d; kk "
                     r"\+= 8\)", "#pragma unroll 4\n  for (int kk = 0; "
                     "kk < d; kk += 8)")]),
    ("trunc_split", [(r"\(__float_as_uint\(x\) \+ 0x1000u\) & "
                      r"0xffffe000u", "__float_as_uint(x) & 0xffffe000u")]),
    # hi*hi alone (plain TF32: misses the f32 bar, timed only): how much of
    # the time the two cross-term products take.
    ("hi_only", [(r"mma_tf32\(sx\[nt\], al, bh\);\n      mma_tf32\(sx"
                  r"\[nt\], ah, bl\);", ""),
                 (r"#pragma unroll\n        for \(int u = 0; u < kPvGroup; "
                  r"\+\+u\) mma_tf32\(o\[nt \+ u\], al, bh\[u\]\);", ""),
                 (r"#pragma unroll\n        for \(int u = 0; u < kPvGroup; "
                  r"\+\+u\) mma_tf32\(o\[nt \+ u\], ah, bl\[u\]\);", "")]),
    # The TF32 mma helper without `volatile`, so the compiler may reorder
    # it.
    ("mma_not_volatile", [(r'asm volatile\(\n      "mma\.sync\.aligned'
                           r'\.m16n8k8', 'asm(\n      "mma.sync.aligned'
                           '.m16n8k8')]),
]
# Other P.V n-tile groups (kPvGroup) on the first tiling.
FA_EXPERIMENTS += [(f"pv_group{n}", [(r"constexpr int kPvGroup = \d+;",
                                      f"constexpr int kPvGroup = {n};")])
                   for n in (1, 2)]
# Experiments timed without holding them to the bar.
UNCHECKED = {"flash_attention_hi_only"}
SCAN_VARIANTS = [(lanes, chunk) for lanes in (2, 4, 8, 16)
                 for chunk in (16, 32)]
# Water-fill shapes: (cameras, servers, kernel). "tiled" is one bandwidth
# fill through waterfill_tiled at auto's tile (MIN's virtual server and a
# 32-server fleet), "pair" one waterfill_pair (LBCD's virtual server and
# servers), "waterfill" one bandwidth fill of the paper setting.
FILL_SHAPES = {"tiled N=100000 S=1": (100_000, 1, "tiled"),
               "tiled N=100000 S=32": (100_000, 32, "tiled"),
               "pair N=10000 S=1": (10_000, 1, "pair"),
               "pair N=10000 S=32": (10_000, 32, "pair"),
               "waterfill N=30 S=3": (30, 3, "waterfill")}
# Teams pinned per shape beside the host rule's: (G, T, sync). The paper
# shape pins T alone (a pinned G would launch the tiled kernel).
FILL_TEAMS = {
    "tiled N=100000 S=1": [(16, 256, "cluster"), (16, 256, "grid"),
                           (32, 256, "grid"), (64, 256, "grid"),
                           (128, 256, "grid"), (128, 128, "grid")],
    "tiled N=100000 S=32": [(2, 256, "cluster"), (4, 256, "cluster"),
                            (4, 256, "grid"), (4, 128, "cluster")],
    "pair N=10000 S=1": [(8, 256, "cluster"), (16, 256, "cluster"),
                         (16, 256, "grid"), (32, 256, "grid"),
                         (64, 128, "grid"), (64, 256, "grid"),
                         (128, 128, "grid"), (128, 64, "grid")],
    "pair N=10000 S=32": [(1, 256, "none"), (2, 256, "cluster"),
                          (2, 256, "grid"), (4, 128, "cluster"),
                          (4, 128, "grid")],
    "waterfill N=30 S=3": [(None, 32, None), (None, 64, None),
                           (None, 256, None)],
}
# The two scans' lanes per camera beside the shipped rule (csrc/
# slot_solver.cu: kScan*, kernel.scan_lanes): each fixed lane count, and
# the rule at half and twice the lanes per SM. Measured too and gaining
# nothing (PERF.md, section 6): rows staged in shared memory, 256-thread
# CTAs, a grid capped at one wave, entry loops unrolled 2 or 4 times.
ARGMIN_VARIANTS = ([{"ScanMinLanes": lanes, "ScanMaxLanes": lanes}
                    for lanes in (2, 4, 8, 16, 32)]
                   + [{"ScanLanesPerSm": n} for n in (256, 1024)])
# (label, kind, cameras, servers, seed, threshold): chip_smoke's inputs.
ARGMIN_SHAPES = [("config N=30", "config", 30, 3, 0, None),
                 ("config N=1000", "config", 1_000, 10, 2, None),
                 ("config N=10000", "config", 10_000, 32, 1, None),
                 ("config N=100000", "config", 100_000, 32, 8, None),
                 ("dos N=10000", "dos", 10_000, 32, 10, 1.0),
                 ("dos N=100000", "dos", 100_000, 32, 10, 1.0),
                 ("jcab N=100000", "jcab", 100_000, 32, 10, 0.5)]
LOOP = dict(outer_iters=10, inner_iters=3, final_inner_iters=5)
# More inner steps (each FCFS chain 2 * 6 + 10 * 6 = 72 steps longer) and
# more outer steps (10 evaluations more, each a fill sum and 3 steps).
MORE_INNER = dict(outer_iters=10, inner_iters=9, final_inner_iters=5)
MORE_OUTER = dict(outer_iters=20, inner_iters=3, final_inner_iters=5)
# Pairs of paper-cell runs with obs off and on (order alternating), in
# end_to_end on a tree that has obs.
OBS_PAIRS = 8


def cuda_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def variant_source(src: Path, tag: str, subs) -> Path:
    text = src.read_text()
    for pattern, repl in subs:
        text, n = re.subn(pattern, repl, text)
        if n != 1:
            raise AssertionError(f"{src.name}: {pattern!r} matched {n} times")
    out = ROOT / "src" / "repro_torch" / "_build" / "sweep" / f"{tag}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def build_all(name, variants, _build, flags):
    """Build every variant, one nvcc each in parallel: {tag: library path
    or the exception its build raised}."""
    def one(path):
        try:
            return _build.build(name, (path,), flags)
        except RuntimeError as exc:
            return exc
    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(
            one, [path for _, path in variants.values()])))


def run_variants(kernel, variants, libs, measure):
    """``measure(tag, consts, library path)`` for each variant with the
    kernel module pointed at the variant's source; a variant that fails
    to build, disagrees or faults is recorded and skipped."""
    base = kernel.SOURCES
    rows, failed = [], []
    for tag, (consts, path) in variants.items():
        kernel.SOURCES = (path,)
        kernel._Library.lib = None
        try:
            if isinstance(libs[tag], Exception):
                raise libs[tag]
            rows.append(measure(tag, consts, libs[tag]))
        except (AssertionError, RuntimeError) as exc:
            print(f"{tag}: FAILED {str(exc)[:2000]}", flush=True)
            failed.append(dict(tag=tag, error=str(exc)[:4000]))
    kernel.SOURCES = base
    kernel._Library.lib = None
    return rows, failed


def normal(shape, dev, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev)


def summary(name, row, shapes):
    regs = sorted({u.get("registers") for u in row["usage"].values()})
    spills = max(u.get("spill_stores", 0) for u in row["usage"].values())
    print(f"{name} {row['tag']}: " + ", ".join(
        f"s={s} {row[f'ms s={s}']:.4f} ms" for s in shapes)
        + f"; registers {regs}, spill stores <= {spills} B", flush=True)


def fastest(name, rows):
    if rows:
        best = min(rows, key=lambda r: r["ms s=2048"])
        print(f"{name} fastest at s=2048: {best['tag']}", flush=True)


def sweep_attention(dev, kernel, ops, ref, _build):
    import torch
    variants = {}
    for w, bk, ns, ahead in FA_VARIANTS:
        tag = f"flash_attention_w{w}_bk{bk}_ns{ns}_a{ahead}"
        variants[tag] = ((w, bk, ns, ahead), variant_source(
            kernel.SOURCES[0], tag,
            [(r"struct Tiling<128> \{\n  static constexpr int WARPS = \d+, "
              r"BK = \d+, NS = \d+, AHEAD = \d+;",
              f"struct Tiling<128> {{\n  static constexpr int WARPS = {w}, "
              f"BK = {bk}, NS = {ns}, AHEAD = {ahead};")]))
    for name, subs in FA_EXPERIMENTS:
        tag = f"flash_attention_{name}"
        try:
            variants[tag] = (FA_VARIANTS[0], variant_source(
                kernel.SOURCES[0], tag, subs))
        except AssertionError as exc:   # the source has moved on
            print(f"{tag}: skipped, {exc}", flush=True)
    libs = build_all("flash_attention", variants, _build,
                     _build.ATTENTION_FLAGS)
    inputs = {s: [normal((1, s, h, 128), dev, 80 + i)
                  for i, h in enumerate((16, 2, 2))] for s in (6, 192, 2048)}

    def measure(tag, consts, lib):
        got = kernel.tiling(128)
        if (got["warps"], got["bk"], got["slots"], got["ahead"]) != consts:
            raise AssertionError(f"{tag}: library reports {got}")
        row = dict(tag=tag, warps=consts[0], bq=16 * consts[0],
                   bk=consts[1], slots=consts[2], ahead=consts[3],
                   usage=_build.ptxas_usage(lib.with_suffix(".log"),
                                            "flash_attention_kernel"))
        for s, (q, k, v) in inputs.items():
            out = ops.attention(q, k, v)
            want = ref.mha_ref(q, k, v)
            torch.cuda.synchronize()
            err = (out - want).abs()
            if (tag not in UNCHECKED
                    and not bool((err <= 2e-5 + 2e-5 * want.abs()).all())):
                raise AssertionError(f"{tag} s={s}: max abs err "
                                     f"{float(err.max()):.3e}")
            row[f"ms s={s}"] = cuda_ms(lambda: ops.attention(q, k, v))
            row[f"err s={s}"] = float(err.max())
        # The bf16 path at the longest shape: the rate of bf16 mma.sync
        # beside the f32 path's TF32.
        qb, kb, vb = (x.bfloat16() for x in inputs[2048])
        row["bf16 ms s=2048"] = cuda_ms(lambda: ops.attention(qb, kb, vb))
        summary("flash_attention", row, inputs)
        print(f"  bf16 s=2048 {row['bf16 ms s=2048']:.4f} ms", flush=True)
        return row

    rows, failed = run_variants(kernel, variants, libs, measure)
    fastest("flash_attention", rows)
    return rows, failed


def sweep_scan(dev, kernel, ops, ref, _build):
    import torch
    variants = {}
    for lanes, chunk in SCAN_VARIANTS:
        tag = f"selective_scan_l{lanes}_c{chunk}"
        variants[tag] = ((lanes, chunk), variant_source(
            kernel.SOURCES[0], tag,
            [(r"constexpr int LANES = \d+;", f"constexpr int LANES = {lanes};"),
             (r"constexpr int CHUNK = \d+;",
              f"constexpr int CHUNK = {chunk};")]))
    libs = build_all("selective_scan", variants, _build, _build.NVCC_FLAGS)
    inner, n = 16384, 16
    inputs = {}
    for s in (6, 2048):
        x = normal((1, s, inner), dev, 90)
        dt = torch.nn.functional.softplus(normal((1, s, inner), dev, 91)
                                          - 1.0)
        A = -torch.exp(normal((inner, n), dev, 92) * 0.5)
        inputs[s] = [x, dt, A, normal((1, s, n), dev, 93),
                     normal((1, s, n), dev, 94), normal((inner,), dev, 95)]
    wants = {s: ref.selective_scan_ref(*args) for s, args in inputs.items()}

    def measure(tag, consts, lib):
        lanes, chunk = consts
        if kernel.plan() != dict(lanes=lanes, chunk=chunk):
            raise AssertionError(f"{tag}: library reports {kernel.plan()}")
        row = dict(tag=tag, lanes=lanes, chunk=chunk,
                   usage=_build.ptxas_usage(lib.with_suffix(".log"),
                                            "selective_scan_kernel"))
        for s, args in inputs.items():
            y, h = ops.selective_scan(*args)
            torch.cuda.synchronize()
            y_want, h_want = wants[s]
            err = (y - y_want).abs()
            if not bool((err <= 1e-4 + 1e-4 * y_want.abs()).all()):
                raise AssertionError(f"{tag} s={s}: y max abs err "
                                     f"{float(err.max()):.3e}")
            row[f"h_last bitwise s={s}"] = bool(torch.equal(h, h_want))
            y_lanes, _ = ref.selective_scan_lanes_ref(*args, lanes=lanes)
            row[f"y bitwise lanes_ref s={s}"] = bool(torch.equal(y, y_lanes))
            row[f"ms s={s}"] = cuda_ms(lambda: ops.selective_scan(*args),
                                       reps=10)
            row[f"err s={s}"] = float(err.max())
        summary("selective_scan", row, inputs)
        print(f"  bitwise: " + ", ".join(f"{k} {v}" for k, v in row.items()
                                         if "bitwise" in k), flush=True)
        return row

    rows, failed = run_variants(kernel, variants, libs, measure)
    fastest("selective_scan", rows)
    return rows, failed


def argmin_source(kernel, tag, consts):
    return variant_source(kernel.SOURCES[0], tag, [
        (rf"constexpr int k{name} = \d+;", f"constexpr int k{name} = {value};")
        for name, value in consts.items()])


def sweep_argmin(dev, kernel, ops, ref, _build, tree):
    """config_argmin and baseline_argmax at ARGMIN_SHAPES: the checkout's
    own build first, then (unless ``tree``) each ARGMIN_VARIANTS copy; each
    held index-bitwise to the plain version there, on planted ties
    (``ref.tied_scan_inputs``, where this checkout has them) and at a
    ragged N, timed with the L2 warm and flushed (device ms by the
    profiler, wrapper ms by CUDA events), with ptxas registers and spills
    and the SASS entry loops."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    inputs = {}
    for label, kind, n, s, seed, thr in ARGMIN_SHAPES:
        d = chip_smoke.kernel_inputs(n, s, seed, dev)
        args = (d["b"], d["c"], d["acc"], d["xi"], d["size"], d["eff"])
        if kind == "config":
            q = torch.tensor(1.3, device=dev)
            inputs[label] = (
                "config_argmin_kernel",
                lambda a=args, q=q, n=n: ops.config_argmin(*a, q, 10.0, n),
                ref.config_argmin_ref(*args, q, 10.0, n))
        else:
            inputs[label] = (
                "baseline_argmax_kernel",
                lambda a=args, k=kind, t=thr: ops.baseline_argmax(
                    *a, mode=k, threshold=t),
                ref.baseline_argmax_ref(*args, mode=kind, threshold=thr))
    checks = []
    ragged = chip_smoke.kernel_inputs(1001, 7, 7, dev)
    ragged = (ragged["b"], ragged["c"], ragged["acc"], ragged["xi"],
              ragged["size"], ragged["eff"])
    tied = ([tuple(torch.as_tensor(x, device=dev)
                   for x in ref.tied_scan_inputs(n, seed))
             for n, seed in ((40, 0), (37, 1))]
            if hasattr(ref, "tied_scan_inputs") else [])
    for args in [ragged] + tied:
        n = args[0].shape[0]
        for q, v in ((1.3, 10.0), (50.0, 10.0)):
            q = torch.tensor(q, device=dev)
            checks.append((lambda a=args, q=q, v=v, n=n: ops.config_argmin(
                *a, q, v, n), ref.config_argmin_ref(*args, q, v, n)))
        for mode, thr in (("dos", 0.0), ("dos", 1.0), ("jcab", 1e-6),
                          ("jcab", 0.5)):
            checks.append((lambda a=args, m=mode, t=thr: ops.baseline_argmax(
                *a, mode=m, threshold=t), ref.baseline_argmax_ref(
                *args, mode=mode, threshold=thr)))

    def measure(tag, consts, lib):
        row = dict(tag=tag, tree=tree, consts=consts, usage={
            k: _build.ptxas_usage(lib.with_suffix(".log"), k)
            for k in ("config_argmin_kernel", "baseline_argmax_kernel")})
        row["sass"] = {f"{k} L={lanes}": chip_smoke.sass_entry_loops(
            lib, f"{k}_kernelILi{lanes}E") for k in ("config_argmin",
                                                    "baseline_argmax")
            for lanes in (2, 4, 8, 16, 32)} if not consts and not tree else {}
        for call, want in checks:
            if not all(torch.equal(a, b) for a, b in zip(call(), want)):
                raise AssertionError(f"{tag}: a check differs from the "
                                     "plain version")
        for label, (name, call, want) in inputs.items():
            if not all(torch.equal(a, b) for a, b in zip(call(), want)):
                raise AssertionError(f"{tag} {label}: indices differ from "
                                     "the plain version")
            row[label] = dict(
                ms=cuda_ms(call),
                device_ms=chip_smoke.device_ms(call, name),
                cold_device_ms=chip_smoke.device_ms(
                    chip_smoke.l2_flushed(call, dev), name))
        torch.cuda.synchronize()
        regs = "; ".join(f"{name.split('_')[0]} {u.get('registers')} "
                         f"registers {u.get('spill_stores', 0)} B spills"
                         for name, usage in row["usage"].items()
                         for u in usage.values())
        sass = "; ".join(f"{k} " + ", ".join(
            f"{x['instructions']} instr {x['mufu']} MUFU" for x in v)
            for k, v in row["sass"].items() if v)
        print(f"argmin {tag}: " + ", ".join(
            f"{label} {row[label]['device_ms']} / {row[label]['cold_device_ms']}"
            f" ms device warm / flushed ({row[label]['ms']:.4f} wrapper)"
            for label in inputs) + f"; {regs}; {sass}", flush=True)
        return row

    variants = {"default": ({}, kernel.SOURCES[0])}
    if not tree:
        for consts in ARGMIN_VARIANTS:
            tag = "argmin_" + "_".join(f"{k}{v}" for k, v in consts.items())
            variants[tag] = (consts, argmin_source(kernel, tag, consts))
    libs = build_all("slot_solver", variants, _build, _build.NVCC_FLAGS)
    return run_variants(kernel, variants, libs, measure)


def sweep_waterfill(dev, kernel, ops, _build, tree):
    """Every team of FILL_TEAMS (the host rule's plan first) at each of
    FILL_SHAPES; only the default plans where the wrappers take no pins
    (an older checkout)."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import allocate, bcd
    usage = _build.ptxas_usage(
        _build.build("slot_solver", kernel.SOURCES).with_suffix(".log"),
        "waterfill")
    print("waterfill registers: " + "; ".join(
        f"{k}: {u.get('registers')} registers, "
        f"{u.get('spill_stores', 0)} B spill stores"
        for k, u in usage.items()), flush=True)
    pins_taken = hasattr(ops, "fill_plan")
    rows, failed = [], []
    for shape, (n, s, kind) in FILL_SHAPES.items():
        d = chip_smoke.kernel_inputs(
            n, s, 11, dev, server_id=[0] * n if s == 1 else None)
        layout = ops.server_layout(d["sid"], s)
        bw = (d["k"], d["p"], d["pol"], d["mu"], d["sid"], d["bb"], s)
        pair = (d["k"], d["p"], d["pol"], d["mu"], d["inv_xi"], d["sid"],
                d["bb"], d["bc"], s)

        def call(effort, pins, kind=kind, bw=bw, pair=pair, layout=layout):
            if kind == "pair":
                return lambda: ops.waterfill_pair(*pair, layout=layout,
                                                  **pins, **effort)
            tile = bcd.DEFAULT_TILE_N if kind == "tiled" else None
            return lambda: (ops.waterfill_bandwidth(
                *bw, layout=layout, tile_n=tile, **pins, **effort),)

        def plain(effort, kind=kind, bw=bw, pair=pair):
            if kind == "pair":
                return allocate.waterfill_pair(*pair, **effort)
            return (allocate.waterfill_bandwidth(*bw, **effort),)
        want = plain(LOOP)
        name = {"tiled": "waterfill_tiled_kernel",
                "pair": "waterfill_pair_kernel",
                "waterfill": "waterfill_kernel"}[kind]
        teams = [None] + (FILL_TEAMS[shape] if pins_taken else [])
        for team in teams:
            pins = {} if team is None else {
                k: v for k, v in zip(("group", "threads", "sync"), team)
                if v is not None}
            if pins_taken:
                plan = ops.fill_plan(n, s, torch.cuda.get_device_properties(
                    dev).multi_processor_count, **pins)
                tag = f"G={plan.group} T={plan.threads} {plan.sync}"
            else:
                tag = "parent plan"
            tag += " (host rule)" if team is None else ""
            try:
                got = call(LOOP, pins)()
                torch.cuda.synchronize()
                bad = sum(int((g != w).sum()) for g, w in zip(got, want))
                if bad:
                    raise AssertionError(f"{bad} outputs differ from the "
                                         "plain version")
                row = dict(shape=shape, team=tag, tree=tree,
                           ms=cuda_ms(call(LOOP, pins)),
                           device_ms=chip_smoke.device_ms(
                               call(LOOP, pins), name))
                if team is None:
                    for label, effort in (("more_inner", MORE_INNER),
                                          ("more_outer", MORE_OUTER)):
                        row[f"device_ms {label}"] = chip_smoke.device_ms(
                            call(effort, pins), name)
                    if None not in (row["device_ms"],
                                    row["device_ms more_inner"],
                                    row["device_ms more_outer"]):
                        fills = 2 if kind == "pair" else 1
                        step = (row["device_ms more_inner"]
                                - row["device_ms"]) / (72 * fills)
                        row["step_us"] = step * 1e3
                        row["sum_us"] = ((row["device_ms more_outer"]
                                          - row["device_ms"]) / (10 * fills)
                                         - 3 * step) * 1e3
                        row["chain_floor_ms"] = chain_floor(
                            kind, row["step_us"], row["sum_us"], chip_smoke)
                rows.append(row)
                extra = "".join(f", {k} {row[k]:.4f}" for k in
                                ("step_us", "sum_us", "chain_floor_ms")
                                if k in row)
                print(f"{shape} {tag}: {row['ms']:.4f} ms wrapper, "
                      f"{row['device_ms']} ms device{extra}", flush=True)
            except (AssertionError, RuntimeError, ValueError) as exc:
                print(f"{shape} {tag}: FAILED {str(exc)[:500]}", flush=True)
                failed.append(dict(shape=shape, team=tag, error=str(exc)))
    return rows, failed


def chain_floor(kind, step_us, sum_us, chip_smoke):
    """The serial chain of one call at LOOP: its fill sums one after the
    other (2 + outer per fill, and the compute floors of a pair) and each
    FCFS camera's dependent bisection steps (chip_smoke.fill_steps), at
    the measured time of a sum and of a step; in ms."""
    modes = (True, False) if kind == "pair" else (True,)
    sums = len(modes) * (LOOP["outer_iters"] + 2) + (kind == "pair")
    steps = sum(chip_smoke.fill_steps(LOOP, bw)[0] for bw in modes)
    return (sums * sum_us + steps * step_us) / 1e3


def fill_end_to_end(dev, chip_smoke, tree):
    """One profiled MIN slot at N=100,000 on S=32 and LBCD's per-slot
    split at N=10,000 on S=32, at the default backend."""
    from repro_torch.core import baselines, energy, lbcd, profiles

    def system(n, s, n_slots):
        share = n / (10 * s)                 # the paper's per-camera share
        return dict(n_cameras=n, n_servers=s, n_slots=n_slots,
                    mean_bandwidth_hz=30e6 * share,
                    mean_compute_flops=50e12 * share, seed=0)
    tab = profiles.EdgeSystem(**system(100_000, 32, 1)).horizon(1, device=dev)
    baselines.rollout_min(tab, device=dev)                  # warm-up
    wall, busy = chip_smoke.profile_slot(
        lambda: baselines.rollout_min(tab, device=dev),
        f"MIN N=100000 one slot ({tree})", watch=("waterfill",))
    split = chip_smoke.split_times(system(10_000, 32, 2), 2, dev)
    print(f"LBCD N=10000 S=32 per-slot split ({tree}, s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    paper = dict(n_cameras=30, n_servers=3, n_slots=25, seed=0)
    cells = {
        f"LBCD {spec}": lambda spec=spec: lbcd.LBCDController(
            profiles.EdgeSystem(**paper), v=10.0, p_min=0.7,
            solver_backend=spec, device=dev)
        for spec in ("auto", "auto:nofuse")}
    cells["energy-aware LBCD"] = lambda: energy.EnergyAwareLBCD(
        profiles.EdgeSystem(**paper), energy=energy.EnergyModel(), v=10.0,
        p_min=0.7, device=dev)
    chip_smoke.drive(cells["LBCD auto"], 5)                 # warm-up
    rates = {}
    for label, make in cells.items():
        rates[label] = 25 / chip_smoke.drive(make, 25)[1]
    print(f"paper cell N=30 S=3 T=25 ({tree}), slots/s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rates.items()), flush=True)
    obs_pairs = paper_obs_pairs(chip_smoke, cells, tree)
    # chip_smoke's phase-3 cells at scale, fewer slots.
    at_scale = {
        "LBCD N=10000 T=2": (lambda: lbcd.LBCDController(
            profiles.EdgeSystem(**system(10_000, 32, 2)), v=10.0, p_min=0.7,
            device=dev), 2),
        "DOS N=10000 T=2": (lambda: baselines.make(
            "DOS", profiles.EdgeSystem(**system(10_000, 32, 2)),
            device=dev), 2)}
    for name, t in (("MIN", 2), ("JCAB", 4)):
        at_scale[f"{name} N=100000 T={t}"] = (
            lambda name=name, t=t: baselines.make(
                name, profiles.EdgeSystem(**system(100_000, 32, t)),
                device=dev), t)
    scale_rates = {label: t / chip_smoke.drive(make, t)[1]
                   for label, (make, t) in at_scale.items()}
    print(f"cells at scale ({tree}), slots/s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in scale_rates.items()), flush=True)
    return dict(shape="end to end", tree=tree, min_slot_wall_s=wall,
                min_slot_device_ms=busy, lbcd_split_s=split,
                paper_slots_per_s=rates, scale_slots_per_s=scale_rates,
                obs_pairs=obs_pairs)


def paper_obs_pairs(chip_smoke, cells, tree):
    """OBS_PAIRS pairs of each paper cell with obs off and on in one
    process, the order alternating, so host drift between processes
    drops out; None on a tree without obs."""
    import statistics
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rates = {label: {False: [], True: []} for label in cells}
    for i in range(OBS_PAIRS):
        for enabled in ((False, True) if i % 2 == 0 else (True, False)):
            obs.configure(enabled=enabled)
            for label, make in cells.items():
                rates[label][enabled].append(
                    25 / chip_smoke.drive(make, 25)[1])
    obs.configure(enabled=True)
    out = {}
    for label, r in rates.items():
        ratios = [on / off for off, on in zip(r[False], r[True])]
        q1, _, q3 = statistics.quantiles(r[False], n=4)
        out[label] = dict(off=r[False], on=r[True])
        print(f"obs pairs ({tree}), {label}: off median "
              f"{statistics.median(r[False]):.3f} slots/s (quartiles "
              f"{q1:.3f}-{q3:.3f}), on median "
              f"{statistics.median(r[True]):.3f}; on slower in "
              f"{sum(x < 1 for x in ratios)}/{OBS_PAIRS} pairs; on/off "
              f"median {statistics.median(ratios):.4f}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out/sweep.json")
    parser.add_argument("--only", choices=("flash_attention",
                                           "selective_scan", "waterfill",
                                           "end_to_end", "argmin"),
                        help="sweep one kernel, or only time end to end")
    parser.add_argument("--tree", help="time the water-fills (or, with "
                        "--only argmin, the scans) of this checkout "
                        "(--only waterfill unless end_to_end or argmin)")
    args = parser.parse_args()
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
        if args.only not in ("end_to_end", "argmin"):
            args.only = "waterfill"
    import torch
    if not torch.cuda.is_available():
        print("sweep_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    from repro_torch.kernels.slot_solver import kernel as sl_kernel
    from repro_torch.kernels.slot_solver import ops as sl_ops
    fa_rows, fa_failed, ss_rows, ss_failed = [], [], [], []
    wf_rows, wf_failed = [], []
    if args.only in (None, "flash_attention"):
        fa_rows, fa_failed = sweep_attention(dev, fa_kernel, fa_ops, fa_ref,
                                             _build)
    if args.only in (None, "selective_scan"):
        ss_rows, ss_failed = sweep_scan(dev, ss_kernel, ss_ops, ss_ref,
                                        _build)
    tree = args.tree or "this checkout"
    if args.only in (None, "waterfill"):
        wf_rows, wf_failed = sweep_waterfill(dev, sl_kernel, sl_ops, _build,
                                             tree)
    if args.only in (None, "waterfill", "end_to_end"):
        sys.path.insert(0, str(ROOT))
        import chip_smoke
        wf_rows.append(fill_end_to_end(dev, chip_smoke, tree))
    am_rows, am_failed = [], []
    if args.only in (None, "argmin"):
        from repro_torch.kernels.slot_solver import ref as sl_ref
        am_rows, am_failed = sweep_argmin(dev, sl_kernel, sl_ops, sl_ref,
                                          _build, args.tree)
    result = dict(card=smi, flash_attention=fa_rows, selective_scan=ss_rows,
                  waterfill=wf_rows, argmin=am_rows,
                  failed=fa_failed + ss_failed + wf_failed + am_failed)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
