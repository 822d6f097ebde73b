#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

  1. card     - nvidia-smi name/power limit, torch/CUDA versions, nvcc build
                of the slot-solver kernels from the sources in this checkout;
  2. kernels  - each CUDA kernel against its plain PyTorch version on the
                card (config_argmin bitwise, water-fills at rtol=2e-4) at the
                main path's shapes and at edge cases, with CUDA-event times;
  3. end to end - LBCDController(...).run(8) at N=10,000 cameras on S=32
                servers with the default backend, held against the plain
                (solver_backend="torch") run by the rollout contract, and the
                paper setting (N=30, S=3, T=25) with ":nofuse"; every
                kernel's launch counter must be > 0.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``name, power.limit``, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, FP32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# Operations per unit of work, counted from the expressions in
# csrc/slot_solver.cu (each +, -, *, /, sqrt, min/max and compare is one):
# one (camera, model, resolution) score of config_argmin; one FCFS
# bisection step (h evaluation + bracket update); one LCFSP closed form;
# the per-camera bookkeeping of one dual evaluation (bracket, clip, sum).
OPS_CONFIG_ITEM = 40
OPS_FCFS_STEP = 41
OPS_LCFSP_EVAL = 8
OPS_CAMERA_EVAL = 8
ARGMIN_LAM_STEPS = 26

LOOP_EFFORT = dict(outer_iters=10, inner_iters=3, final_inner_iters=5)
FULL_EFFORT = dict(outer_iters=16, inner_iters=6, final_inner_iters=20)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel_name: str, reps: int = 20):
    """Mean device milliseconds per launch of the kernel whose name holds
    ``kernel_name``, from torch.profiler; None if the trace holds no device
    time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fill_steps(effort: dict, bandwidth: bool) -> tuple[int, int]:
    """(bisection steps per FCFS camera, dual evaluations) of one
    water-fill at ``effort``."""
    o, i, f = (effort["outer_iters"], effort["inner_iters"],
               effort["final_inner_iters"])
    steps = 2 * (i + 4) + o * i + f + (ARGMIN_LAM_STEPS if bandwidth else 0)
    return steps, o + 3


def fill_ops(pol, effort: dict, modes) -> float:
    n_l = int(pol.sum())
    n_f = pol.numel() - n_l
    ops = 0.0
    for bandwidth in modes:
        steps, evals = fill_steps(effort, bandwidth)
        ops += (n_f * steps * OPS_FCFS_STEP + n_l * evals * OPS_LCFSP_EVAL +
                pol.numel() * evals * OPS_CAMERA_EVAL)
    return ops


def assert_close(name, got, want, rtol, atol):
    import numpy as np
    g, w = got.cpu().numpy(), want.cpu().numpy()
    err = np.abs(g - w)
    bad = err > atol + rtol * np.abs(w)
    if bad.any() or not np.isfinite(g).all():
        raise AssertionError(f"{name}: {int(bad.sum())} of {g.size} outside "
                             f"rtol={rtol} atol={atol}; max abs err "
                             f"{err.max():.3e}")
    return float((err / np.maximum(np.abs(w), 1e-30)).max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(n, s, seed, dev, budget_scale=1.0, lcfsp_frac=None,
                  server_id=None):
    """Slot-solver inputs from the paper pool (M=9, R=6) at the paper's
    per-camera share (30 cameras on 3 servers), scaled by budget_scale."""
    import numpy as np
    import torch
    from repro_torch.core import profiles
    share = n / (10.0 * s)
    tab = profiles.EdgeSystem(n_cameras=n, n_servers=s, n_slots=1,
                              mean_bandwidth_hz=30e6 * share * budget_scale,
                              mean_compute_flops=50e12 * share *
                              budget_scale, seed=seed).horizon(1, device=dev)
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    sid = rng.integers(0, s, n) if server_id is None else server_id
    sid = torch.as_tensor(np.asarray(sid, np.int32), device=dev)
    r = torch.as_tensor(rng.integers(0, 6, n), device=dev)
    m = torch.as_tensor(rng.integers(0, 9, n), device=dev)
    pol = (rng.random(n) < (0.5 if lcfsp_frac is None else lcfsp_frac))
    xi_nm = tab.xi[m, r]
    bb, bc = tab.budgets_b[0], tab.budgets_c[0]
    per_cam = s / n                  # one camera's share of a server
    return dict(
        acc=tab.acc[0], xi=tab.xi, size=tab.size, eff=tab.eff, sid=sid,
        bb=bb, bc=bc,
        b=f32(rng.uniform(0.3, 3.0, n)) * bb.mean() * per_cam,
        c=f32(rng.uniform(0.3, 3.0, n)) * bc.mean() * per_cam,
        k=tab.eff / tab.size[r], p=tab.acc[0][torch.arange(n, device=dev),
                                              m, r].contiguous(),
        pol=torch.as_tensor(pol.astype(np.int32), device=dev),
        mu=f32(rng.uniform(0.3, 3.0, n)) * (bc.mean() * per_cam / xi_nm),
        inv_xi=1.0 / xi_nm, s=s, n=n)


def fill_calls(d, effort, layout):
    """The three water-fill calls (kernel wrappers and plain versions) on
    one input set: {name: (kernel thunk, plain thunk, atol pair)}."""
    from repro_torch.core import allocate
    from repro_torch.kernels.slot_solver import ops
    s = d["s"]
    bw = (d["k"], d["p"], d["pol"], d["mu"], d["sid"], d["bb"], s)
    lam = d["b"] * d["k"]
    cp = (d["inv_xi"], d["p"], d["pol"], lam, d["sid"], d["bc"], s)
    pair = (d["k"], d["p"], d["pol"], d["mu"], d["inv_xi"], d["sid"],
            d["bb"], d["bc"], s)
    return {
        "waterfill(bandwidth)": (
            lambda: (ops.waterfill_bandwidth(*bw, layout=layout, **effort),),
            lambda: (allocate.waterfill_bandwidth(*bw, **effort),), (1e-2,)),
        "waterfill(compute)": (
            lambda: (ops.waterfill_compute(*cp, layout=layout, **effort),),
            lambda: (allocate.waterfill_compute(*cp, **effort),), (1e4,)),
        "waterfill_pair": (
            lambda: ops.waterfill_pair(*pair, layout=layout, **effort),
            lambda: allocate.waterfill_pair(*pair, **effort), (1e-2, 1e4)),
    }


def check_kernels(d, label, timing: bool):
    """Hold the three kernels against their plain versions on one input
    set: config_argmin bitwise, the water-fills at rtol=2e-4 at the full
    solver effort (the bar tests/test_slot_solver.py holds Pallas to).
    With ``timing``, also time kernel and plain version at the BCD loop's
    effort and report their agreement there. Returns {kernel: results}."""
    import numpy as np
    import torch
    from repro_torch.kernels.slot_solver import ops, ref
    q = torch.tensor(1.3, device=d["b"].device)
    v = 10.0
    n, s = d["n"], d["s"]
    out = {}

    cfg_args = (d["b"], d["c"], d["acc"], d["xi"], d["size"], d["eff"], q,
                v, n)
    got = ops.config_argmin(*cfg_args)
    want = ref.config_argmin_ref(*cfg_args)
    mismatches = int(sum((a != b).sum().item() for a, b in zip(got, want)))
    if mismatches:
        raise AssertionError(f"config_argmin {label}: {mismatches} index "
                             "mismatches against the plain version")
    out["config_argmin"] = dict(max_abs_err=0.0)

    layout = ops.server_layout(d["sid"], s)
    errs = {}
    for name, (kern, plain, atols) in fill_calls(d, FULL_EFFORT,
                                                  layout).items():
        rel, ab = 0.0, 0.0
        for g, w, atol in zip(kern(), plain(), atols):
            rel = max(rel, assert_close(f"{name} {label}", g, w, 2e-4, atol))
            ab = max(ab, float((g - w).abs().max()))
        errs[name] = (ab, rel)
    torch.cuda.synchronize()
    out["waterfill"] = dict(
        max_abs_err=max(errs["waterfill(bandwidth)"][0],
                        errs["waterfill(compute)"][0]),
        max_rel_err=max(errs["waterfill(bandwidth)"][1],
                        errs["waterfill(compute)"][1]))
    out["waterfill_pair"] = dict(max_abs_err=errs["waterfill_pair"][0],
                                 max_rel_err=errs["waterfill_pair"][1])
    log(f"  {label}: config_argmin 0 mismatches; waterfill rel err "
        f"{out['waterfill']['max_rel_err']:.2e}; waterfill_pair rel err "
        f"{out['waterfill_pair']['max_rel_err']:.2e} (full effort)")
    if not timing:
        return out

    calls = fill_calls(d, LOOP_EFFORT, layout)
    for name, (kern, plain, _) in calls.items():
        g = torch.cat(kern()).cpu().numpy()
        w = torch.cat(plain()).cpu().numpy()
        rel = np.abs(g - w) / np.abs(w)
        log(f"  {label} {name} at loop effort: max rel err {rel.max():.2e}, "
            f"{(rel <= 2e-4).mean() * 100:.3f}% of cameras within 2e-4")
    m_r = d["acc"].shape[1] * d["acc"].shape[2]
    out["config_argmin"].update(
        ms=cuda_ms(lambda: ops.config_argmin(*cfg_args)),
        device_ms=device_ms(lambda: ops.config_argmin(*cfg_args),
                            "config_argmin_kernel"),
        plain_ms=cuda_ms(lambda: ref.config_argmin_ref(*cfg_args)),
        bytes=4 * (3 * n + n * m_r + m_r + d["acc"].shape[2] + 1 + 3 * n),
        ops=n * m_r * OPS_CONFIG_ITEM)
    kern, plain, _ = calls["waterfill(bandwidth)"]
    out["waterfill"].update(
        ms=cuda_ms(kern), device_ms=device_ms(kern, "waterfill_kernel"),
        plain_ms=cuda_ms(plain, reps=20, warmup=1),
        bytes=4 * (5 * n + 2 * s + n) + 4 * n,
        ops=fill_ops(d["pol"], LOOP_EFFORT, (True,)))
    kern, plain, _ = calls["waterfill_pair"]
    out["waterfill_pair"].update(
        ms=cuda_ms(kern), device_ms=device_ms(kern, "waterfill_pair_kernel"),
        plain_ms=cuda_ms(plain, reps=20, warmup=1),
        bytes=4 * (6 * n + 4 * s) + 8 * n,
        ops=fill_ops(d["pol"], LOOP_EFFORT, (True, False)))
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
        dev = ("not measured" if r["device_ms"] is None
               else f"{r['device_ms']:.4f} ms")
        log(f"  {label} {name}: {r['ms']:.4f} ms per wrapper call (CUDA "
            f"events), {dev} on the device (profiler), {r['plain_ms']:.4f} "
            f"ms plain, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# Phase 3: end to end
# ---------------------------------------------------------------------------

def contract(name, run_k, run_p):
    """tests/test_slot_solver.py's backend contract between two runs:
    identical assignments on >= 75% of slots, per-camera AoPI rtol=1e-3 on
    those slots, slot-mean AoPI rtol=5e-3, q rtol=1e-3."""
    import numpy as np
    same = np.array([np.array_equal(a.assign, b.assign)
                     for a, b in zip(run_k.records, run_p.records)])
    diff_cams = [int((a.assign != b.assign).sum())
                 for a, b in zip(run_k.records, run_p.records)]
    log(f"  {name}: identical assignment on {int(same.sum())}/{same.size} "
        f"slots (cameras placed differently per slot: {diff_cams})")
    if same.mean() < 0.75:
        raise AssertionError(f"{name}: identical assignment on only "
                             f"{same.mean():.2f} of slots")
    for t in np.flatnonzero(same):
        np.testing.assert_allclose(run_k.records[t].aopi,
                                   run_p.records[t].aopi, rtol=1e-3,
                                   err_msg=f"{name} slot {t}")
    np.testing.assert_allclose(run_k.aopi_series, run_p.aopi_series,
                               rtol=5e-3, err_msg=name)
    np.testing.assert_allclose(run_k.q_series, run_p.q_series, rtol=1e-3,
                               atol=1e-4, err_msg=name)
    for rec in run_k.records:
        if not np.isfinite(rec.aopi).all() or (rec.aopi <= 0).any():
            raise AssertionError(f"{name}: non-finite AoPI at slot {rec.t}")
    return float(np.max(np.abs(run_k.aopi_series / run_p.aopi_series - 1)))


def run_controller(system_kw, n_slots, backend, dev):
    import torch
    from repro_torch.core import lbcd, profiles
    ctl = lbcd.LBCDController(profiles.EdgeSystem(**system_kw), v=10.0,
                              p_min=0.7, solver_backend=backend, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = ctl.run(n_slots)
    torch.cuda.synchronize()
    return summary, time.perf_counter() - t0


def split_times(system_kw, n_slots, dev):
    """Per-slot host time of the virtual solve, first-fit and per-server
    solve (synchronised after each), default backend."""
    import torch
    from repro_torch.core import bcd, binpack, profiles
    tab = profiles.EdgeSystem(**system_kw).horizon(n_slots, device=dev)
    n = tab.n_cameras
    virt_id = torch.zeros(n, dtype=torch.int32, device=dev)
    q = torch.zeros((), device=dev)
    split = {"virtual_solve": 0.0, "first_fit": 0.0, "server_solve": 0.0}
    for t in range(n_slots):
        bb, bc = tab.budgets_b[t], tab.budgets_c[t]
        t0 = time.perf_counter()
        virt = bcd.solve_slot(tab.acc[t], tab.xi, tab.size, tab.eff, virt_id,
                              bb.sum().reshape(1), bc.sum().reshape(1), q,
                              10.0, n_servers=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        assign = binpack.first_fit_torch(virt.b, virt.c, bb, bc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bcd.solve_slot(tab.acc[t], tab.xi, tab.size, tab.eff, assign, bb, bc,
                       q, 10.0, n_servers=tab.n_servers)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split["virtual_solve"] += (t1 - t0) / n_slots
        split["first_fit"] += (t2 - t1) / n_slots
        split["server_solve"] += (t3 - t2) / n_slots
    return split


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.slot_solver import kernel, ops

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"== phase 1: card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build("slot_solver", kernel.SOURCES)
    kernel.load()
    log(f"  build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    log_path = lib_path.with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")

    log("== phase 2: kernels vs plain versions on the card")
    small = check_kernels(kernel_inputs(30, 3, 0, dev), "N=30 S=3",
                          timing=True)
    big = check_kernels(kernel_inputs(10_000, 32, 1, dev), "N=10000 S=32",
                        timing=True)
    virt = check_kernels(kernel_inputs(10_000, 1, 3, dev,
                                       server_id=[0] * 10_000),
                         "N=10000 S=1", timing=True)
    check_kernels(kernel_inputs(9, 3, 4, dev,
                                server_id=[0, 0, 0, 2, 2, 0, 2, 0, 2]),
                  "empty server", timing=False)
    check_kernels(kernel_inputs(6, 6, 5, dev, server_id=list(range(6))),
                  "single-camera servers", timing=False)
    check_kernels(kernel_inputs(8, 2, 6, dev, budget_scale=300.0,
                                lcfsp_frac=0.0),
                  "slack budget", timing=False)
    check_kernels(kernel_inputs(1001, 7, 7, dev), "ragged N=1001 S=7",
                  timing=False)

    log("== phase 3: end to end")
    n, s = 10_000, 32
    share = n / (10 * s)
    big_sys = dict(n_cameras=n, n_servers=s, n_slots=8,
                   mean_bandwidth_hz=30e6 * share,
                   mean_compute_flops=50e12 * share, seed=0)
    ops.reset_launches()
    run_k, sec_k = run_controller(big_sys, 8, "auto", dev)
    main_launches = dict(ops.launches)
    log(f"  N=10000 S=32 T=8 default backend: {sec_k:.2f} s, "
        f"{8 / sec_k:.3f} slots/s, launches {main_launches}")
    run_p, sec_p = run_controller(big_sys, 8, "torch", dev)
    log(f"  N=10000 S=32 T=8 plain (torch) backend: {sec_p:.2f} s, "
        f"{8 / sec_p:.3f} slots/s")
    err_big = contract("N=10000 rollout vs plain", run_k, run_p)
    split = split_times(big_sys, 2, dev)
    log("  per-slot split (default backend, s): " +
        ", ".join(f"{k} {v:.4f}" for k, v in split.items()))

    paper = dict(n_cameras=30, n_servers=3, n_slots=25, seed=0)
    ops.reset_launches()
    run_n, sec_n = run_controller(paper, 25, "auto:nofuse", dev)
    nofuse_launches = dict(ops.launches)
    log(f"  N=30 S=3 T=25 auto:nofuse: {sec_n:.2f} s, {25 / sec_n:.2f} "
        f"slots/s, launches {nofuse_launches}")
    ops.reset_launches()
    run_f, sec_f = run_controller(paper, 25, "auto", dev)
    log(f"  N=30 S=3 T=25 auto (fused): {sec_f:.2f} s, {25 / sec_f:.2f} "
        f"slots/s, launches {dict(ops.launches)}")
    run_pp, sec_pp = run_controller(paper, 25, "torch", dev)
    log(f"  N=30 S=3 T=25 plain (torch): {sec_pp:.2f} s, "
        f"{25 / sec_pp:.2f} slots/s")
    err_paper = contract("N=30 nofuse vs plain", run_n, run_pp)
    log(f"  slot-mean AoPI max rel diff vs plain: N=10000 {err_big:.2e}, "
        f"N=30 {err_paper:.2e}; mean AoPI N=10000 {run_k.mean_aopi:.5f} s, "
        f"N=30 {run_n.mean_aopi:.5f} s; mean accuracy N=10000 "
        f"{run_k.mean_acc:.4f}")

    counts = {"config_argmin": main_launches["config_argmin"],
              "waterfill_pair": main_launches["waterfill_pair"],
              "waterfill": nofuse_launches["waterfill"]}
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    log(f"  launches per slot: config_argmin "
        f"{counts['config_argmin'] / 8:g}, waterfill_pair "
        f"{counts['waterfill_pair'] / 8:g} (N=10000 run); waterfill "
        f"{counts['waterfill'] / 25:g} (N=30 nofuse run)")
    if "jax" in sys.modules or any(m.split(".")[0] == "repro"
                                   for m in sys.modules):
        raise AssertionError("chip_smoke imported jax or repro")

    src = "src/repro_torch/kernels/slot_solver/csrc/slot_solver.cu"
    replaces = {
        "config_argmin": "src/repro/kernels/slot_solver/kernel.py:118",
        "waterfill": "src/repro/kernels/slot_solver/kernel.py:259",
        "waterfill_pair": "src/repro/kernels/slot_solver/kernel.py:333",
    }
    timed = {"config_argmin": big["config_argmin"],
             "waterfill_pair": big["waterfill_pair"],
             "waterfill": small["waterfill"]}
    kernels = []
    for name in ("config_argmin", "waterfill", "waterfill_pair"):
        r = timed[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces[name],
            launches=counts[name],
            max_abs_err=max(x[name]["max_abs_err"] for x in (small, big,
                                                             virt)),
            ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    log("  timed shapes: config_argmin and waterfill_pair at N=10000 S=32 "
        "(loop effort), waterfill at N=30 S=3 (bandwidth, loop effort); "
        "virtual-server pair at N=10000 S=1: "
        f"{virt['waterfill_pair']['ms']:.4f} ms")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
