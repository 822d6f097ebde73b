#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

  1. card     - nvidia-smi name/power limit, torch/CUDA versions, nvcc builds
                of the six kernel libraries (slot solver, flash attention,
                flash decode, mlstm_chunkwise, selective_scan, data plane)
                from the sources in this checkout, in parallel;
  2. kernels  - each CUDA kernel against its plain PyTorch version on the
                card at the main paths' shapes and at edge cases, with
                CUDA-event and profiler times: config_argmin and
                baseline_argmax index-bitwise (on planted exact ties too:
                ref.tied_scan_inputs), timed with the L2 warm and after a
                128 MB read, with the lanes the library launches and an
                issue floor from the SASS of their entry loops
                (cuobjdump), config_argmin also at N=30; waterfill,
                waterfill_pair
                and waterfill_tiled bitwise (N=30, N=10,000 at S=1 and
                S=32, N=100,000 at S=1 and S=32, edge cases, teams of 2,
                16 and 128 CTAs), each
                water-fill's team (G CTAs of T threads, how they meet),
                registers and spills printed;
                flash_attention and flash_decode at tests/test_kernels.py's
                sweep shapes and at qwen2.5-3b's widths in f32 and bf16
                (2e-5 / 5e-2; bf16 at qwen2.5-3b's widths also against the
                f32 plain version at 1e-5 + 1e-2 * |want|), ragged kv_len
                including 1, t and 0 (zeros) and lengths on and beside the
                split boundaries (flash_decode also at jamba's widths; its
                device time is per wrapper call, split and combine passes
                summed),
                each timed beside its plain version and one
                scaled_dot_product_attention call (library_ms);
                flash_attention's tilings as the library reports them, its
                registers and spills from the build's ptxas report, and its
                device time against two bounds, the f32 CUDA cores' and
                3xTF32 on the tensor cores';
                mlstm_chunkwise at tests/test_kernels.py's sweep shapes in
                f32 and bf16 (2e-3 + 1e-3 * |want| / 5e-2) and at
                xlstm-1.3b's widths (h=4, d=1024, s = 6, 2048, 3072) in
                f32, timed beside its plain version (no single PyTorch
                call computes it: library_ms is null) against two bounds,
                the f32 CUDA cores' and 3xTF32 on the tensor cores';
                selective_scan at tests/test_kernels.py's sweep shapes and
                at jamba's widths (b=1, inner 16384, n 16, s = 6, 2048,
                3072), with and without h0, in f32 (y and h_last within
                1e-4 + 1e-4 * |want|, h_last bitwise the plain version's
                and y bitwise the plain version of the kernel's order,
                selective_scan_lanes_ref, at the lanes the library reports,
                printed with its registers) and bf16 (y and h_last bitwise the
                bf16 rounding of the kernel's own f32 run on the same
                inputs, y within one bf16 rounding plus the f32 atol, 2^-8
                * |want| + 1e-4, of the f32 plain version), timed beside
                its plain version (library_ms null); the two data-plane
                kernels: gi_g1_window (every delay family at 640 frames,
                f32, and 1,280, f64; bitwise but lognormal, within 1e-12)
                and at a sweep cell's window (16 epochs x 16 streams,
                20,480 frames, f64, bitwise, timed beside the plain loop),
                timed alone at the service's window (8 x 30, 65,536) and
                the sweep's commonest (10 x 16, 200,000); tick_scan (every
                family at 512 ticks with the trace, bitwise against the
                plain scan on the card and on the CPU) and at the engine
                rung's shortest epoch (30 streams, 28,672 ticks, bitwise,
                timed beside the plain scan), timed alone at its commonest
                (49,152 ticks, the host draws timed apart); one-lane runs
                of both (chain floors);
  3. end to end - each path driven through its entry point with the launch
                counters zeroed just before and read just after, against the
                plain (solver_backend="torch") run on the card:
                LBCDController at N=10,000 on S=32 (T=2) and with
                "auto:tile=256" (T=2), the paper setting (N=30, S=3, T=25)
                with ":nofuse", MIN (T=2) and JCAB (T=4) at N=100,000 on
                S=32, DOS at N=10,000 (T=2), EnergyAwareLBCD in the paper
                setting with the energy queue z > 0 (its plain run held
                over the first 3 slots); MIN, DOS and JCAB must equal the
                plain run, LBCD and energy meet the rollout contract; every
                kernel's launch counter must be > 0. The plain runs replay
                CUDA graphs of the plain solve (bcd.replay_graph). One
                slot each of MIN and JCAB at N=100,000 is profiled (device
                time by kernel, device busy share);
  4. LM serving - qwen2.5-3b at full width and depth (36 layers, f32
                parameters from a seeded torch.Generator, 13.6 GB) served by
                repro_torch.serving.Engine (8 lanes, 4096-row caches):
                (a) measure_engine_epoch over 8 streams of 8 frames, half
                FCFS and half LCFSP (the service's engine rung), a liveness and
                plane-parity check: its statistics come from the host draws
                and event loop, so they must equal the same epoch on the
                replay engine, but they do not see the tokens; (b) 8 admits of
                512-3,072-token prompts and 64 decode ticks, timed, then
                held teacher-forced against the same engine built with
                impl="torch": logits within atol 2e-3 at every step and the
                share of identical argmax tokens >= 0.99. Both attention
                kernels must launch in (a) and in (b), 36 times per admit
                (flash_attention) and per tick (flash_decode). Also
                measured: the share of a 3,072-token admit spent in the
                36 flash_attention calls. Then the serving launcher's
                service (launch.serve.build_service, --engine) over an
                Engine of these parameters: 8 streams, 2 epochs of 3 s,
                frame cap 4, both attention kernels launching;
  5. xLSTM serving - xlstm-1.3b at full width and depth (48 layers: 6
                periods of 7 mLSTM and 1 sLSTM, f32 parameters from a
                seeded torch.Generator, 7.94 GB; qwen2.5-3b's freed first),
                the same (a) and (b) as phase 4 with logits within 0.1
                (see LOGIT_ATOL), then one period (8 layers) of the same
                weights teacher-forced within 1e-3 and the plain run's
                response to a one-ulp change of its input embedding (its
                logits over one lane, and its share of identical argmax
                tokens against the plain engine, teacher-forced as in (b):
                what rounding alone leaves of the 0.99 bar);
                mlstm_chunkwise must launch in (a) and in (b), 42 times per
                admit and never in a tick. Also measured: the share of an
                admit spent in the sLSTM's per-token loop and in the mLSTM
                kernel, and of a tick in the mLSTM state step.
  6. hybrid serving - jamba-1.5-large-398b at full width, cut to one period
                (8 layers: 1 attention and 7 Mamba, 4 MoE and 4 dense FFNs)
                and 4 of its 16 experts (top-2, capacity factor 1.25 kept;
                16.25 B f32 parameters, 64.99 GB from a seeded
                torch.Generator, xlstm-1.3b's freed first), the same (a) and
                (b) as phase 4 with logits within 2e-3; selective_scan must
                launch 7 times per admit and never in a tick,
                flash_attention once per admit and flash_decode once per
                tick. The teacher-forced check also counts the top-2
                routing decisions that differ between the two engines and
                their gate gaps. Also measured: the share of an admit spent
                in the 7 scans and in the 4 MoE layers, and of a tick in
                the Mamba decode steps and the MoE layers.
  7. scenario sweep - repro_torch.scenarios.suite() at its own size but
                the horizon (11 scenarios, N=30, S=3, T=60 of its 200)
                swept by LBCD, MIN, DOS and
                JCAB (solver_backend="auto") with obs streaming to a
                temporary run directory, each policy with the launch
                counters zeroed just before and read just after: seconds
                and scenario-slots/s, launches by kernel (each kernel of
                the policy's path must launch, and obs.dispatch.count must
                equal the launches), the scenarios that took the masked
                path (camera_churn, camera_churn_heavy: plain solves for
                LBCD and MIN, replayed as CUDA graphs); finite series and
                no failed policy; four sweep.policy spans and one
                sweep.aopi histogram per (policy, family); the robustness
                table; bcd.solve_slot ranges in a profiled LBCD slot; the
                four obs artefacts read back by repro_torch.obs.report;
                the graph replay of the plain solve against the eager
                plain solve, exactly, on LBCD's and MIN's solves of
                camera_churn, camera_churn_heavy and steady_ar1 at the
                suite's size (the sweep's parity cannot see it: both of
                its sweeps replay the same graphs for the masked solves);
                the suite cut to 6 slots, kernel series equal to the
                plain (solver_backend="torch") series exactly; the LBCD
                sweep of the scenarios that run on the kernels, cut to 10
                slots, in 6 pairs with obs off and on (order alternating):
                medians, quartiles and the median on/off ratio; the cost
                of one obs span and one dispatch count timed alone
                (20,000 calls each), and their share of a kernel LBCD
                slot.
  8. data plane - the launch counters zeroed just before and read just
                after, the data plane's main path:
                AnalyticsService(LBCDController(EdgeSystem(30, 3, seed=0)),
                epoch_duration=300) for 16 epochs with delay_model="auto"
                and telemetry_gain=0.3, and again with mode="engine" on the
                scan backend; scenarios.sweep(suite(n_cameras=16,
                n_slots=60, n_servers=3), dataplane=True, 16 replayed 600 s
                epochs) per policy, timed; both kernels must launch, every
                series be finite, no plan fail or fall back to a rung of the
                degradation ladder, and measured AoPI lie within 15% of the
                closed form over each run's horizon (every replayed cell).
  9. the rest of core/, failover and the launcher -
                (a) LBCDController(method="interior") at the paper setting
                (N=30, S=3, 25 slots): slots/s (two CUDA graphs of the
                interior solve captured, then replayed; a second run on the
                captured graphs), no slot-solver launch, the graph replays
                of both solves of the first 4 slots equal to the eager
                solve exactly, its mean AoPI and the water-fill LBCD's
                each within 5e-3 of repro's own runs of this system (their
                ratio, 0.76 in repro too, reported), q finite,
                solver_backend="cuda" refused; (b)
                min_lam_for_target and min_mu_for_target over 4 targets x
                8 rates x both policies in one call each, every reachable
                point's AoPI within 1e-2 of its target, LCFSP min_lam
                non-increasing in mu, FCFS min_mu with an interior minimum
                in lam; (c) training.failure.failover_assignment with
                island 1 dead at slot 3 on an "auto" controller
                (config_argmin, waterfill_pair) equal bitwise to the same
                call on a "torch" one, no stream on island 1, capacities
                restored; (d) launch.serve.main at its CLI defaults (mm1,
                16 streams, 8 epochs of 1,200 s; measured within 15% of
                predicted) and with --engine --streams 2 (reduced
                qwen2.5-3b, 8 epochs of 3 s, the event-driven plane; both
                attention kernels must launch), tables and wall seconds
                printed.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``name, power.limit``, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, FP32 outside the
# tensor cores, dense TF32 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12

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
# One (camera, model, resolution) entry of baseline_argmax: two rates, two
# clamps, two reciprocals and a sum (latency), the score, two folds.
OPS_BASELINE_ITEM = 11

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


def kernel_name(key: str) -> str:
    """The function's name in a profiler key, e.g. ``flash_decode_kernel``
    in ``void (anonymous namespace)::flash_decode_kernel<float>(...)``."""
    key = key.replace("(anonymous namespace)::", "")
    return re.match(r"(?:void\s+)?(?:\w+::)*(\w*)", key).group(1)


def device_ms(fn, kernels, reps: int = 20, passes=None):
    """Device milliseconds per call of ``fn``: the mean time per launch of
    each kernel named in ``kernels`` (exact names; one name or a tuple, as
    flash_decode's split and combine passes, each launched once per call),
    summed, from torch.profiler. Profiler keys with no device time are
    skipped, so they do not enter the launch count the mean divides by.
    Raises if two keys hold one listed name (two
    instantiations) or a kernel whose name starts as a listed one's does
    (its stem, the name without ``_kernel``) is not listed. None if the
    trace holds device time for none or only some of the listed kernels.
    ``passes``, a dict, is filled with each kernel's ms per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    stems = tuple(n.removesuffix("_kernel") for n in names)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        if not evt.count or us <= 0:
            continue
        name = kernel_name(evt.key)
        if name in names:
            if name in found:
                raise AssertionError(f"device_ms: two profiler keys hold "
                                     f"{name}: {evt.key!r}")
            found[name] = us / evt.count / 1e3
        elif name.startswith(stems):
            raise AssertionError(f"device_ms: kernel {name} ({evt.key!r}) "
                                 f"is not among {names}")
    if passes is not None:
        passes.update(found)
    return sum(found.values()) if len(found) == len(names) else None


def build_usage(name, kernel_mod, flags, entry, labels):
    """Registers and spill bytes of each instantiation of ``entry`` in the
    built library's ptxas report, one string per instantiation, labelled
    by every value of ``labels`` ({substring of the mangled name: label})
    whose key its name holds."""
    from repro_torch.kernels import _build
    log_path = _build.build(name, kernel_mod.SOURCES, flags).with_suffix(
        ".log")
    out = []
    for mangled, u in _build.ptxas_usage(log_path, entry).items():
        label = " ".join(v for k, v in labels.items() if k in mangled)
        out.append(f"{label}: {u.get('registers')} registers, "
                   f"{u.get('spill_stores', 0)} B spill stores, "
                   f"{u.get('spill_loads', 0)} B spill loads")
    return out


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


# Hopper issues one warp instruction per clock in each of an SM's four
# partitions; a partition's special-function unit takes 8 clocks per warp
# MUFU instruction (16 results per clock per SM).
ISSUE_PER_SM = 4
MUFU_CLOCKS = 8
L2_FLUSH_BYTES = 128 << 20       # read between launches: > the 50 MB L2
_FLUSH = {}


def l2_flushed(fn, dev):
    """``fn`` after a read of L2_FLUSH_BYTES, so it finds its inputs out of
    the L2, as the first launch of a slot finds a new slot's table. A read,
    not a write: a write would leave the L2 full of dirty lines, whose
    write-back (~40 MB) the timed kernel would then pay. The read is its
    own kernel: device_ms of ``fn``'s kernel leaves it out."""
    import torch
    if dev not in _FLUSH:
        _FLUSH[dev] = (torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                                  device=dev),
                       torch.empty((), dtype=torch.float32, device=dev))

    def call():
        buf, out = _FLUSH[dev]
        torch.sum(buf, 0, out=out)
        return fn()
    return call


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def sass_entry_loops(lib_path, kernel):
    """The per-entry loops of ``kernel`` in the built library's SASS
    (``cuobjdump -sass``), smallest first: each backward branch whose body
    holds a MUFU and stores nothing (the scans' entry loops, one entry an
    iteration: ``#pragma unroll 1``), as {"instructions": those on the
    fast path (a division's slow-path call, which its branch skips, left
    out), "mufu": MUFU instructions, "static": all}. None where the
    toolkit has no cuobjdump."""
    import shutil
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        tool = shutil.which("cuobjdump")
        if tool is None:
            return None
    dump = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    return sass_loops(dump, kernel)


def sass_loops(dump, kernel):
    """sass_entry_loops on the text of a ``cuobjdump -sass`` dump."""
    funcs = [f for f in re.split(r"\n\s*Function : ", dump)[1:]
             if kernel in f.split("\n", 1)[0]]
    if not funcs:
        return []
    body = funcs[0]
    ops, where, labels, pending = [], {}, {}, []
    for line in body.splitlines()[1:]:
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            labels.update((name, len(ops)) for name in pending)
            pending = []
            where[int(m.group(1), 16)] = len(ops)
            ops.append(m.group(2))

    def opcode(ins):
        return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]

    def target(ins):
        m = re.search(r"\bBRA\b[^`(0-9]*`?\(?(\.L_x_\d+|0x[0-9a-f]+)", ins)
        if not m:
            return None
        t = m.group(1)
        return labels.get(t) if t.startswith(".") else where.get(int(t, 16))

    loops = []
    for end, ins in enumerate(ops):
        start = target(ins)
        if start is None or start > end:
            continue
        skipped = set()
        for i in range(start, end):
            to = target(ops[i])
            if (ops[i].startswith("@") and to is not None and i < to <= end
                    and any(opcode(x).startswith("CALL")
                            for x in ops[i + 1:to])):
                skipped.update(range(i + 1, to))
        live = [opcode(ops[i]) for i in range(start, end + 1)
                if i not in skipped]
        mufu = sum(op.startswith("MUFU") for op in live)
        if mufu and not any(op.startswith("ST") for op in live):
            loops.append(dict(instructions=len(live), mufu=mufu,
                              static=end - start + 1))
    return sorted(loops, key=lambda x: x["instructions"])


def issue_floor_ms(n, n_mr, lanes, loop, sms, clock_mhz):
    """The least time the card takes to issue a scan's entry loop: each
    warp of 32 / ``lanes`` live cameras runs ceil(n_mr / lanes) iterations
    of ``loop`` (sass_entry_loops), each taking the larger of its
    instructions (one a clock per partition) and its MUFUs'
    special-function clocks."""
    warps = -(-n // (32 // lanes))
    iters = warps * -(-n_mr // lanes)
    per_iter = max(loop["instructions"], MUFU_CLOCKS * loop["mufu"])
    return iters * per_iter / (ISSUE_PER_SM * sms) / (clock_mhz * 1e3)


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
    one input set: {name: (kernel thunk, plain thunk)}."""
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
            lambda: (allocate.waterfill_bandwidth(*bw, **effort),)),
        "waterfill(compute)": (
            lambda: (ops.waterfill_compute(*cp, layout=layout, **effort),),
            lambda: (allocate.waterfill_compute(*cp, **effort),)),
        "waterfill_pair": (
            lambda: ops.waterfill_pair(*pair, layout=layout, **effort),
            lambda: allocate.waterfill_pair(*pair, **effort)),
    }


def check_kernels(d, label, timing: bool):
    """Hold the three kernels against their plain versions on one input
    set, bitwise (``torch.equal``): config_argmin's indices, the
    water-fills at the full solver effort and, with ``timing``, at the BCD
    loop's effort too, where both are also timed. Returns {kernel:
    results}."""
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
    efforts = (FULL_EFFORT, LOOP_EFFORT) if timing else (FULL_EFFORT,)
    for effort in efforts:
        for name, (kern, plain) in fill_calls(d, effort, layout).items():
            for g, w in zip(kern(), plain()):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{name} {label}: {int((g != w).sum())} of "
                        f"{g.numel()} differ from the plain version at "
                        f"{effort}; max abs err "
                        f"{float((g - w).abs().max()):.3e}")
    torch.cuda.synchronize()
    out["waterfill"] = dict(max_abs_err=0.0)
    out["waterfill_pair"] = dict(max_abs_err=0.0)
    log(f"  {label}: config_argmin 0 mismatches; waterfill and "
        "waterfill_pair bitwise equal to the plain versions ("
        + " and ".join("full" if e is FULL_EFFORT else "loop"
                       for e in efforts) + " effort)")
    if not timing:
        return out

    calls = fill_calls(d, LOOP_EFFORT, layout)
    m_r = d["acc"].shape[1] * d["acc"].shape[2]
    out["config_argmin"].update(
        ms=cuda_ms(lambda: ops.config_argmin(*cfg_args)),
        device_ms=device_ms(lambda: ops.config_argmin(*cfg_args),
                            "config_argmin_kernel"),
        cold_device_ms=device_ms(l2_flushed(
            lambda: ops.config_argmin(*cfg_args), d["b"].device),
            "config_argmin_kernel"),
        plain_ms=cuda_ms(lambda: ref.config_argmin_ref(*cfg_args)),
        bytes=4 * (3 * n + n * m_r + m_r + d["acc"].shape[2] + 1 + 3 * n),
        ops=n * m_r * OPS_CONFIG_ITEM)
    kern, plain = calls["waterfill(bandwidth)"]
    out["waterfill"].update(
        team=team_of(n, s),
        ms=cuda_ms(kern), device_ms=device_ms(kern, "waterfill_kernel"),
        plain_ms=cuda_ms(plain, reps=20, warmup=1),
        bytes=4 * (5 * n + 2 * s + n) + 4 * n,
        ops=fill_ops(d["pol"], LOOP_EFFORT, (True,)))
    kern, plain = calls["waterfill_pair"]
    out["waterfill_pair"].update(
        team=team_of(n, s),
        ms=cuda_ms(kern), device_ms=device_ms(kern, "waterfill_pair_kernel"),
        plain_ms=cuda_ms(plain, reps=20, warmup=1),
        bytes=4 * (6 * n + 4 * s) + 8 * n,
        ops=fill_ops(d["pol"], LOOP_EFFORT, (True, False)))
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
        dev = ("not measured" if r["device_ms"] is None
               else f"{r['device_ms']:.4f} ms")
        team = f", team {r['team']}" if "team" in r else ""
        if "cold_device_ms" in r:
            team += f", {r['cold_device_ms']} ms on the device L2 flushed"
        log(f"  {label} {name}: {r['ms']:.4f} ms per wrapper call (CUDA "
            f"events), {dev} on the device (profiler), {r['plain_ms']:.4f} "
            f"ms plain, bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
            f"{team}")
    return out


def team_of(n, s, group=None):
    """The water-fill team the wrappers launch for n cameras on s servers
    (``group`` pinned, or the host rule's), as "G=.. T=.. sync, CTAs"."""
    import torch
    from repro_torch.kernels.slot_solver import ops
    plan = ops.fill_plan(n, s, torch.cuda.get_device_properties(
        0).multi_processor_count, group=group)
    return (f"G={plan.group} T={plan.threads} {plan.sync}, "
            f"{s * plan.group} CTAs"
            + (" at most (as many teams as co-reside)"
               if plan.sync == "grid" else ""))


def check_tiled(d, label, group, timing: bool):
    """Hold waterfill_tiled (``group`` CTAs per server) against the plain
    water-fills, bitwise, bandwidth and compute, at the full effort; with
    ``timing``, also time it at the BCD loop's effort, and the pair of
    tiled launches a tiled BCD pass makes beside one untiled
    waterfill_pair launch."""
    import torch
    from repro_torch.core import allocate
    from repro_torch.kernels.slot_solver import ops
    s = d["s"]
    layout = ops.server_layout(d["sid"], s)
    bw = (d["k"], d["p"], d["pol"], d["mu"], d["sid"], d["bb"], s)
    cp = (d["inv_xi"], d["p"], d["pol"], d["b"] * d["k"], d["sid"], d["bc"],
          s)

    def tiled(effort):
        return (lambda: ops.waterfill_bandwidth(*bw, layout=layout,
                                                group=group, **effort),
                lambda: ops.waterfill_compute(*cp, layout=layout,
                                              group=group, **effort))

    kb, kc = tiled(FULL_EFFORT)
    for mode, got, want in (
            ("bandwidth", kb(), allocate.waterfill_bandwidth(
                *bw, **FULL_EFFORT)),
            ("compute", kc(), allocate.waterfill_compute(*cp,
                                                         **FULL_EFFORT))):
        if not torch.equal(got, want):
            diff = int((got != want).sum())
            raise AssertionError(
                f"waterfill_tiled({mode}) {label} G={group}: {diff} of "
                f"{got.numel()} differ from the plain version; max abs err "
                f"{float((got - want).abs().max()):.3e}")
    torch.cuda.synchronize()
    log(f"  {label} G={group}: waterfill_tiled bandwidth and compute "
        "bitwise equal to the plain versions (full effort)")
    out = dict(max_abs_err=0.0)
    if not timing:
        return out
    n = d["n"]
    kb, kc = tiled(LOOP_EFFORT)
    for mode, got, want in (
            ("bandwidth", kb(), allocate.waterfill_bandwidth(
                *bw, **LOOP_EFFORT)),
            ("compute", kc(), allocate.waterfill_compute(*cp,
                                                         **LOOP_EFFORT))):
        if not torch.equal(got, want):
            raise AssertionError(f"waterfill_tiled({mode}) {label} "
                                 f"G={group}: differs at the loop effort")
    out.update(
        team=team_of(n, s, group),
        ms=cuda_ms(kb), device_ms=device_ms(kb, "waterfill_tiled_kernel"),
        plain_ms=cuda_ms(lambda: allocate.waterfill_bandwidth(
            *bw, **LOOP_EFFORT), reps=10, warmup=1),
        bytes=4 * (5 * n + 2 * s + n) + 4 * n,
        ops=fill_ops(d["pol"], LOOP_EFFORT, (True,)))
    out["bound_ms"], out["bound_by"] = bound_ms(out["bytes"], out["ops"])
    pair = (d["k"], d["p"], d["pol"], d["mu"], d["inv_xi"], d["sid"],
            d["bb"], d["bc"], s)

    def tiled_pair():
        b = ops.waterfill_bandwidth(*bw, layout=layout, group=group,
                                    **LOOP_EFFORT)
        return ops.waterfill_compute(d["inv_xi"], d["p"], d["pol"],
                                     b * d["k"], d["sid"], d["bc"], s,
                                     layout=layout, group=group,
                                     **LOOP_EFFORT)

    out["pair_ms"] = cuda_ms(tiled_pair)
    out["untiled_pair_ms"] = cuda_ms(lambda: ops.waterfill_pair(
        *pair, layout=layout, **LOOP_EFFORT))
    out["untiled_pair_device_ms"] = device_ms(
        lambda: ops.waterfill_pair(*pair, layout=layout, **LOOP_EFFORT),
        "waterfill_pair_kernel")
    dev = ("not measured" if out["device_ms"] is None
           else f"{out['device_ms']:.4f} ms")
    log(f"  {label} G={group} waterfill_tiled(bandwidth): {out['ms']:.4f} ms "
        f"per wrapper call, {dev} on the device (team {out['team']}), "
        f"{out['plain_ms']:.4f} ms "
        f"plain, bound {out['bound_ms']:.6f} ms ({out['bound_by']}); a "
        f"tiled pass (bandwidth + compute launches) {out['pair_ms']:.4f} ms "
        f"vs one untiled waterfill_pair {out['untiled_pair_ms']:.4f} ms "
        f"({out['untiled_pair_device_ms']} ms on the device)")
    return out


def check_baseline(d, label, mode, threshold, timing: bool):
    """Hold baseline_argmax against its plain version, index-bitwise, on
    the provisional per-camera rates d["b"], d["c"]; with ``timing``, time
    both."""
    import torch
    from repro_torch.kernels.slot_solver import ops, ref
    args = (d["b"], d["c"], d["acc"], d["xi"], d["size"], d["eff"])
    got = ops.baseline_argmax(*args, mode=mode, threshold=threshold)
    want = ref.baseline_argmax_ref(*args, mode=mode, threshold=threshold)
    mismatches = int(sum((a != b).sum().item() for a, b in zip(got, want)))
    if mismatches:
        raise AssertionError(f"baseline_argmax {mode} {label}: {mismatches} "
                             "index mismatches against the plain version")
    torch.cuda.synchronize()
    out = dict(max_abs_err=0.0)
    log(f"  {label}: baseline_argmax {mode} (threshold {threshold:g}) 0 "
        "mismatches")
    if not timing:
        return out
    n, m_r = d["n"], d["acc"].shape[1] * d["acc"].shape[2]

    def kern():
        return ops.baseline_argmax(*args, mode=mode, threshold=threshold)

    out.update(
        ms=cuda_ms(kern), device_ms=device_ms(kern, "baseline_argmax_kernel"),
        cold_device_ms=device_ms(l2_flushed(kern, d["b"].device),
                                 "baseline_argmax_kernel"),
        plain_ms=cuda_ms(lambda: ref.baseline_argmax_ref(
            *args, mode=mode, threshold=threshold)),
        bytes=4 * (3 * n + n * m_r + m_r + d["acc"].shape[2] + 2 * n),
        ops=n * m_r * OPS_BASELINE_ITEM)
    out["bound_ms"], out["bound_by"] = bound_ms(out["bytes"], out["ops"])
    dev = ("not measured" if out["device_ms"] is None
           else f"{out['device_ms']:.4f} ms")
    log(f"  {label} baseline_argmax {mode}: {out['ms']:.4f} ms per wrapper "
        f"call, {dev} on the device (L2 warm; {out['cold_device_ms']} ms "
        f"flushed), {out['plain_ms']:.4f} ms plain, bound "
        f"{out['bound_ms']:.6f} ms ({out['bound_by']})")
    return out


def check_planted_ties(dev):
    """Both scans index-bitwise against their plain versions on inputs
    with exact ties planted (ref.tied_scan_inputs: duplicated models and
    resolutions, b = 0 rows, +-0), 40 and 37 cameras, at config_argmin's
    two (q, V) and baseline_argmax's tie-making thresholds."""
    import torch
    from repro_torch.kernels.slot_solver import ops, ref
    for n, seed in ((40, 0), (37, 1)):
        inputs = ref.tied_scan_inputs(n, seed)
        t = [torch.as_tensor(x, device=dev) for x in inputs]
        for q, v in ((1.3, 10.0), (50.0, 10.0)):
            q_t = torch.tensor(q, device=dev)
            got = ops.config_argmin(*t, q_t, v, n)
            want = ref.config_argmin_ref(*t, q_t, v, n)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"config_argmin planted ties N={n} "
                                     f"q={q}: indices differ")
        cap = ref.tied_jcab_cap(*(inputs[k] for k in (0, 1, 3, 4, 5)))
        for mode, thr in (("dos", 0.0), ("dos", 1.0), ("jcab", 1e-6),
                          ("jcab", cap), ("jcab", 0.5)):
            got = ops.baseline_argmax(*t, mode=mode, threshold=thr)
            want = ref.baseline_argmax_ref(*t, mode=mode, threshold=thr)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"baseline_argmax planted ties N={n} "
                                     f"{mode} {thr}: indices differ")
    torch.cuda.synchronize()
    log("  planted ties (N=40, 37): config_argmin and baseline_argmax "
        "index-bitwise equal to the plain versions")


def scan_floors(lib_path, kernel, cfg, dos, jcab, dev):
    """The two scans' issue floors at their timed shapes (config_argmin
    N=10,000; baseline_argmax N=100,000), from the SASS of the built
    library, into their results, and logged with the entry loops."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_mhz()
    m_r = 9 * 6                        # the paper pool: M x R
    for name, results, n in (("config_argmin", (cfg,), 10_000),
                             ("baseline_argmax", (dos, jcab), 100_000)):
        lanes = kernel.launched_lanes(n)
        if lanes != kernel.scan_lanes(n, sms):
            raise AssertionError(f"{name}: the library launches {lanes} "
                                 f"lanes at N={n}, kernel.scan_lanes "
                                 f"{kernel.scan_lanes(n, sms)}")
        loops = sass_entry_loops(lib_path, f"{name}_kernelILi{lanes}E")
        for r in results:
            r["lanes"] = lanes
        if not loops:
            log(f"  {name}: no SASS entry loop found (cuobjdump: "
                f"{loops is not None}); issue floor not measured")
            continue
        # config_argmin has one entry loop; baseline_argmax one per mode,
        # DOS's the smaller (JCAB also folds the latencies).
        for r, loop in zip(results, loops[-len(results):]):
            r["sass_loop"] = loop
            r["issue_floor_ms"] = issue_floor_ms(n, m_r, lanes, loop, sms,
                                                 clock)
        log(f"  {name} entry loops at {lanes} lanes (SASS, one entry "
            "each): " + ", ".join(
                f"{x['instructions']} instructions on the fast path "
                f"({x['static']} static), {x['mufu']} MUFU" for x in loops)
            + f"; issue floor at N={n}, {sms} SMs at {clock:g} MHz: "
            + ", ".join(f"{r['issue_floor_ms']:.6f} ms" for r in results))


# Attention kernels. Shapes: tests/test_kernels.py's sweeps, then
# qwen2.5-3b's widths (h=16, kvh=2, d=128): a 6-token frame, a
# non-multiple of the tile and a long prompt; decode over 8 lanes of a
# 4096-row cache.
ATTN_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# At qwen2.5-3b's widths the bf16 outputs are small (|out| ~ 0.04 at
# s = t = 2048), so the bf16 runs there are also held against the plain
# version on the same inputs in f32: the kernel accumulates in f32 and
# rounds once to bf16 (at most 2^-8 relative), so atol 1e-5 plus rtol
# 1e-2 leaves room for that rounding and the f32 summation order, and a
# dropped KV tile (a shift of ~10% at s = 2048) fails it.
BF16_TIGHT = (1e-5, 1e-2)
PREFILL_SWEEP = [(2, 256, 256, 4, 2, 64), (1, 128, 384, 8, 8, 128),
                 (2, 256, 256, 4, 1, 128), (1, 192, 192, 6, 2, 64)]
PREFILL_FULL = [(1, s, s, 16, 2, 128) for s in (6, 192, 2048)]
DECODE_SWEEP = [(2, 512, 8, 2, 64), (4, 1024, 4, 4, 128),
                (1, 384, 8, 1, 128), (3, 640, 16, 8, 64)]
DECODE_FULL = (8, 4096, 16, 2, 128)
DECODE_JAMBA = (8, 4096, 64, 8, 128)
# Phase 4's prompt lengths (ragged, 512-3,072 tokens): the cache fill the
# decode timing reads.
PROMPT_LENS = (512, 896, 1280, 1664, 2048, 2432, 2816, 3072)


def normal(shape, dtype, dev, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(getattr(torch, dtype))


def sdpa(q, k, v, mask=None, causal=False):
    """One scaled_dot_product_attention call on the port's [b, s, h, d]
    layout, the KV heads shared by enable_gqa: the library yardstick,
    never used by the port."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal, enable_gqa=True)


def check_attention(dev):
    """Hold flash_attention and flash_decode against their plain versions
    on the card and time both at the main path's shapes. Returns
    {kernel: results}."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    def held(name, got, want, dtype=None, atol=None, rtol=None):
        """Max abs err of got against want; fails outside atol + rtol *
        |want| (ATTN_TOL[dtype] for both unless given)."""
        atol = ATTN_TOL[dtype] if atol is None else atol
        rtol = atol if rtol is None else rtol
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        bad = ((got.float() - want.float()).abs()
               > atol + rtol * want.float().abs())
        if bad.any() or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: {int(bad.sum())} of "
                                 f"{got.numel()} outside {atol} + {rtol} "
                                 f"* |want|; max abs err {err:.3e}")
        return err

    def tight(name, got, want_f32):
        """bf16 kernel output against the f32 plain version on the same
        (bf16-valued) inputs; returns the worst err / |want| share of
        the bar."""
        err = held(name + " vs f32 plain", got, want_f32,
                   atol=BF16_TIGHT[0], rtol=BF16_TIGHT[1])
        d = (got.float() - want_f32).abs()
        return err, float((d / (BF16_TIGHT[0] + BF16_TIGHT[1]
                                * want_f32.abs())).max())

    errs = {}                  # max abs err per (kernel, dtype)
    tight_worst = {"flash_attention": (0.0, 0.0), "flash_decode": (0.0, 0.0)}
    for dtype in ("float32", "bfloat16"):
        worst = {"flash_attention": 0.0, "flash_decode": 0.0}
        for i, (b, s, t, h, kvh, d) in enumerate(PREFILL_SWEEP +
                                                  PREFILL_FULL):
            q = normal((b, s, h, d), dtype, dev, 3 * i)
            k = normal((b, t, kvh, d), dtype, dev, 3 * i + 1)
            v = normal((b, t, kvh, d), dtype, dev, 3 * i + 2)
            name = f"flash_attention {(b, s, t, h, kvh, d)} {dtype}"
            got = fa_ops.attention(q, k, v, causal=True)
            e = held(name, got, fa_ref.mha_ref(q, k, v, causal=True),
                     dtype)
            worst["flash_attention"] = max(worst["flash_attention"], e)
            if dtype == "bfloat16" and (b, s, t, h, kvh, d) in PREFILL_FULL:
                tight_worst["flash_attention"] = max(
                    tight_worst["flash_attention"],
                    tight(name, got, fa_ref.mha_ref(
                        q.float(), k.float(), v.float(), causal=True)),
                    key=lambda r: r[1])
        for i, (b, t, h, kvh, d) in enumerate(DECODE_SWEEP):
            q = normal((b, h, d), dtype, dev, 50 + 3 * i)
            kc = normal((b, t, kvh, d), dtype, dev, 51 + 3 * i)
            vc = normal((b, t, kvh, d), dtype, dev, 52 + 3 * i)
            lens = torch.tensor([t // 2 + 37 * j for j in range(b)],
                                dtype=torch.int32, device=dev)
            e = held(f"flash_decode {(b, t, h, kvh, d)} {dtype}",
                     dec_ops.decode_attention(q, kc, vc, lens),
                     dec_ref.decode_ref(q, kc, vc, lens), dtype)
            worst["flash_decode"] = max(worst["flash_decode"], e)
        for full in (DECODE_FULL, DECODE_JAMBA):
            b, t, h, kvh, d = full
            q = normal((b, h, d), dtype, dev, 70)
            kc = normal((b, t, kvh, d), dtype, dev, 71)
            vc = normal((b, t, kvh, d), dtype, dev, 72)
            # Ragged lanes, empty lanes, and lanes on and beside the
            # boundaries of the split the host plans for this cache.
            chunk = dec_kernel.split_plan(b, t, kvh,
                                          dec_kernel.sm_count(dev))[1]
            for lens in ([1, t, 37, 511, 512, 513, 2048, t - 1],
                         [0, 5, 0, t, 0, 1, 0, 0],
                         [chunk - 1, chunk, chunk + 1, 2 * chunk,
                          3 * chunk - 1, 3 * chunk + 1, t - chunk, 2]):
                kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
                got = dec_ops.decode_attention(q, kc, vc, kv_len)
                name = f"flash_decode {full} kv_len={lens} {dtype}"
                e = held(name, got, dec_ref.decode_ref(q, kc, vc, kv_len),
                         dtype)
                if dtype == "bfloat16" and full == DECODE_FULL:
                    tight_worst["flash_decode"] = max(
                        tight_worst["flash_decode"],
                        tight(name, got, dec_ref.decode_ref(
                            q.float(), kc.float(), vc.float(), kv_len)),
                        key=lambda r: r[1])
                empty = kv_len == 0
                if empty.any() and torch.count_nonzero(got[empty]) != 0:
                    raise AssertionError("flash_decode: kv_len = 0 must "
                                         "give zeros")
                worst["flash_decode"] = max(worst["flash_decode"], e)
        for name, e in worst.items():
            errs[name, dtype] = e
        log(f"  attention kernels {dtype}: flash_attention max abs err "
            f"{worst['flash_attention']:.3e} over "
            f"{len(PREFILL_SWEEP + PREFILL_FULL)} shapes, flash_decode "
            f"{worst['flash_decode']:.3e} over {len(DECODE_SWEEP) + 2} "
            "shapes (qwen2.5-3b's and jamba's with 3 kv_len sets each, "
            "split boundaries included); kv_len = 0 gives zeros")
    for name, (e, share) in tight_worst.items():
        log(f"  {name} bf16 at qwen2.5-3b widths vs the f32 plain version: "
            f"max abs err {e:.3e}, worst element at {share:.3f} of the "
            f"bar {BF16_TIGHT[0]} + {BF16_TIGHT[1]} * |want|")

    out = {}
    # flash_attention at qwen2.5-3b's prefill widths, f32 (the engine's
    # parameter dtype): FLOPs 2*b*h*s*t*d*2, halved when causal. Two
    # bounds: the f32 CUDA cores' (bound_ms, comparable with earlier runs)
    # and that of the unit the kernel uses, 3xTF32 on the tensor cores.
    tilings = {d: fa_kernel.tiling(d) for d in (128, 256)}
    log("  flash_attention tilings: " + "; ".join(
        f"d <= {d}: BQ {t['bq']} ({t['warps']} warps), BK {t['bk']}, "
        f"{t['slots']} ring slots, {t['ahead']} chunks in flight"
        for d, t in tilings.items()))
    for line in build_usage("flash_attention", fa_kernel,
                            _build.ATTENTION_FLAGS, "flash_attention_kernel",
                            {"IfLi": "f32", "bfloat16": "bf16",
                             "Li128E": "d <= 128", "Li256E": "d <= 256"}):
        log(f"  flash_attention_kernel {line}")
    for s in (6, 192, 2048):
        q = normal((1, s, 16, 128), "float32", dev, 80)
        k = normal((1, s, 2, 128), "float32", dev, 81)
        v = normal((1, s, 2, 128), "float32", dev, 82)
        r = dict(
            ms=cuda_ms(lambda: fa_ops.attention(q, k, v)),
            device_ms=device_ms(lambda: fa_ops.attention(q, k, v),
                                "flash_attention_kernel"),
            plain_ms=cuda_ms(lambda: fa_ref.mha_ref(q, k, v)),
            library_ms=cuda_ms(lambda: sdpa(q, k, v, causal=True)),
            bytes=4 * (2 * q.numel() + 2 * k.numel()),
            ops=2 * 16 * s * s * 128 * 2 / 2)
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
        r["tc_bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S,
                               3 * r["ops"] / TF32_FLOPS) * 1e3
        held(f"sdpa yardstick s={s}", sdpa(q, k, v, causal=True)
             .transpose(1, 2), fa_ref.mha_ref(q, k, v), "bfloat16")
        dev_s = r["device_ms"] or float("nan")
        log(f"  flash_attention b=1 s=t={s} h=16 kvh=2 d=128 f32: "
            f"{r['ms']:.4f} ms per wrapper call, {r['device_ms']} ms on the "
            f"device, {r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms "
            f"SDPA, bound {r['bound_ms']:.6f} ms ({r['bound_by']}, f32 "
            f"cores, {100 * r['bound_ms'] / dev_s:.1f}% of it), 3xTF32 "
            f"tensor-core bound {r['tc_bound_ms']:.6f} ms "
            f"({100 * r['tc_bound_ms'] / dev_s:.1f}% of it); "
            f"{r['ops'] / dev_s / 1e9:.2f} TFLOP/s on the device, "
            f"{r['ops'] / r['ms'] / 1e9:.2f} per wrapper call")
        out[f"flash_attention s={s}"] = r
    out["flash_attention"] = dict(
        out["flash_attention s=2048"],
        max_abs_err=errs["flash_attention", "float32"],
        tiling=tilings[128])

    # flash_decode over 8 lanes filled to phase 4's prompt lengths, f32:
    # bytes = the cache rows read (K and V) plus q, out and kv_len. Each
    # layer of the served model reads its own cache, so every timed call
    # here reads one of four caches (4 x 67 MB, beyond the 50 MB L2) in
    # turn and finds it cold.
    b, t, h, kvh, d = DECODE_FULL
    gen = torch.Generator(device=dev).manual_seed(93)
    q = normal((b, h, d), "float32", dev, 90)
    caches = [tuple(torch.randn((b, t, kvh, d), generator=gen, device=dev)
                    for _ in "kv") for _ in range(4)]
    turn = itertools.cycle(caches)
    kv_len = torch.tensor(PROMPT_LENS, dtype=torch.int32, device=dev)
    mask = (torch.arange(t, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    rows = sum(PROMPT_LENS)

    def cold(fn):
        def call():
            kc, vc = next(turn)
            return fn(kc, vc)
        return call

    kern = cold(lambda kc, vc: dec_ops.decode_attention(q, kc, vc, kv_len))
    passes = {}
    r = dict(
        ms=cuda_ms(kern),
        device_ms=device_ms(kern, ("flash_decode_kernel",
                                   "flash_decode_combine_kernel"),
                            passes=passes),
        plain_ms=cuda_ms(cold(lambda kc, vc: dec_ref.decode_ref(
            q, kc, vc, kv_len))),
        library_ms=cuda_ms(cold(lambda kc, vc: sdpa(q[:, None], kc, vc,
                                                     mask=mask))),
        bytes=4 * (rows * kvh * d * 2 + 2 * b * h * d + b),
        ops=4 * h * rows * d,
        max_abs_err=errs["flash_decode", "float32"])
    r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
    kc, vc = caches[0]
    held("sdpa yardstick decode", sdpa(q[:, None], kc, vc, mask=mask)[:, :, 0],
         dec_ref.decode_ref(q, kc, vc, kv_len), "bfloat16")
    n_split, chunk = dec_kernel.split_plan(b, t, kvh,
                                           dec_kernel.sm_count(dev))
    live = sum(-(-n // chunk) for n in PROMPT_LENS) * kvh
    r.update(n_split=n_split, chunk=chunk, passes=passes)
    dev_s = r["device_ms"] or float("nan")
    log(f"  flash_decode b={b} t={t} h={h} kvh={kvh} d={d} f32, kv_len "
        f"{list(PROMPT_LENS)}: {r['ms']:.4f} ms per wrapper call, "
        f"{r['device_ms']} ms on the device per call (both passes: "
        + ", ".join(f"{k} {v:.6f}" for k, v in passes.items())
        + f"), {r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms "
        f"SDPA, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
        f"{100 * r['bound_ms'] / dev_s:.1f}% of it on the device; "
        f"{r['bytes'] / dev_s / 1e6:.1f} GB/s on the device, "
        f"{r['bytes'] / r['ms'] / 1e6:.1f} GB/s per wrapper call; n_split "
        f"{n_split} of {chunk} rows, {b * kvh * n_split} CTAs ({live} over "
        f"live rows) on {dec_kernel.sm_count(dev)} SMs; caches cold (four "
        "in turn)")
    out["flash_decode"] = r
    return out


# mlstm_chunkwise. Shapes (b, s, h, d): tests/test_kernels.py's sweep, then
# xlstm-1.3b's widths (h=4, d = inner / h = 1024): a 6-token frame and
# phase 5's longest prompts. The reference's bar, 2e-3 + 1e-3 * |want|, in
# f32; 5e-2 in bf16 (one rounding to bf16 of an O(1) output).
MLSTM_TOL = {"float32": (2e-3, 1e-3), "bfloat16": (5e-2, 5e-2)}
MLSTM_SWEEP = [(2, 128, 2, 64), (1, 256, 4, 128), (2, 192, 2, 64)]
MLSTM_FULL = [(1, s, 4, 1024) for s in (6, 2048, 3072)]


def mlstm_inputs(b, s, h, d, dtype, dev, seed):
    """The reference tests' distributions: q, k, v ~ N(0, 1), i ~ N(0,
    0.25), f ~ N(2, 1)."""
    q, k, v = (normal((b, s, h, d), dtype, dev, seed + i) for i in range(3))
    ig = normal((b, s, h), "float32", dev, seed + 3) * 0.5
    fg = normal((b, s, h), "float32", dev, seed + 4) + 2.0
    return q, k, v, ig.to(q.dtype), fg.to(q.dtype)


def check_mlstm(dev):
    """Hold mlstm_chunkwise against its plain version on the card and time
    both at xlstm-1.3b's prefill widths. Returns {label: results}."""
    import torch
    from repro_torch.kernels.mlstm import kernel as ml_kernel
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.mlstm import ref as ml_ref

    worst = {}
    for dtype, shapes in (("float32", MLSTM_SWEEP + MLSTM_FULL),
                          ("bfloat16", MLSTM_SWEEP)):
        atol, rtol = MLSTM_TOL[dtype]
        for i, shape in enumerate(shapes):
            args = mlstm_inputs(*shape, dtype, dev, 10 * i)
            got = ml_ops.mlstm(*args).float()
            want = ml_ref.mlstm_parallel_ref(*args).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            bad = err > atol + rtol * want.abs()
            if bad.any() or not torch.isfinite(got).all():
                raise AssertionError(
                    f"mlstm_chunkwise {shape} {dtype}: {int(bad.sum())} of "
                    f"{got.numel()} outside {atol} + {rtol} * |want|; max "
                    f"abs err {float(err.max()):.3e}")
            worst[dtype] = max(worst.get(dtype, 0.0), float(err.max()))
            if shape in MLSTM_FULL:
                log(f"  mlstm_chunkwise {shape} f32: max abs err "
                    f"{float(err.max()):.3e} (|want| <= "
                    f"{float(want.abs().max()):.3f})")
    log(f"  mlstm_chunkwise: max abs err {worst['float32']:.3e} (f32, "
        f"{len(MLSTM_SWEEP + MLSTM_FULL)} shapes), {worst['bfloat16']:.3e} "
        f"(bf16, {len(MLSTM_SWEEP)} shapes)")

    # Timed at xlstm-1.3b's widths, f32 (the served model's q/k/v): FLOPs
    # 4*b*h*d*s(s+1)/2 (q.k and S.v over the causal triangle); bytes q, k,
    # v and the output, and the two f32 gate rows the kernel reads. Two
    # bounds: the f32 CUDA cores' (bound_ms, comparable with earlier runs)
    # and that of the unit the kernel uses, 3xTF32 on the tensor cores
    # (three TF32 products per f32 product at 495 TFLOP/s).
    out = {}
    for b, s, h, d in MLSTM_FULL:
        args = mlstm_inputs(b, s, h, d, "float32", dev, 90)
        r = dict(
            ms=cuda_ms(lambda: ml_ops.mlstm(*args), reps=10),
            device_ms=device_ms(lambda: ml_ops.mlstm(*args),
                                "mlstm_chunkwise_kernel", reps=5),
            plain_ms=cuda_ms(lambda: ml_ref.mlstm_parallel_ref(*args),
                             reps=5, warmup=1),
            library_ms=None,
            bytes=4 * (4 * b * s * h * d + 2 * b * s * h),
            ops=4 * b * h * d * s * (s + 1) / 2)
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
        r["tc_bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S,
                               3 * r["ops"] / TF32_FLOPS) * 1e3
        n_ranks, dv = ml_kernel.cluster_plan(d)
        dev_s = r["device_ms"] or float("nan")
        log(f"  mlstm_chunkwise b={b} s={s} h={h} d={d} f32: {r['ms']:.4f} "
            f"ms per wrapper call, {r['device_ms']} ms on the device, "
            f"{r['plain_ms']:.4f} ms plain; cluster of {n_ranks} CTAs x "
            f"{dv} columns; bound {r['bound_ms']:.6f} ms ({r['bound_by']}, "
            f"f32 cores, {100 * r['bound_ms'] / dev_s:.1f}% of it), "
            f"3xTF32 tensor-core bound {r['tc_bound_ms']:.6f} ms "
            f"({100 * r['tc_bound_ms'] / dev_s:.1f}% of it); "
            f"{r['ops'] / dev_s / 1e9:.2f} TFLOP/s on the device, "
            f"{r['ops'] / r['ms'] / 1e9:.2f} per wrapper call")
        out[f"s={s}"] = r
    out["mlstm_chunkwise"] = dict(out["s=2048"],
                                  max_abs_err=worst["float32"])
    return out


# selective_scan. Shapes (b, s, inner, n): tests/test_kernels.py's sweep,
# then jamba's widths (inner = 2 * 8192, n = 16): a 6-token frame and
# phase 6's longest prompts. f32: the reference's bar (atol 1e-4) with a
# relative term, for y and h_last. bf16: y and h_last bitwise the bf16
# rounding of the kernel's own f32 run on the same bf16-valued inputs (it
# computes in f32 and rounds y once), and y within one bf16 rounding
# (2^-8 * |want|) plus the f32 atol of the f32 plain version; the excess
# over one rounding alone (2^-8 * |want| + 1e-6) is logged.
SCAN_TOL = (1e-4, 1e-4)
SCAN_BF16_TOL = (1e-4, 2.0 ** -8)
SCAN_SWEEP = [(2, 128, 64, 16), (1, 256, 128, 16), (2, 96, 32, 8)]
SCAN_FULL = [(1, s, 16384, 16) for s in (6, 2048, 3072)]
# Operations per (t, i, n): dt * A, exp, two products and a sum for h, a
# product and a sum for y; per (t, i): dt * x, D * x and the last sum.
OPS_SCAN_STATE = 7
OPS_SCAN_CHANNEL = 3


def scan_inputs(b, s, inner, n, dtype, dev, seed, h0=False):
    """The reference tests' distributions: x, B, C, D ~ N(0, 1), dt =
    softplus(N(0, 1) - 1), A = -exp(N(0, 0.25)), h0 ~ N(0, 0.25); x, dt,
    B and C in ``dtype``, the rest f32."""
    import torch
    x = normal((b, s, inner), dtype, dev, seed)
    dt = torch.nn.functional.softplus(
        normal((b, s, inner), "float32", dev, seed + 1) - 1.0).to(x.dtype)
    A = -torch.exp(normal((inner, n), "float32", dev, seed + 2) * 0.5)
    B = normal((b, s, n), dtype, dev, seed + 3)
    C = normal((b, s, n), dtype, dev, seed + 4)
    D = normal((inner,), "float32", dev, seed + 5)
    return [x, dt, A, B, C, D,
            normal((b, inner, n), "float32", dev, seed + 6) * 0.5
            if h0 else None]


def check_scan(dev):
    """Hold selective_scan against its plain version on the card and time
    both at jamba's prefill widths. Returns {label: results}."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan import ref as ss_ref

    def within(name, got, want, atol, rtol):
        err = (got.float() - want).abs()
        bad = err > atol + rtol * want.abs()
        if bad.any() or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: {int(bad.sum())} of {got.numel()}"
                                 f" outside {atol} + {rtol} * |want|; max "
                                 f"abs err {float(err.max()):.3e}")
        return float(err.max()), float((err / (atol + rtol * want.abs()))
                                       .max())

    plan = ss_kernel.plan()
    log(f"  selective_scan: {plan['lanes']} lanes per channel, chunks of "
        f"{plan['chunk']} tokens; " + "; ".join(build_usage(
            "selective_scan", ss_kernel, _build.NVCC_FLAGS,
            "selective_scan_kernel",
            {"IfL": "f32", "bfloat16": "bf16", "Lb1E": "n = 16",
             "Lb0E": "n < 16"})))
    worst = {}
    for dtype in ("float32", "bfloat16"):
        for i, shape in enumerate(SCAN_SWEEP + SCAN_FULL):
            for h0 in (False, True):
                args = scan_inputs(*shape, dtype, dev, 10 * i, h0)
                y, h = ss_ops.selective_scan(*args)
                torch.cuda.synchronize()
                y_want, h_want = ss_ref.selective_scan_ref(
                    *(a if a is None else a.float() for a in args))
                name = f"selective_scan {shape} {dtype} h0={h0}"
                if dtype == "float32":
                    if not torch.equal(h, h_want):
                        raise AssertionError(f"{name}: h_last is not the "
                                             "plain version's, bitwise")
                    y_lanes, _ = ss_ref.selective_scan_lanes_ref(
                        *args, lanes=plan["lanes"])
                    if not torch.equal(y, y_lanes):
                        raise AssertionError(f"{name}: y is not the lane-"
                                             "ordered plain version's, "
                                             "bitwise")
                eh = within(name + " h_last", h, h_want, *SCAN_TOL)
                ey = within(name + " y", y, y_want,
                            *(SCAN_TOL if dtype == "float32"
                              else SCAN_BF16_TOL))
                if dtype == "bfloat16":
                    y32, h32 = ss_ops.selective_scan(
                        *(a if a is None else a.float() for a in args))
                    if not (torch.equal(y, y32.to(y.dtype))
                            and torch.equal(h, h32)):
                        raise AssertionError(f"{name}: not the bf16 rounding"
                                             " of the kernel's f32 run")
                    excess = ((y.float() - y_want).abs()
                              - 2.0 ** -8 * y_want.abs() - 1e-6)
                    worst["bf16 excess"] = max(worst.get("bf16 excess",
                                                         -1.0),
                                               float(excess.max()))
                for key, e in (("y", ey), ("h", eh)):
                    prev = worst.get((dtype, key), (0.0, 0.0))
                    worst[dtype, key] = tuple(map(max, prev, e))
    excess = worst.pop("bf16 excess")
    for (dtype, key), (err, share) in sorted(worst.items()):
        log(f"  selective_scan {dtype} {key}: max abs err {err:.3e}, worst "
            f"element at {share:.3f} of its bar over "
            f"{2 * len(SCAN_SWEEP + SCAN_FULL)} cases")
    log(f"  selective_scan bf16: y is the bf16 rounding of the kernel's f32 "
        f"run, bitwise; largest excess over one bf16 rounding alone "
        f"(2^-8 * |want| + 1e-6): {excess:.3e}")
    log(f"  selective_scan f32: h_last bitwise the plain version's and y "
        f"bitwise the lane-ordered plain version's (selective_scan_lanes_ref"
        f", {plan['lanes']} lanes) in all {2 * len(SCAN_SWEEP + SCAN_FULL)} "
        "cases")

    # Timed at jamba's widths, f32 (the served model's stream), no h0:
    # bytes = x, dt, B, C, A, D read once and y, h_last written once.
    out = {}
    for b, s, inner, n in SCAN_FULL:
        args = scan_inputs(b, s, inner, n, "float32", dev, 90)
        r = dict(
            ms=cuda_ms(lambda: ss_ops.selective_scan(*args), reps=10),
            device_ms=device_ms(lambda: ss_ops.selective_scan(*args),
                                "selective_scan_kernel", reps=5),
            plain_ms=cuda_ms(lambda: ss_ref.selective_scan_ref(*args),
                             reps=3, warmup=1),
            library_ms=None,
            bytes=4 * (3 * b * s * inner + 2 * b * s * n + inner * n + inner
                       + b * inner * n),
            ops=(OPS_SCAN_STATE * b * s * inner * n
                 + OPS_SCAN_CHANNEL * b * s * inner))
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
        dev_s = r["device_ms"] or float("nan")
        ctas = -(-inner * plan["lanes"] // 128) * b
        log(f"  selective_scan b={b} s={s} inner={inner} n={n} f32: "
            f"{r['ms']:.4f} ms per wrapper call, {r['device_ms']} ms on the "
            f"device, {r['plain_ms']:.4f} ms plain, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / dev_s:.1f}% of it on the device); "
            f"{r['bytes'] / dev_s / 1e6:.1f} GB/s on the device, "
            f"{r['bytes'] / r['ms'] / 1e6:.1f} per wrapper call; {ctas} "
            f"CTAs of 128 threads on 132 SMs")
        out[f"s={s}"] = r
    out["selective_scan"] = dict(out["s=2048"],
                                 max_abs_err=max(worst["float32", "y"][0],
                                                 worst["float32", "h"][0]),
                                 lanes=plan["lanes"])
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


def drive(make_ctl, n_slots):
    """Run ``make_ctl().run(n_slots)`` between synchronisations; returns
    the summary and its host seconds."""
    import torch
    ctl = make_ctl()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = ctl.run(n_slots)
    torch.cuda.synchronize()
    return summary, time.perf_counter() - t0


def identical(name, run_k, run_p):
    """The baselines' bar: the kernel run equals the plain run in every
    slot (indices, policies, assignment, allocation, AoPI)."""
    import numpy as np
    for rk, rp in zip(run_k.records, run_p.records, strict=True):
        for field, a, b in (("assign", rk.assign, rp.assign),
                            ("m_idx", rk.decision.m_idx, rp.decision.m_idx),
                            ("r_idx", rk.decision.r_idx, rp.decision.r_idx),
                            ("pol", rk.decision.pol, rp.decision.pol),
                            ("b", rk.decision.b, rp.decision.b),
                            ("c", rk.decision.c, rp.decision.c),
                            ("aopi", rk.aopi, rp.aopi)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: {field} differs from the "
                                     f"plain run at slot {rk.t}")
    log(f"  {name}: identical to the plain run in all "
        f"{len(run_k.records)} slots")


def profile_slot(fn, label, watch=()):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device busy share: summed kernel time over the host wall time.
    Each name in ``watch`` also gets its summed time and share of the
    device time (all kernels whose name holds it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        # An obs span's range (record_function) also shows on the device
        # timeline as a user annotation: not a kernel.
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile {label}: wall {wall * 1e3:.1f} ms (profiled), device "
        f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%); top "
        "kernels by device time:")
    for ms, count, key in rows[:6]:
        log(f"    {ms:10.3f} ms  {count:6d} launches  {key[:70]}")
    for name in watch:
        ms = sum(r[0] for r in rows if name in r[2])
        log(f"    {name} (all passes): {ms:.3f} ms, "
            f"{100 * ms / max(busy, 1e-9):.1f}% of the device time")
    return wall, busy


# ---------------------------------------------------------------------------
# Phase 7: the scenario sweep
# ---------------------------------------------------------------------------

# The kernels each policy's path launches in a sweep at the suite's size
# (N=30, S=3): Algorithm 1's scan and fused pair for LBCD and MIN, the
# configuration scan for DOS and JCAB.
SWEEP_KERNELS = {"lbcd": ("config_argmin", "waterfill_pair"),
                 "min": ("config_argmin", "waterfill_pair"),
                 "dos": ("baseline_argmax",), "jcab": ("baseline_argmax",)}
# The sweeps' horizon: the suite's own 200 slots cut to 60, phase 8's
# (the churned scenarios lose cameras from slot 6 on), to keep the script
# inside its time.
SWEEP_SLOTS = 60
# The parity sweep's cut horizon: the plain path replays CUDA graphs of
# ~50,000 launches a solve at N=30 (~0.14 s an LBCD slot on the card), so
# the plain sweep of all 11 scenarios is held to 6 slots (~14 s).
PARITY_SLOTS = 6
# The graph replay of the plain solve against the eager plain solve: LBCD's
# solves of these scenarios (and MIN's under a mask) at the suite's size,
# every GRAPH_STRIDE-th of GRAPH_SLOTS slots from the first slot with a dead
# camera (from slot 0 without a mask); eager, a solve takes ~0.65 s.
GRAPH_CHECK = ("camera_churn", "camera_churn_heavy", "steady_ar1")
GRAPH_SLOTS, GRAPH_STRIDE = 8, 4
# The obs on/off comparison: LBCD over the scenarios that run on the
# kernels, cut to OBS_SLOTS slots, in OBS_PAIRS pairs of runs with obs off
# and on, the order alternating (host clocks drift 10-50% within a call,
# so a few runs in one order cannot resolve a cost of a few percent).
# Six pairs, 16 graph solves and parity at 6 slots keep the whole
# script, phase 9 included, inside its time.
OBS_SLOTS, OBS_PAIRS = 10, 6
# Calls timed for the cost of one obs span and one dispatch count.
SPAN_CALLS = 20_000


def dispatch_counts(obs):
    """obs.dispatch.count summed over its series, per kernel entry."""
    out = {}
    for m in obs.registry().collect("obs.dispatch.count"):
        out[m.labels["entry"]] = out.get(m.labels["entry"], 0) + m.value
    return out


def timed_sweep(scenarios, suite, dev, **kw):
    """``scenarios.sweep(suite, **kw)`` between synchronisations; returns
    the result and its host seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = scenarios.sweep(suite, device=dev, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_series(label, res):
    """No policy failed, and every series is finite."""
    import numpy as np
    if res.errors:
        raise AssertionError(f"{label}: policies failed: {res.errors}")
    for p in res.policies:
        for f in ("aopi", "acc", "q"):
            if not np.isfinite(getattr(res, f)[p]).all():
                raise AssertionError(f"{label}: {p} {f} not finite")


def graph_vs_eager(dev, scenarios, suite):
    """The solves the sweep replays as CUDA graphs, each held against the
    eager plain solve (``bcd._solve``) on the same inputs with
    ``torch.equal``: per GRAPH_CHECK scenario, an LBCD rollout on the plain
    path, then at every GRAPH_STRIDE-th slot its virtual-server and
    per-server solves from the rollout's own q and assignment, and MIN's
    solve where the scenario carries a mask. Returns the solves checked."""
    import torch
    from repro_torch.core import bcd, lbcd, profiles

    t0 = time.perf_counter()
    checked = 0
    for name in GRAPH_CHECK:
        full = scenarios.runner.scenario(suite.tables,
                                         suite.names.index(name))
        start = 0
        if full.active is not None:
            start = int(torch.nonzero((full.active <= 0).any(dim=1))[0])
        tab = full.window(start, start + GRAPH_SLOTS)
        res = lbcd.rollout(tab, 10.0, 0.7, solver_backend="torch",
                           device=dev)
        n, n_srv = tab.n_cameras, tab.n_servers
        effs = profiles.eff_sequence(tab)
        virt_id = torch.zeros(n, dtype=torch.int32, device=dev)
        zero = torch.zeros((), device=dev)
        kw = dict(V=10.0, n_iters=4, solver_effort="fast",
                  spec=bcd.resolve_spec("torch", dev, n))
        for t in range(0, GRAPH_SLOTS, GRAPH_STRIDE):
            act = None if tab.active is None else tab.active[t]
            q = zero if t == 0 else res.q[t - 1]
            bb, bc = tab.budgets_b[t], tab.budgets_c[t]
            pooled = (virt_id, bb.sum().reshape(1), bc.sum().reshape(1), 1)
            solves = [("virtual", q) + pooled,
                      ("per-server", q, res.assign[t], bb, bc, n_srv)]
            if act is not None:
                solves.append(("MIN", zero) + pooled)
            for label, q_s, sid, b_s, c_s, s_count in solves:
                args = (tab.acc[t], tab.xi, tab.size, effs[t], sid, b_s, c_s,
                        q_s)
                got = bcd.solve_slot(*args, 10.0, n_servers=s_count,
                                     active=act, solver_backend="torch")
                want = bcd._solve(*args, act, n_servers=s_count, **kw)
                for f in dataclasses.fields(bcd.SlotDecision):
                    if not torch.equal(getattr(got, f.name),
                                       getattr(want, f.name)):
                        raise AssertionError(
                            f"{name} slot {start + t} {label} solve: the "
                            f"graph's {f.name} differs from the eager "
                            "plain solve")
                if label == "per-server" and not torch.equal(
                        got.aopi, res.decision.aopi[t]):
                    raise AssertionError(
                        f"{name} slot {start + t}: the inputs rebuilt here "
                        "are not the rollout's")
                checked += 1
    log(f"  graph replay vs eager plain solve: {checked} solves of "
        f"{', '.join(GRAPH_CHECK)} (N={suite.specs[0].n_cameras}, slots "
        f"{GRAPH_STRIDE} apart from the first with a dead camera) equal "
        f"exactly; {time.perf_counter() - t0:.1f} s")
    return checked


def sweep_phase(dev):
    """The suite (SWEEP_SLOTS slots) through every policy on the kernels,
    obs streaming to a temporary run directory; the graph replays of the
    plain solve against the eager plain solve; the same suite cut to
    PARITY_SLOTS slots against the plain path; LBCD once more with obs
    off. Returns the launches per sweep by kernel and the timings."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch import faults, obs, scenarios  # noqa: F401
    from repro_torch.core import lbcd
    from repro_torch.kernels.slot_solver import ops
    from repro_torch.obs import report as obs_report
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    obs.reset()
    obs.configure(enabled=True, run_dir=run_dir)
    suite = scenarios.suite(device=dev, n_slots=SWEEP_SLOTS)
    spec = suite.specs[0]
    n_k, n_t = suite.n_scenarios, spec.n_slots
    log(f"  suite: {n_k} scenarios ({', '.join(suite.names)}), "
        f"N={spec.n_cameras}, S={spec.n_servers}, T={n_t} (ScenarioSpec "
        f"defaults but T), obs streaming to a temporary run directory")
    # The masked solves replay CUDA graphs of the plain version, captured
    # at their first call: capture them here (one slot of LBCD on the
    # churned scenario), outside the timed sweeps.
    churned = scenarios.runner.scenario(
        suite.tables, suite.names.index("camera_churn")).window(0, 1)
    t0 = time.perf_counter()
    lbcd.rollout(churned, 10.0, 0.7, device=dev)
    torch.cuda.synchronize()
    log(f"  masked-solve graphs captured: {time.perf_counter() - t0:.2f} s")
    sweep_launches = {name: 0 for name in ops.launches}
    per_policy = {}
    results = {}
    for policy in scenarios.POLICIES:
        ops.reset_launches()
        before = dispatch_counts(obs)
        res, sec = timed_sweep(scenarios, suite, dev, policies=(policy,))
        counts = dict(ops.launches)
        check_series(f"sweep {policy}", res)
        missing = [k for k in SWEEP_KERNELS[policy] if counts[k] <= 0]
        if missing:
            raise AssertionError(f"sweep {policy}: {missing} never "
                                 f"launched: {counts}")
        after = dispatch_counts(obs)
        for name, count in counts.items():
            seen = after.get(name, 0) - before.get(name, 0)
            if seen != count:
                raise AssertionError(
                    f"sweep {policy}: obs.dispatch.count {seen} for {name}, "
                    f"launched {count}")
        for name, count in counts.items():
            sweep_launches[name] += count
        how = ("the masked plain path (Algorithm 1 on the plain versions)"
               if policy in ("lbcd", "min") else
               "the masked path (baseline_argmax, the mask after the scan)")
        log(f"  sweep {policy}: {sec:.2f} s, {n_k * n_t / sec:.3f} "
            f"scenario-slots/s, launches {counts} (equal to "
            f"obs.dispatch.count); {how}: {res.masked}; mean AoPI "
            f"{float(np.mean(res.aopi[policy])):.5f} s")
        per_policy[policy] = sec
        results[policy] = res
    spans = [e for e in obs.events() if e["name"] == "sweep.policy"]
    if len(spans) != len(scenarios.POLICIES):
        raise AssertionError(f"{len(spans)} sweep.policy spans, expected "
                             f"{len(scenarios.POLICIES)}")
    fams = sorted(set(suite.families))
    hists = {(m.labels["policy"], m.labels["family"]): m.count
             for m in obs.registry().collect("sweep.aopi")}
    want = {(p, f): n_t * suite.families.count(f)
            for p in scenarios.POLICIES for f in fams}
    if hists != want:
        raise AssertionError(f"sweep.aopi histograms {hists}, expected "
                             f"{want}")
    log(f"  obs: {len(spans)} sweep.policy spans, {len(hists)} sweep.aopi "
        f"histograms (policy x family), launches per sweep "
        f"{sweep_launches}")
    print(scenarios.robustness(results["lbcd"]), flush=True)

    # One LBCD slot of a scenario under the profiler: the solves' ranges.
    steady = suite.names.index("steady_ar1")
    one = scenarios.runner.scenario(suite.tables, steady).window(0, 1)
    lbcd.rollout(one, 10.0, 0.7, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lbcd.rollout(one, 10.0, 0.7, device=dev)
        torch.cuda.synchronize()
    ranges = [e for e in prof.events() if e.name == "bcd.solve_slot"]
    kinds = sorted({str(e.device_type) for e in ranges})
    if not ranges:
        raise AssertionError("no bcd.solve_slot range in the profile")
    log(f"  profiled LBCD slot of {suite.names[steady]}: {len(ranges)} "
        f"bcd.solve_slot ranges ({', '.join(kinds)})")

    obs.flush()
    paths = obs.write_artifacts()
    for label, path in sorted(paths.items()):
        if not Path(path).is_file():
            raise AssertionError(f"obs artefact {label} missing: {path}")
    report = obs_report.build_report(obs_report.load_events(run_dir),
                                     obs_report.load_metrics(run_dir))
    if "solve_slot[cuda]" not in report or "kernel entry" not in report:
        raise AssertionError(f"obs report incomplete:\n{report}")
    log("  obs artefacts: " + ", ".join(
        f"{Path(p).name} {Path(p).stat().st_size} B"
        for p in sorted(paths.values())) + "; repro_torch.obs.report:")
    for line in report.splitlines():
        log(f"    {line}")
    obs.configure(run_dir="")
    shutil.rmtree(run_dir)

    # The graphs the sweeps replay, against the eager plain solve.
    graph_vs_eager(dev, scenarios, suite)

    # Parity: the same suite cut to PARITY_SLOTS slots, kernels against the
    # plain path, exactly.
    cut = scenarios.suite(device=dev, n_slots=PARITY_SLOTS)
    res_k, sec_k = timed_sweep(scenarios, cut, dev)
    res_p, sec_p = timed_sweep(scenarios, cut, dev, solver_backend="torch")
    check_series("parity kernels", res_k)
    check_series("parity plain", res_p)
    for p in scenarios.POLICIES:
        for f in ("aopi", "acc", "q"):
            if not np.array_equal(getattr(res_k, f)[p], getattr(res_p, f)[p]):
                raise AssertionError(f"parity: {p} {f} differs between the "
                                     "kernel and plain sweeps")
    log(f"  parity at T={PARITY_SLOTS} (every scenario, every policy): "
        f"kernel series equal to the plain series exactly; kernels "
        f"{sec_k:.2f} s, plain {sec_p:.2f} s")

    # Obs overhead: the LBCD kernel sweep again, with obs off and on in
    # alternating pairs.
    kernel_only = [n for n in suite.names if n not in results["lbcd"].masked]
    cut = scenarios.suite(kernel_only, device=dev, n_slots=OBS_SLOTS)
    timed_sweep(scenarios, cut, dev, policies=("lbcd",))      # warm-up
    pairs = []
    for i in range(OBS_PAIRS):
        sec = {}
        for enabled in ((False, True) if i % 2 == 0 else (True, False)):
            obs.configure(enabled=enabled)
            res_o, sec[enabled] = timed_sweep(scenarios, cut, dev,
                                              policies=("lbcd",))
            check_series(f"sweep lbcd obs {enabled}", res_o)
        pairs.append((sec[False], sec[True]))
    obs.configure(enabled=True)
    offs = [off for off, _ in pairs]
    ons = [on for _, on in pairs]
    ratios = [on / off for off, on in pairs]
    ratio = statistics.median(ratios)
    q1, _, q3 = statistics.quantiles(offs, n=4)
    log(f"  obs overhead: LBCD sweep of the {len(kernel_only)} kernel "
        f"scenarios at T={OBS_SLOTS}, {OBS_PAIRS} off/on pairs in "
        f"alternating order: off median {statistics.median(offs):.3f} s "
        f"(quartiles {q1:.3f}-{q3:.3f}), on median "
        f"{statistics.median(ons):.3f} s; on slower in "
        f"{sum(r > 1 for r in ratios)}/{OBS_PAIRS} pairs; on/off median "
        f"{ratio:.4f} (pairs {min(ratios):.4f}-{max(ratios):.4f})")
    # What obs adds to a slot, timed alone: two solve spans and a count
    # per launch (18 a kernel LBCD slot at N=30, S=3).
    t0 = time.perf_counter()
    for _ in range(SPAN_CALLS):
        with obs.span("obs.span_cost", solver_backend="cuda", n_cameras=30):
            pass
    span_us = (time.perf_counter() - t0) / SPAN_CALLS * 1e6
    t0 = time.perf_counter()
    for _ in range(SPAN_CALLS):
        obs.count_dispatch("obs_cost")
    count_us = (time.perf_counter() - t0) / SPAN_CALLS * 1e6
    per_slot = 2 * span_us + 18 * count_us
    slot_us = statistics.median(offs) / (len(kernel_only) * OBS_SLOTS) * 1e6
    log(f"  obs cost timed alone: a span {span_us:.2f} us, a dispatch "
        f"count {count_us:.2f} us; a kernel LBCD slot's obs work "
        f"{per_slot:.1f} us of its {slot_us:.0f} us "
        f"({100 * per_slot / slot_us:.3f}%); phase 7 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=sweep_launches, seconds=per_policy,
                obs_ratio=ratio, span_us=span_us, count_us=count_us)


# ---------------------------------------------------------------------------
# Phase 8: the data plane (AnalyticsService, the tick scan, the sweep's
# replay)
# ---------------------------------------------------------------------------

# The service at the paper's setting: N=30 cameras on S=3 servers, 300 s
# epochs (LBCD plans 30-136 frames/s there: 49,152 frames a stream, f64),
# 16 epochs in plan windows of 8.
SERVICE_EPOCHS = 16
# The sweep's replay at examples/scenario_suite.py's size: 11 scenarios,
# N=16, S=3, 60 slots, the first 16 replayed as 600 s epochs (98,304
# frames a stream, one window of 16 epochs x 16 streams per cell).
DP_SUITE = dict(n_cameras=16, n_slots=60, n_servers=3)
DP_PARAMS = dict(n_epochs=16, epoch_duration=600.0)
# Shapes the main path gives the kernels (phase 8 logs every window):
# gi_g1_window is checked against its plain loop, and timed
# beside it, at one sweep cell's window (E epochs, N streams, F frames),
# and timed alone at the service's window and the sweep's commonest;
# tick_scan likewise at the engine rung's shortest epoch (S streams, F
# ticks) and alone at its commonest. A plain loop's time is linear in F
# (~0.5 ms a frame): the shortest shapes keep the checks in the script's
# time.
CHECK_WINDOW = (16, 16, 20_480)
SERVICE_WINDOW = (8, 30, 65_536)
SWEEP_WINDOW = (10, 16, 200_000)
CHECK_EPOCH = (30, 28_672)
ENGINE_EPOCH = (30, 49_152)
# Measured against the closed form (Theorems 1-2): the horizon mean of a
# replayed cell or service run, |measured / predicted - 1|. An mm1 world
# planned on the true tables (gain 0, or a fitted mm1 at gain 0.3) is the
# theorems' own process; over 16 epochs of >= 9,000 frames a stream the
# sample mean's spread is a few percent.
CLOSED_FORM_TOL = 0.15
# Bars of the kernels against their plain versions on the card: bitwise
# but for lognormal (the kernel's copy of PyTorch's ndtri polynomial).
DP_RTOL = {"lognormal": 1e-12}
# Operations per unit of the window kernel's work, counted from
# csrc/dataplane.cu (each integer or float +, -, *, /, shift, xor, rotate
# and compare is one; a libdevice log1p, exp, log or pow one): one
# threefry-2x32 draw (20 rounds of 3, 5 key injections of 3, 2 initial
# adds, the uniform's 4); a delay from its uniforms; thread 0's step of
# the recurrence; the tick scan's step.
OPS_THREEFRY_DRAW = 81
OPS_DELAY = {"mm1": 3, "uniform": 4, "gamma": 6, "lognormal": 12,
             "weibull": 5}
OPS_WINDOW_STEP = 26
OPS_TICK_STEP = 34


def window_inputs(e, n, dtype, dev, seed, lam_range=(2.0, 9.0)):
    """[E, N] rates with a dead lane's clamped stand-in, mixed policies,
    and the epoch keys of seed 7 from epoch 3, on the card."""
    import numpy as np
    import torch
    from repro_torch.core import threefry
    rng = np.random.default_rng(seed)
    lam = rng.uniform(*lam_range, (e, n))
    mu = lam * rng.uniform(1.3, 3.0, (e, n))
    lam[0, min(1, n - 1)] = 1e-6
    p = rng.uniform(0.4, 0.95, (e, n))
    pol = rng.integers(0, 2, (e, n))

    def put(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    keys = threefry.fold_in(threefry.key(7, dev),
                            torch.arange(3, 3 + e, device=dev))
    return (put(lam), put(mu), put(p), put(pol, torch.int32), keys)


def window_err(got, want, rtol, label):
    """Kernel against plain window: counts exact, the rest bitwise or
    within ``rtol``; returns the max abs error."""
    import torch
    err = 0.0
    for name, w in want.items():
        g = got[name]
        diff = float((g - w).abs().max())
        err = max(err, diff)
        exact = rtol is None or name.startswith("n_")
        if (not torch.equal(g, w) if exact else
                not torch.allclose(g, w, rtol=rtol, atol=0.0)):
            raise AssertionError(f"gi_g1_window {label} {name}: kernel "
                                 f"and plain differ by {diff:.3e}")
    return err


def window_ops(model, n_lanes, frames) -> float:
    """Operations of one window: per frame, pass 1's draws and delay of
    T and its sum, pass 2's draws and delays of the next T and of O, its
    coin and the recurrence step."""
    from repro_torch.core import queues
    k = queues._n_uniforms(model)
    per_frame = ((k // 2 + k) * OPS_THREEFRY_DRAW + 3 * OPS_DELAY[model]
                 + OPS_WINDOW_STEP + 1)
    return float(n_lanes) * frames * per_frame


def dataplane_kernels(dev):
    """Both data-plane kernels against their plain versions on the card:
    every family at 640 frames (f32, light tails) and 1,280 (f64), then at
    the main path's shapes of the module constants (CHECK_WINDOW,
    CHECK_EPOCH; the others timed alone); the tick scan also for every
    family at 512 ticks with the trace; one-lane runs of both for their
    chain floors."""
    import numpy as np
    import torch
    from repro_torch.core import queues
    from repro_torch.kernels.dataplane import ops as dp_ops
    from repro_torch.serving import engine_plane, tick_plane

    errs = {"gi_g1_window": 0.0, "tick_scan": 0.0}
    for model in queues.DELAY_MODELS:
        for frames in (640, 1280):
            heavy = model in queues.HEAVY_TAIL_MODELS
            dtype = (torch.float64 if frames > queues.F32_MAX_FRAMES or heavy
                     else torch.float32)
            args = (*window_inputs(4, 12, dtype, dev, 0), 90.0, frames,
                    model, 48)
            err = window_err(dp_ops.gi_g1_window(*args),
                             queues._window_sim(*args), DP_RTOL.get(model),
                             f"{model} F={frames}")
            errs["gi_g1_window"] = max(errs["gi_g1_window"], err)
    log(f"  gi_g1_window vs plain: 5 families x (640, 1,280 frames), 4 x "
        f"12 lanes with samples: bitwise but lognormal (max abs err "
        f"{errs['gi_g1_window']:.3e})")

    out = {}
    e, n, f = CHECK_WINDOW
    chk = (*window_inputs(e, n, torch.float64, dev, 1, (30.0, 136.0)),
           600.0, f, "mm1")
    got = dp_ops.gi_g1_window(*chk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = queues._window_sim(*chk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs["gi_g1_window"] = max(errs["gi_g1_window"], window_err(
        got, want, None, "sweep cell window"))
    ms = cuda_ms(lambda: dp_ops.gi_g1_window(*chk), reps=10, warmup=1)
    dev_ms = device_ms(lambda: dp_ops.gi_g1_window(*chk),
                       "gi_g1_window_kernel", reps=5)
    more = {}
    for label, (we, wn, wf), horizon in (
            ("service_window_ms", SERVICE_WINDOW, 300.0),
            ("sweep_window_ms", SWEEP_WINDOW, 600.0)):
        args = (*window_inputs(we, wn, torch.float64, dev, 2,
                               (30.0, 136.0)), horizon, wf, "mm1")
        more[label] = cuda_ms(lambda: dp_ops.gi_g1_window(*args), reps=5,
                              warmup=1)
    one = (*window_inputs(1, 1, torch.float64, dev, 3, (60.0, 61.0)),
           600.0, f, "mm1")
    chain_ms = cuda_ms(lambda: dp_ops.gi_g1_window(*one), reps=5, warmup=1)
    # Each epoch's key and each lane's rates, p and policy read once, its
    # five outputs written once.
    n_bytes = e * 16 + e * n * (3 * 8 + 4 + 5 * 8)
    b_ms, b_by = bound_ms(n_bytes, window_ops("mm1", e * n, f))
    out["gi_g1_window"] = dict(
        ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, chain_floor_ms=chain_ms,
        max_abs_err=errs["gi_g1_window"], **more)
    log(f"  gi_g1_window, a sweep cell's window (E={e} N={n} F={f} f64 "
        f"mm1): {ms:.3f} ms ({dev_ms} ms on the device), plain "
        f"{plain_ms:.1f} ms (bitwise equal); one lane (F={f}): "
        f"{chain_ms:.3f} ms; bound {b_ms:.6f} ms ({b_by}); the service's "
        f"window (E={SERVICE_WINDOW[0]} N={SERVICE_WINDOW[1]} "
        f"F={SERVICE_WINDOW[2]}) {more['service_window_ms']:.3f} ms, the "
        f"sweep's commonest (E={SWEEP_WINDOW[0]} N={SWEEP_WINDOW[1]} "
        f"F={SWEEP_WINDOW[2]}) {more['sweep_window_ms']:.3f} ms")

    rng = np.random.default_rng(4)
    for model in queues.DELAY_MODELS:
        lam = rng.uniform(2.0, 9.0, (2, 15))
        kw = dict(epoch_duration=60.0, seed=4, t0=2, delay_model=model,
                  frames_cap=512, collect_samples=16, collect_trace=True)
        args = (lam, lam * rng.uniform(1.1, 2.5, lam.shape),
                rng.uniform(0.4, 0.95, lam.shape),
                rng.integers(0, 2, lam.shape))
        got = tick_plane.measure_engine_window_scan(*args, device=dev, **kw)
        want = tick_plane.measure_engine_window_scan(*args, device="cpu",
                                                     **kw)
        if got["trace"] != want["trace"] or not got["trace"]:
            raise AssertionError(f"tick_scan {model}: trace differs")
        for name, w in want.items():
            if name == "trace":
                continue
            g = np.asarray(got[name], np.float64)
            if g.size:
                errs["tick_scan"] = max(errs["tick_scan"], float(
                    np.abs(g - np.asarray(w, np.float64)).max()))
            if not np.array_equal(got[name], w):
                raise AssertionError(f"tick_scan {model} {name}: kernel "
                                     "differs from the plain scan")
    def put(x):
        return torch.as_tensor(x, device=dev)

    def engine_epoch(s, f):
        """An engine epoch's host draws (timed) and the scan's inputs."""
        lam = rng.uniform(30.0, 136.0, s)
        t0 = time.perf_counter()
        draws = engine_plane.draw_streams(
            lam, lam * rng.uniform(1.3, 3.0, s), np.ones(s, bool),
            delay_model="mm1", seed=0, t=0, frames_cap=f)
        sec = time.perf_counter() - t0
        return sec, (*map(put, draws), put(rng.uniform(0.4, 0.9, s)),
                     put(rng.integers(0, 2, s) == 1), put(np.ones(s, bool)),
                     300.0)

    s, f = CHECK_EPOCH
    _, targs = engine_epoch(s, f)
    got = dp_ops.tick_scan(*targs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tick_plane._tick_scan(*targs)
    torch.cuda.synchronize()
    tplain_ms = (time.perf_counter() - t0) * 1e3
    for name, w in want.items():
        errs["tick_scan"] = max(errs["tick_scan"], float(
            (got[name].double() - w.double()).abs().max()))
        if not torch.equal(got[name], w):
            raise AssertionError(f"tick_scan service epoch {name}: kernel "
                                 "differs from the plain scan")
    tms = cuda_ms(lambda: dp_ops.tick_scan(*targs), reps=10, warmup=1)
    tdev = device_ms(lambda: dp_ops.tick_scan(*targs), "tick_scan_kernel",
                     reps=5)
    tchain = cuda_ms(lambda: dp_ops.tick_scan(
        *(t[:1] for t in targs[:6]), 300.0), reps=5, warmup=1)
    draw_s, eargs = engine_epoch(*ENGINE_EPOCH)
    engine_ms = cuda_ms(lambda: dp_ops.tick_scan(*eargs), reps=5, warmup=1)
    del eargs
    # The draws read once, p and the two flags read, the nine-word lane
    # state written.
    t_bytes = s * f * 3 * 8 + s * (8 + 2) + 9 * s * 8
    tb_ms, tb_by = bound_ms(t_bytes, float(s) * f * (OPS_TICK_STEP + 1))
    out["tick_scan"] = dict(
        ms=tms, device_ms=tdev, plain_ms=tplain_ms, bound_ms=tb_ms,
        bound_by=tb_by, chain_floor_ms=tchain, host_draw_s=draw_s,
        engine_epoch_ms=engine_ms, max_abs_err=errs["tick_scan"])
    log(f"  tick_scan vs plain: 5 families at 2 x 15 lanes, 512 ticks, "
        f"trace included, bitwise (and the plain scan on the CPU, the "
        f"DES's twin); the engine rung's shortest epoch (S={s}, F={f} "
        f"f64): {tms:.3f} ms ({tdev} ms on the device), plain "
        f"{tplain_ms:.1f} ms (bitwise equal), one lane {tchain:.3f} ms, "
        f"bound {tb_ms:.6f} ms ({tb_by}); its commonest (S="
        f"{ENGINE_EPOCH[0]}, F={ENGINE_EPOCH[1]}): {engine_ms:.3f} ms "
        f"after host draws of {draw_s:.3f} s (3 x {ENGINE_EPOCH[0]} x "
        f"{ENGINE_EPOCH[1]} f64, "
        f"{3 * ENGINE_EPOCH[0] * ENGINE_EPOCH[1] * 8 / 1e6:.1f} MB)")
    return out


def closed_form_check(label, measured, predicted):
    """|mean measured / mean predicted - 1| within CLOSED_FORM_TOL."""
    import numpy as np
    div = float(np.mean(measured) / max(np.mean(predicted), 1e-12) - 1.0)
    if not np.isfinite(measured).all() or abs(div) > CLOSED_FORM_TOL:
        raise AssertionError(f"{label}: measured vs closed form {div:+.4f} "
                             f"(bar {CLOSED_FORM_TOL})")
    return div


def dataplane_phase(dev, timed):
    """Phase 8: the data plane's main path with the launch counters zeroed
    just before and read just after: the service (fitted selector, gain
    0.3), the service in engine mode on the scan backend, and the sweep's
    replay through every policy. ``timed`` is phase 2's
    ``dataplane_kernels``; returns it with the launches and timings."""
    import collections

    import numpy as np
    import torch
    from repro_torch import obs, scenarios
    from repro_torch.core import lbcd, profiles
    from repro_torch.kernels.dataplane import ops as dp_ops
    from repro_torch.kernels.slot_solver import ops
    from repro_torch.serving import AnalyticsService

    t_phase = time.perf_counter()

    obs.reset()
    obs.configure(enabled=True)
    dp_ops.reset_launches()
    ops.reset_launches()
    runs = {}

    def service(label, **kw):
        ctrl = lbcd.LBCDController(
            profiles.EdgeSystem(n_cameras=30, n_servers=3, seed=0),
            device=dev)
        before = dict(dp_ops.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = AnalyticsService(ctrl, epoch_duration=300.0, **kw)
        reps = svc.run(SERVICE_EPOCHS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in dp_ops.launches.items()}
        meas = np.array([r.measured_aopi for r in reps])
        pred = np.array([r.predicted_aopi for r in reps])
        div = closed_form_check(f"service {label}", meas, pred)
        # Nothing is injected: a planning failure here is a fault of the
        # path (a kernel's included), and no rung of the ladder may serve.
        if svc.plan_failures or svc.fallbacks or svc.degraded_epochs:
            raise AssertionError(
                f"service {label}: plan failures {svc.plan_failures}, "
                f"fallbacks {svc.fallbacks}, degraded "
                f"{svc.degraded_epochs}")
        extra = ""
        if svc.mode == "engine":
            model = np.array([r.model_aopi for r in reps])
            closed_form_check(f"service {label} GI/G/1 rung", model, pred)
            extra = (f", GI/G/1 rung mean {model.mean():.5f} s "
                     f"({model.mean() / meas.mean() - 1:+.4f} vs engine)")
        log(f"  service {label}: {SERVICE_EPOCHS} epochs in {sec:.2f} s "
            f"({SERVICE_EPOCHS / sec:.3f} epochs/s), launches {counts}; "
            f"mean measured {meas.mean():.5f} s vs closed form "
            f"{pred.mean():.5f} s ({div:+.4f}){extra}; fitted "
            f"{sorted(set(m for _, m in svc.fitted_models))}")
        runs[label] = dict(seconds=sec, launches=counts)
        return svc

    service("auto, gain 0.3", delay_model="auto", telemetry_gain=0.3)
    service("engine, scan", mode="engine", engine_backend="scan")

    suite = scenarios.suite(device=dev, **DP_SUITE)
    before = dict(dp_ops.launches)
    per_policy = {}
    results = {}
    for policy in scenarios.POLICIES:
        res, sec = timed_sweep(scenarios, suite, dev, policies=(policy,),
                               dataplane=True, dataplane_params=DP_PARAMS)
        check_series(f"dataplane sweep {policy}", res)
        if any(res.fallbacks[policy]) or any(res.degraded[policy]):
            raise AssertionError(
                f"dataplane sweep {policy}: fallbacks {res.fallbacks}, "
                f"degraded {res.degraded}")
        divs = res.divergence(policy)
        worst = int(np.argmax(np.abs(divs)))
        if (not np.isfinite(res.measured_aopi[policy]).all()
                or abs(divs[worst]) > CLOSED_FORM_TOL):
            raise AssertionError(
                f"dataplane sweep {policy}: {res.names[worst]} measured vs "
                f"closed form {divs[worst]:+.4f} (bar {CLOSED_FORM_TOL})")
        per_policy[policy] = sec
        results[policy] = res
        log(f"  sweep {policy} (dataplane): {sec:.2f} s; divergence per "
            f"scenario {np.round(divs, 4).tolist()}")
    runs["sweep"] = dict(seconds=sum(per_policy.values()), launches={
        k: v - before[k] for k, v in dp_ops.launches.items()})
    counts = dict(dp_ops.launches)
    slot_counts = dict(ops.launches)
    for name in ("gi_g1_window", "tick_scan"):
        if counts[name] <= 0:
            raise AssertionError(f"phase 8: {name} never launched: {counts}")
    # The reference's own series count the same launches: one
    # queues.batch_dispatches per window, engine.ticks per tick scanned.
    reg = obs.registry()
    ticks = sum(m.value for m in reg.collect("engine.ticks")
                if m.labels.get("backend") == "scan")
    if reg.total("queues.batch_dispatches") != counts["gi_g1_window"]:
        raise AssertionError("queues.batch_dispatches "
                             f"{reg.total('queues.batch_dispatches')} != "
                             f"{counts['gi_g1_window']} window launches")
    shapes = collections.Counter(
        (e["args"]["epochs"], e["args"]["streams"], e["args"]["n_frames"])
        for e in obs.events() if e["name"] == "queues.gi_g1_window")
    if sum(shapes.values()) != counts["gi_g1_window"]:
        raise AssertionError(f"{sum(shapes.values())} window spans for "
                             f"{counts['gi_g1_window']} launches")
    log("  window shapes (epochs, streams, frames): launches "
        + ", ".join(f"{k}: {v}" for k, v in sorted(shapes.items()))
        + f"; engine.ticks (scan) {ticks:.0f}")
    for name in ("config_argmin", "waterfill_pair", "baseline_argmax"):
        if slot_counts[name] <= 0:
            raise AssertionError(f"phase 8: {name} never launched: "
                                 f"{slot_counts}")
    res = results["lbcd"]
    print(scenarios.robustness(res), flush=True)
    log(f"  data-plane main path launches {counts} (service auto "
        f"{runs['auto, gain 0.3']['launches']}, engine "
        f"{runs['engine, scan']['launches']}, sweep "
        f"{runs['sweep']['launches']}); slot-solver {slot_counts}; sweep "
        f"seconds per policy {per_policy} (11 scenarios, N=16, S=3, 60 "
        f"closed-form slots, 16 replayed 600 s epochs); phase 8 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(timed=timed, launches=counts, runs=runs,
                sweep_seconds=per_policy,
                shapes={str(k): v for k, v in shapes.items()})


# ---------------------------------------------------------------------------
# Phase 9: the rest of core/ (the interior-point method, the rate
# frontiers), island failover and the serving launcher
# ---------------------------------------------------------------------------

# The paper's setting, 25 slots; the graph replays of the interior solve
# are held against its eager solve over the first INTERIOR_EAGER_SLOTS
# slots (both solves of each). tests/test_lbcd.py's bar, the interior
# method's mean AoPI within 15% of the water-fill's, holds on that test's
# 10-camera system (tests/test_torch_lbcd.py holds it there) but not here:
# repro's own runs of this system (REFERENCE_PAPER_AOPI, on the CPU; kept
# equal to repro by tests/test_torch_lbcd.py) give 0.7599. So each of the
# two means is held to repro's within the rollout contract's 5e-3 on
# fleet means, and the ratio is reported.
PAPER_SYSTEM = dict(n_cameras=30, n_servers=3, n_slots=25, seed=0)
INTERIOR_SLOTS = 25
INTERIOR_EAGER_SLOTS = 4
REFERENCE_PAPER_AOPI = {"interior": 0.0327407132089138,
                        "waterfill": 0.043086424320936206}
MEAN_RTOL = 5e-3
# Figs. 3 and 5: targets x rates x both policies, p = 0.9, one tensor call
# per frontier; each finite point's AoPI within FRONTIER_TOL (relative) of
# its target (tests/test_aopi_theory.py's bar). An LCFSP min_lam that the
# bisection leaves at the top of its bracket (1e6) marks an unreachable
# target (the reference's convention: no inf there).
FRONTIER_TARGETS = (0.1, 0.2, 0.5, 1.0)
FRONTIER_RATES = (2.0, 4.0, 6.0, 9.0, 13.0, 18.0, 24.0, 30.0)
FRONTIER_P = 0.9
FRONTIER_TOL = 1e-2
# Failover: the paper system with island 1 dead at slot 3.
FAILOVER_DEAD = (False, True, False)
FAILOVER_SLOT = 3
# The launcher: its CLI defaults in mm1; --engine at the CLI's 8 epochs
# with 2 streams: its 8-lane engine pins one lane a stream (at the default
# 16 the first epoch raises, in the reference too), and each frame is a
# real admit and decode ticks, ~10-15 ms of eager launches (8 streams
# took 90-180 s). Phase 4 drives the same service over the full-width
# engine, 8 streams, 2 epochs, 4 frames a stream.
LAUNCHER_ENGINE_STREAMS = 2
LAUNCHER_FULL_FRAMES = 4
LAUNCHER_FULL_STREAMS = 8
LAUNCHER_FULL_EPOCHS = 2


def interior_lbcd(dev):
    """(a) LBCD with the paper's interior-point method on the card: 25
    slots, the graph replays of its first slots against the eager solve,
    mean AoPI against the water-fill LBCD's, q finite, and the "cuda"
    refusal. Returns the measured numbers."""
    import numpy as np
    import torch
    from repro_torch.core import bcd, lbcd, profiles
    from repro_torch.kernels.slot_solver import ops

    def controller(method, system=PAPER_SYSTEM, **kw):
        return lbcd.LBCDController(profiles.EdgeSystem(**system), v=10.0,
                                   p_min=0.7, method=method, device=dev,
                                   **kw)

    # One slot captures the two graphs (virtual and per-server solve);
    # the timed run replays them.
    bcd.release_graphs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    controller("interior").run(1)
    torch.cuda.synchronize()
    sec_capture = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    run_i = controller("interior").run(INTERIOR_SLOTS)
    torch.cuda.synchronize()
    sec_i = time.perf_counter() - t0
    launched = {k: v for k, v in ops.launches.items() if v}
    if launched:
        raise AssertionError(f"interior LBCD launched slot-solver kernels "
                             f"{launched}: the method has none")
    graphs = [k for k in bcd._GRAPHS if k[-2] == "interior"]
    if len(graphs) != 2:
        raise AssertionError(f"interior LBCD: {len(graphs)} interior "
                             "graphs, expected 2 (virtual and per-server)")
    q = np.array([r.q for r in run_i.records])
    if not np.isfinite(q).all():
        raise AssertionError(f"interior LBCD: accuracy queue {q}")

    # Graph replays against the eager solve of the same inputs.
    tab = profiles.EdgeSystem(**PAPER_SYSTEM).horizon(INTERIOR_SLOTS,
                                                      device=dev)
    effs = profiles.eff_sequence(tab)
    n, n_srv = tab.n_cameras, tab.n_servers
    virt_id = torch.zeros(n, dtype=torch.int32, device=dev)
    kw = dict(V=10.0, n_iters=4, method="interior", solver_effort="fast",
              spec=bcd.resolve_spec("auto", dev, n, method="interior"))
    t0 = time.perf_counter()
    eager_s = []
    for t in range(INTERIOR_EAGER_SLOTS):
        rec = run_i.records[t]
        q_t = torch.tensor(0.0 if t == 0 else run_i.records[t - 1].q,
                           dtype=torch.float32, device=dev)
        bb, bc = tab.budgets_b[t], tab.budgets_c[t]
        assign = torch.as_tensor(rec.assign, device=dev)
        for label, sid, b_s, c_s, s_count in (
                ("virtual", virt_id, bb.sum().reshape(1),
                 bc.sum().reshape(1), 1),
                ("per-server", assign, bb, bc, n_srv)):
            args = (tab.acc[t], tab.xi, tab.size, effs[t], sid, b_s, c_s,
                    q_t)
            got = bcd.solve_slot(*args, 10.0, n_servers=s_count,
                                 method="interior")
            torch.cuda.synchronize()
            te = time.perf_counter()
            want = bcd._solve(*args, None, n_servers=s_count, **kw)
            torch.cuda.synchronize()
            eager_s.append(time.perf_counter() - te)
            for f in dataclasses.fields(bcd.SlotDecision):
                if not torch.equal(getattr(got, f.name),
                                   getattr(want, f.name)):
                    raise AssertionError(
                        f"interior slot {t} {label} solve: the graph's "
                        f"{f.name} differs from the eager solve")
            if label == "per-server" and not np.array_equal(
                    got.aopi.cpu().numpy(), rec.aopi):
                raise AssertionError(f"interior slot {t}: the inputs rebuilt "
                                     "here are not the rollout's")
    sec_eager = time.perf_counter() - t0

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_w = controller("waterfill").run(INTERIOR_SLOTS)
    torch.cuda.synchronize()
    sec_w = time.perf_counter() - t0
    if ops.launches["config_argmin"] <= 0:
        raise AssertionError("water-fill LBCD launched no config_argmin")
    ratio = run_i.mean_aopi / run_w.mean_aopi
    for method, run in (("interior", run_i), ("waterfill", run_w)):
        want = REFERENCE_PAPER_AOPI[method]
        if abs(run.mean_aopi / want - 1.0) > MEAN_RTOL:
            raise AssertionError(f"{method} LBCD mean AoPI {run.mean_aopi}"
                                 f" vs repro's {want} (bar {MEAN_RTOL})")
    try:
        controller("interior", solver_backend="cuda").run(1)
    except ValueError as err:
        if "interior" not in str(err):
            raise
    else:
        raise AssertionError("solver_backend='cuda' with the interior "
                             "method did not raise")
    out = dict(seconds=sec_i, slots_per_s=INTERIOR_SLOTS / sec_i,
               capture_s=sec_capture,
               eager_solve_s=float(np.median(eager_s)),
               mean_aopi=run_i.mean_aopi, waterfill_mean_aopi=run_w.mean_aopi,
               waterfill_slots_per_s=INTERIOR_SLOTS / sec_w, ratio=ratio)
    log(f"  (a) interior-point LBCD, N=30 S=3: one slot capturing its two "
        f"graphs {sec_capture:.2f} s; then {INTERIOR_SLOTS} slots on them "
        f"{sec_i:.2f} s ({out['slots_per_s']:.3f} slots/s); no slot-solver "
        "launch; "
        f"{2 * INTERIOR_EAGER_SLOTS} graph replays of the first "
        f"{INTERIOR_EAGER_SLOTS} slots equal the eager solve exactly "
        f"(eager {out['eager_solve_s']:.3f} s a solve, median; "
        f"{sec_eager:.1f} s in all); mean AoPI {run_i.mean_aopi:.6f} s, "
        f"the water-fill LBCD's {run_w.mean_aopi:.6f} s (repro on the CPU: "
        f"{REFERENCE_PAPER_AOPI['interior']:.6f} and "
        f"{REFERENCE_PAPER_AOPI['waterfill']:.6f}, bar {MEAN_RTOL}; ratio "
        f"{ratio:.4f}, reported; water-fill "
        f"{out['waterfill_slots_per_s']:.3f} slots/s on the kernels); q "
        f"finite (final {q[-1]:.4f}); solver_backend='cuda' with it "
        "refused")
    return out


def frontiers(dev):
    """(b) The rate frontiers (Figs. 3 and 5) on the card: one tensor call
    per frontier over targets x rates x policies, each finite point's AoPI
    at its target, LCFSP min_lam non-increasing in mu, FCFS min_mu with an
    interior minimum in lam."""
    import numpy as np
    import torch
    from repro_torch.core import aopi

    tg = torch.tensor(FRONTIER_TARGETS, device=dev)[:, None, None]
    rates = torch.tensor(FRONTIER_RATES, device=dev)[None, :, None]
    pol = torch.tensor([aopi.FCFS, aopi.LCFSP], dtype=torch.int32,
                       device=dev)[None, None, :]
    out, checked = {}, 0
    for name, fn in (("min_lam", aopi.min_lam_for_target),
                     ("min_mu", aopi.min_mu_for_target)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = fn(tg, rates, FRONTIER_P, pol)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if x.device.type != "cuda" or x.shape != (len(FRONTIER_TARGETS),
                                                  len(FRONTIER_RATES), 2):
            raise AssertionError(f"{name}: {x.shape} on {x.device}")
        if name == "min_lam":
            a = aopi.aopi(x, rates, FRONTIER_P, pol)
            reach = torch.isfinite(x) & (x < 0.999e6)
        else:
            a = aopi.aopi(rates, x, FRONTIER_P, pol)
            reach = torch.isfinite(x)
        err = ((a - tg).abs() / tg)[reach]
        if not reach.any() or float(err.max()) > FRONTIER_TOL:
            raise AssertionError(f"{name}: AoPI off its target by "
                                 f"{float(err.max()):.3e}")
        checked += int(reach.sum())
        out[name] = dict(ms=ms, points=int(reach.sum()),
                         max_rel_err=float(err.max()),
                         values=x.cpu().numpy())
    lam_l = out["min_lam"]["values"][:, :, 1]
    if not (np.diff(lam_l, axis=1) <= 0).all():
        raise AssertionError(f"LCFSP min_lam increases with mu: {lam_l}")
    interior = []
    for i, row in enumerate(out["min_mu"]["values"][:, :, 0]):
        fin = np.isfinite(row)
        if fin.sum() >= 3:
            k = int(np.argmin(row[fin]))
            if 0 < k < fin.sum() - 1:
                interior.append(FRONTIER_TARGETS[i])
    if not interior:
        raise AssertionError("FCFS min_mu has no interior minimum in lam")
    log(f"  (b) rate frontiers, {len(FRONTIER_TARGETS)} targets x "
        f"{len(FRONTIER_RATES)} rates x 2 policies, p {FRONTIER_P}, one call "
        f"each: min_lam {out['min_lam']['ms']:.2f} ms "
        f"({out['min_lam']['points']} reachable points, AoPI within "
        f"{out['min_lam']['max_rel_err']:.2e} of the target), min_mu "
        f"{out['min_mu']['ms']:.2f} ms ({out['min_mu']['points']} points, "
        f"{out['min_mu']['max_rel_err']:.2e}); LCFSP min_lam non-increasing "
        f"in mu; FCFS min_mu has an interior minimum in lam at targets "
        f"{interior}")
    return dict(checked=checked, **{k: {kk: vv for kk, vv in v.items()
                                        if kk != "values"}
                                    for k, v in out.items()})


def failover_check(dev):
    """(c) Island failover on the paper system: the ``auto`` controller
    (config_argmin and waterfill_pair) against the ``torch`` one, bitwise;
    no stream on the dead island; capacities restored."""
    import numpy as np
    import torch
    from repro_torch.core import lbcd, profiles
    from repro_torch.kernels.slot_solver import ops
    from repro_torch.training import failure

    dead = np.array(FAILOVER_DEAD)
    recs, secs, counts = {}, {}, {}
    for backend in ("auto", "torch"):
        ctrl = lbcd.LBCDController(
            profiles.EdgeSystem(n_cameras=30, n_servers=3, seed=0),
            solver_backend=backend, device=dev)
        healthy = ctrl.system.capacities(FAILOVER_SLOT)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs[backend] = failure.failover_assignment(ctrl, FAILOVER_SLOT,
                                                    dead)
        torch.cuda.synchronize()
        secs[backend] = time.perf_counter() - t0
        counts[backend] = dict(ops.launches)
        for x, y in zip(ctrl.system.capacities(FAILOVER_SLOT), healthy):
            if not np.array_equal(x, y):
                raise AssertionError("failover: capacities not restored")
    for k in ("config_argmin", "waterfill_pair"):
        if counts["auto"][k] <= 0:
            raise AssertionError(f"failover (auto): {k} never launched")
    a, b = recs["auto"], recs["torch"]
    if dead[a.assign].any():
        raise AssertionError(f"failover left a stream on island 1: "
                             f"{a.assign}")
    same = (np.array_equal(a.assign, b.assign) and a.q == b.q and all(
        np.array_equal(getattr(a.decision, f.name), getattr(b.decision,
                                                            f.name))
        for f in dataclasses.fields(a.decision)))
    if not same:
        raise AssertionError("failover: the kernels' record differs from "
                             "the plain one")
    log(f"  (c) failover, N=30 S=3, island 1 dead at slot {FAILOVER_SLOT}: "
        f"streams per island {np.bincount(a.assign, minlength=3).tolist()}; "
        f"auto {secs['auto']:.3f} s (launches {counts['auto']}) equals "
        f"torch {secs['torch']:.3f} s bitwise; capacities restored")
    return dict(seconds=secs, launches=counts["auto"])


def launcher_run(dev, argv, label, engine=None, **service_kw):
    """One launcher run on the card through ``launch.serve``: the table
    printed, every epoch's measured AoPI finite; returns the service and
    the wall seconds."""
    import io
    import contextlib

    import numpy as np
    import torch
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if engine is None and not service_kw:
            svc = serve.main(argv, device=dev)
        else:
            args = serve.parse_args(argv, device=dev)
            svc = serve.build_service(args, engine=engine, **service_kw)
            for t in range(args.epochs):
                svc.run_epoch(t)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    for line in buf.getvalue().strip().splitlines():
        log(f"    {line}")
    meas = np.array([r.measured_aopi for r in svc.reports])
    if not np.isfinite(meas).all():
        raise AssertionError(f"launcher {label}: measured AoPI {meas}")
    if svc.plan_failures or svc.fallbacks or svc.degraded_epochs:
        raise AssertionError(f"launcher {label}: plan failures "
                             f"{svc.plan_failures}, fallbacks "
                             f"{svc.fallbacks}")
    return svc, sec


def launcher_phase(dev):
    """(d) ``python -m repro_torch.launch.serve`` through ``main``: mm1 at
    its CLI defaults, then --engine (2 streams) with the attention
    kernels' launches counted."""
    import numpy as np
    from repro_torch.kernels.dataplane import ops as dp_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.slot_solver import ops

    out = {}
    ops.reset_launches()
    dp_ops.reset_launches()
    svc, sec = launcher_run(dev, [], "mm1")
    div = svc.mean_measured / svc.mean_predicted - 1.0
    if abs(div) > CLOSED_FORM_TOL:
        raise AssertionError(f"launcher mm1: measured vs predicted {div:+.4f}"
                             f" (bar {CLOSED_FORM_TOL})")
    if dp_ops.launches["gi_g1_window"] <= 0 or \
            ops.launches["config_argmin"] <= 0:
        raise AssertionError(f"launcher mm1: launches {dp_ops.launches} "
                             f"{ops.launches}")
    out["mm1"] = dict(seconds=sec, epochs=len(svc.reports),
                      divergence=div,
                      launches={**{k: v for k, v in ops.launches.items()
                                   if v}, **dp_ops.launches})
    log(f"  (d) launcher mm1 (16 streams, 4 islands, 8 epochs of 1,200 s): "
        f"{sec:.2f} s ({sec / len(svc.reports):.3f} s an epoch); measured "
        f"vs predicted {div:+.4f} (bar {CLOSED_FORM_TOL}); launches "
        f"{out['mm1']['launches']}")
    for mod in (fa_ops, dec_ops):
        mod.reset_launches()
    argv = ["--engine", "--streams", str(LAUNCHER_ENGINE_STREAMS)]
    svc, sec = launcher_run(dev, argv, "engine")
    if svc.engine_backend != "des":
        raise AssertionError(f"launcher --engine resolved to "
                             f"{svc.engine_backend}: the engine serves no "
                             "frame")
    counts = {"flash_attention": fa_ops.launches["flash_attention"],
              "flash_decode": dec_ops.launches["flash_decode"]}
    if min(counts.values()) <= 0:
        raise AssertionError(f"launcher --engine: {counts}")
    frames = int(sum(r.telemetry.n_completed.sum() for r in svc.reports))
    div = svc.mean_measured / svc.mean_predicted - 1.0
    out["engine"] = dict(seconds=sec, epochs=len(svc.reports),
                         divergence=div, frames=frames, launches=counts)
    log(f"  (d) launcher --engine ({LAUNCHER_ENGINE_STREAMS} streams, "
        f"reduced qwen2.5-3b, 8 epochs of 3 s, {svc.engine_backend}): "
        f"{sec:.2f} s ({sec / len(svc.reports):.3f} s an epoch), {frames} "
        f"frames completed; measured vs predicted {div:+.4f} (a report); "
        f"launches {counts}")
    return out


def core_phase(dev):
    """Phase 9: (a)-(d) above."""
    t0 = time.perf_counter()
    out = dict(interior=interior_lbcd(dev), frontiers=frontiers(dev),
               failover=failover_check(dev), launcher=launcher_phase(dev))
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 9 {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phases 4-5: LM serving at full width and depth (qwen2.5-3b, xlstm-1.3b)
# ---------------------------------------------------------------------------

# Kernel run against plain run, teacher-forced, on f32 logits (|logit| <=
# ~5). qwen2.5-3b: f32 through 36 layers (1e-4 holds at 2 layers on the
# CPU; 2.9e-5 measured). xlstm-1.3b: f32 through its 48 layers of random
# weights is chaotic: a one-ulp change of the input embedding moves the
# plain run's own logits by O(1) (xlstm_rounding measures it), and the
# kernel's rounding differences, ~1e-4 after one period, reach 5.8e-2
# after six (the first full run). So the bar is 0.1 at full depth, and one
# period of the same weights is held to 1e-3.
LOGIT_ATOL = {"qwen2.5-3b": 2e-3, "xlstm-1.3b": 0.1,
              "jamba-1.5-large-398b": 2e-3}
ONE_PERIOD_ATOL = 1e-3
ARGMAX_SHARE = 0.99    # identical greedy tokens, teacher-forced
N_TICKS = 64
# Frames per stream of the engine-rung epochs (a): the service's cap is
# 192; 8 still admits, preempts and completes frames on every stream, and
# keeps phases 4-6 inside the script's time.
ENGINE_FRAMES = 8
# jamba-1.5-large-398b is 1.59 TB of f32 parameters: phase 6 keeps every
# width and serves one period (8 of 72 layers) with 4 of its 16 experts
# (top-2 and the capacity factor kept): 16.25 B parameters, 64.99 GB.
JAMBA_CUT = dict(n_layers=8, n_experts=4)


def kernel_counts(model):
    """Launches per admit and per tick of each LM kernel: flash_attention
    once per attention layer in a prefill, flash_decode once per attention
    layer in a tick, mlstm_chunkwise once per mLSTM layer and
    selective_scan once per Mamba layer in a prefill. Returns (per_admit,
    per_tick) over the kernels the model runs."""
    layers = {kind: model.n_periods * sum(spec.mixer == kind
                                          for spec in model.period)
              for kind in ("attn", "mlstm", "mamba")}
    per_admit = {"flash_attention": layers["attn"], "flash_decode": 0,
                 "mlstm_chunkwise": layers["mlstm"],
                 "selective_scan": layers["mamba"]}
    per_tick = {"flash_attention": 0, "flash_decode": layers["attn"],
                "mlstm_chunkwise": 0, "selective_scan": 0}
    path = [k for k in per_admit if per_admit[k] + per_tick[k] > 0]
    return ({k: per_admit[k] for k in path}, {k: per_tick[k] for k in path})


def timed_shares(eng, prompt, parts):
    """Host time, synchronised around each call, of one admit of
    ``prompt`` and of one tick, and of the calls of ``parts`` ({label:
    (module, function name)}, patched for the two) inside each. Returns
    (admit_s, tick_s, {label: (seconds in the admit, in the tick)})."""
    import torch
    spent = {}

    def timed(label, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
            return res
        return call

    originals = {label: getattr(mod, name)
                 for label, (mod, name) in parts.items()}
    for label, (mod, name) in parts.items():
        setattr(mod, name, timed(label, originals[label]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill_lane(prompt, 0)
        torch.cuda.synchronize()
        admit_s = time.perf_counter() - t0
        in_admit = dict(spent)
        spent.clear()
        t0 = time.perf_counter()
        eng.decode_tick()
        tick_s = time.perf_counter() - t0
    finally:
        for label, (mod, name) in parts.items():
            setattr(mod, name, originals[label])
    return admit_s, tick_s, {label: (in_admit.get(label, 0.0),
                                     spent.get(label, 0.0))
                             for label in parts}


def qwen_shares(eng, prompt):
    """One admit's flash_attention calls as a share of that admit."""
    from repro_torch.models import attention
    admit_s, tick_s, t = timed_shares(eng, prompt, {
        "flash_attention": (attention, "attn_op")})
    out = dict(attn_share=t["flash_attention"][0] / admit_s)
    log(f"  shares (host clock, synchronised around each call): one admit "
        f"of {len(prompt)} tokens {admit_s:.3f} s, its "
        f"{eng.model.n_periods * len(eng.model.period)} flash_attention "
        f"calls {t['flash_attention'][0]:.3f} s "
        f"({100 * out['attn_share']:.1f}%); one tick {1e3 * tick_s:.2f} ms")
    return out


def xlstm_shares(eng, prompt):
    """One admit's sLSTM loops (slstm_apply) and mLSTM kernel calls, and one
    tick's mLSTM state steps (mlstm_step: the in-place update of C and n
    and the read-out), as shares of that admit and that tick."""
    from repro_torch.models import xlstm as xm
    admit_s, tick_s, t = timed_shares(eng, prompt, {
        name: (xm, name) for name in ("slstm_apply", "mlstm", "mlstm_step")})
    out = dict(slstm_share=t["slstm_apply"][0] / admit_s,
               mlstm_kernel_share=t["mlstm"][0] / admit_s,
               state_step_share=t["mlstm_step"][1] / tick_s)
    log(f"  shares (host clock, synchronised around each call): one admit "
        f"of {len(prompt)} tokens {admit_s:.3f} s, sLSTM loops "
        f"{t['slstm_apply'][0]:.3f} s ({100 * out['slstm_share']:.1f}%),"
        f" mlstm_chunkwise calls {t['mlstm'][0]:.3f} s "
        f"({100 * out['mlstm_kernel_share']:.1f}%); one tick "
        f"{1e3 * tick_s:.2f} ms, mLSTM state steps "
        f"{1e3 * t['mlstm_step'][1]:.2f} ms "
        f"({100 * out['state_step_share']:.1f}%)")
    return out


def jamba_shares(eng, prompt):
    """One admit's selective_scan calls and MoE layers, and one tick's
    Mamba decode steps and MoE layers, as shares of that admit and that
    tick."""
    from repro_torch.models import moe, ssm
    admit_s, tick_s, t = timed_shares(eng, prompt, {
        "scan": (ssm, "selective_scan"), "moe": (moe, "moe_apply"),
        "mamba_decode": (ssm, "mamba_decode")})
    out = dict(scan_share=t["scan"][0] / admit_s,
               moe_admit_share=t["moe"][0] / admit_s,
               mamba_step_share=t["mamba_decode"][1] / tick_s,
               moe_tick_share=t["moe"][1] / tick_s)
    log(f"  shares (host clock, synchronised around each call): one admit "
        f"of {len(prompt)} tokens {admit_s:.3f} s, selective_scan calls "
        f"{t['scan'][0]:.3f} s ({100 * out['scan_share']:.1f}%), MoE layers "
        f"{t['moe'][0]:.3f} s ({100 * out['moe_admit_share']:.1f}%); one "
        f"tick {1e3 * tick_s:.2f} ms, Mamba decode steps "
        f"{1e3 * t['mamba_decode'][1]:.2f} ms "
        f"({100 * out['mamba_step_share']:.1f}%), MoE layers "
        f"{1e3 * t['moe'][1]:.2f} ms ({100 * out['moe_tick_share']:.1f}%)")
    return out


def record_routing(records):
    """Patch the MoE router to append, per call, each token's top-k
    experts and the gap between its k-th and (k+1)-th router
    probabilities (on the card); returns the undo function."""
    import torch
    from repro_torch.models import layers, moe

    original = moe._routing

    def routing(params, x, cfg, capacity):
        out = original(params, x, cfg, capacity)
        probs = torch.softmax(layers.einsum("bsd,de->bse", x,
                                            params["router"]).float(), -1)
        top = torch.sort(probs, -1, descending=True).values
        k = cfg.top_k
        records.append((out[0], top[..., k - 1] - top[..., k]))
        return out
    moe._routing = routing

    def undo():
        moe._routing = original
    return undo


def routing_flips(records, n_moe):
    """Compare the routing of the kernel and plain engines' calls, which
    alternate in blocks of ``n_moe`` (one admit or tick of each): the
    tokens whose ordered top-k experts differ, of all routed, and the
    largest plain-run gate gap among them."""
    flips, total, gap = 0, 0, 0.0
    for j in range(0, len(records), 2 * n_moe):
        for i in range(n_moe):
            (ek, _), (ep, gp) = records[j + i], records[j + n_moe + i]
            diff = (ek != ep).any(-1)
            flips += int(diff.sum())
            total += diff.numel()
            if diff.any():
                gap = max(gap, float(gp[diff].max()))
    return flips, total, gap


def one_ulp_nudge(params, dev):
    """``params`` with the embedding table times (1 + 2^-23 u), u = +-1 from
    a fixed seed: a one-ulp change of the model's input."""
    import torch
    table = params["embed"]["table"]
    gen = torch.Generator(device=dev).manual_seed(5)
    sign = torch.randint(0, 2, table.shape, generator=gen, device=dev) * 2 - 1
    return dict(params, embed={"table": table * (1 + sign * 2.0 ** -23)})


def xlstm_rounding(cfg, params, prompt, dev):
    """The xLSTM's sensitivity to rounding, on one lane: the prefill of
    ``prompt`` and 8 decode steps fed the prompt's first 8 tokens. (1) The
    kernel against the plain version over one period (8 layers) of the
    same weights, held to ONE_PERIOD_ATOL. (2) The plain run at full depth
    against itself with its embedding table times (1 + 2^-23 u), u = +-1
    (a one-ulp change of the input)."""

    import numpy as np
    import torch
    from repro_torch import models
    from repro_torch.serving import Engine

    def run(model, prm):
        eng = Engine(model, prm, n_lanes=1, max_len=4096, device=dev)
        logits = [eng.prefill_lane(prompt, 0)]
        for tok in prompt[:8]:
            logits.append(eng.decode_logits(np.array([tok], np.int32))[0])
        return torch.stack(logits)

    def first_period(tree):
        if isinstance(tree, dict):
            return {k: first_period(v) for k, v in tree.items()}
        return tree[:1]

    one = dataclasses.replace(cfg, n_layers=cfg.slstm_period)
    one_params = dict(params, blocks=first_period(params["blocks"]))
    err_one = float((run(models.build(one), one_params)
                     - run(models.build(one, impl="torch"), one_params))
                    .abs().max())
    plain = models.build(cfg, impl="torch")
    sens = float((run(plain, one_ulp_nudge(params, dev))
                  - run(plain, params)).abs().max())
    log(f"  rounding: kernel vs plain over one period ({one.n_layers} "
        f"layers), prefill of {len(prompt)} tokens and 8 decode steps: max "
        f"abs logit err {err_one:.3e} (bar {ONE_PERIOD_ATOL}); the plain "
        f"run at {cfg.n_layers} layers against itself with a one-ulp "
        f"change of its input embedding: {sens:.3e}")
    if err_one > ONE_PERIOD_ATOL:
        raise AssertionError("xLSTM one period: kernel run outside the bar "
                             "against the plain run")
    return dict(one_period_err=err_one, one_ulp_sensitivity=sens)


def serve_lm(dev, name, cut=None, launcher=False):
    """Serve ``name`` at full width (and depth, unless ``cut`` replaces
    fields of its config) through the port's Engine:
    (a) the engine rung of the service (measure_engine_epoch, 8 streams,
    FCFS and LCFSP), (b) long ragged prompts and 64 decode ticks, timed,
    then held teacher-forced against the impl="torch" engine. Every kernel
    of the model must launch in (a) and (b), in (b) exactly as often as
    its layers ask. With ``launcher``, the serving launcher's service
    (``launch.serve.build_service``) then runs over an Engine of these
    parameters. Returns the launch counts of (a) and (b) and the measured
    numbers."""
    import collections

    import numpy as np
    import torch
    from repro_torch import configs, models
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm import ops as ml_ops
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.serving import (Engine, Frame, engine_plane,
                                     make_replay_engine)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the reference's products "
                             "are full f32")
    all_ops = (fa_ops, dec_ops, ml_ops, ss_ops)
    cfg = configs.get(name)
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.build(cfg)
    params = models.common.init_params(
        model.template(), torch.Generator(device=dev).manual_seed(0),
        device=dev)
    torch.cuda.synchronize()
    per_admit, per_tick = kernel_counts(model)

    def reset():
        for mod in all_ops:
            mod.reset_launches()

    def counts():
        merged = {}
        for mod in all_ops:
            merged.update(mod.launches)
        return {k: merged[k] for k in per_admit}

    def need_all(label, c):
        if min(c.values()) <= 0:
            raise AssertionError(f"{label}: a kernel never launched: {c}")

    def need_exact(label, c, admits, ticks):
        want = {k: admits * per_admit[k] + ticks * per_tick[k] for k in c}
        if c != want:
            raise AssertionError(f"{label}: launches {c}, expected {want}")

    n_params = model.param_count()
    mixers = collections.Counter(spec.mixer for spec in model.period)
    n_moe = model.n_periods * sum(spec.ffn == "moe" for spec in model.period)
    log(f"  {name}: {cfg.n_layers} layers ("
        + ", ".join(f"{model.n_periods * n} {kind}"
                    for kind, n in mixers.items())
        + (f"; {n_moe} MoE FFNs of {cfg.n_experts} experts, top "
           f"{cfg.top_k}" if n_moe else "")
        + f"), d_model {cfg.d_model}, {cfg.n_heads} heads, vocab "
        f"{cfg.vocab} (padded {cfg.padded_vocab}); {n_params / 1e9:.4f} B "
        f"parameters in f32 ({4 * n_params / 1e9:.2f} GB), initialised on "
        f"the card in {time.perf_counter() - t0:.2f} s; kernel launches "
        f"per admit {per_admit}, per tick {per_tick}")

    # (a) The service's engine rung: frames of 6 tokens, 8 decode tokens.
    n = 8
    lam, mu, p = np.full(n, 0.6), np.full(n, 2.0), np.full(n, 0.8)
    pol = np.arange(n) % 2
    kw = dict(epoch_duration=60.0, seed=0, t=0, frames_cap=ENGINE_FRAMES,
              delay_model="mm1", collect_trace=True)
    eng = Engine(model, params, n_lanes=8, max_len=4096, decode_tokens=8,
                 device=dev)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = engine_plane.measure_engine_epoch(eng, lam, mu, p, pol, **kw)
    torch.cuda.synchronize()
    sec_a = time.perf_counter() - t0
    counts_a = counts()
    need_all(f"{name} (a) measure_engine_epoch", counts_a)
    replay = engine_plane.measure_engine_epoch(
        make_replay_engine(8, decode_tokens=8, device=dev), lam, mu, p, pol,
        **kw)
    for key in stats:
        if (stats[key] != replay[key] if key == "trace" else
                not np.array_equal(stats[key], replay[key])):
            raise AssertionError(f"{name} (a): {key} differs from the "
                                 "replay engine's epoch")
    log(f"  (a) measure_engine_epoch, 8 streams (4 FCFS, 4 LCFSP), "
        f"frames_cap {ENGINE_FRAMES}: {sec_a:.2f} s, "
        f"{int(stats['n_frames'].sum())} frames, "
        f"{int(stats['n_completed'].sum())} completed, "
        f"{int(stats['preempts'].sum())} preemptions, "
        f"{int(stats['engine_steps'])} decode ticks; mean AoPI "
        f"{stats['aopi'].mean():.5f} s, equal to the replay engine's epoch "
        f"in every statistic; launches {counts_a}")
    del eng

    # (b) Long ragged prompts, then N_TICKS decode ticks, timed.
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n_tok).astype(np.int32)
               for n_tok in PROMPT_LENS]
    eng_b = Engine(model, params, n_lanes=8, max_len=4096,
                   decode_tokens=N_TICKS + 2, device=dev)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        if not eng_b.admit(Frame(i, 0.0, 0.0), prompt):
            raise AssertionError(f"{name} (b): admit {i} refused")
    torch.cuda.synchronize()
    sec_prefill = time.perf_counter() - t0
    need_exact(f"{name} (b) admits", counts(), len(prompts), 0)
    tick_s = []
    for _ in range(N_TICKS):
        t0 = time.perf_counter()
        if eng_b.decode_tick():
            raise AssertionError(f"{name} (b): a lane finished early")
        tick_s.append(time.perf_counter() - t0)
    counts_b = counts()
    need_all(f"{name} (b) admits and ticks", counts_b)
    need_exact(f"{name} (b) admits and ticks", counts_b, len(prompts),
               N_TICKS)
    served = np.array([lane.out for lane in eng_b.lanes])
    wall, busy = profile_slot(eng_b.decode_tick, "one decode tick (b)",
                              watch=[k for k, n in per_tick.items() if n])
    ms_tick = 1e3 * float(np.mean(tick_s))
    out = dict(
        counts_a=counts_a, counts_b=counts_b, sec_a=sec_a,
        prefill_tok_s=sum(PROMPT_LENS) / sec_prefill,
        ms_tick=ms_tick, decode_tok_s=8 / (ms_tick / 1e3),
        busy_share=busy / (wall * 1e3))
    log(f"  (b) 8 admits of {list(PROMPT_LENS)} tokens: {sec_prefill:.3f} s,"
        f" {out['prefill_tok_s']:.1f} prefill tokens/s; {N_TICKS} ticks: "
        f"{ms_tick:.2f} ms per tick (median {1e3 * np.median(tick_s):.2f}), "
        f"{out['decode_tok_s']:.1f} decode tokens/s; device busy "
        f"{100 * out['busy_share']:.1f}% of one profiled tick; padded "
        f"vocabulary ids among {served.size} served tokens: "
        f"{int((served >= cfg.vocab).sum())}; launches {counts_b}, as the "
        "layers ask")
    if set(mixers) == {"attn"}:
        out.update(qwen_shares(eng_b, prompts[-1]))
    if "slstm" in mixers:
        out.update(xlstm_shares(eng_b, prompts[-1]))
    if "mamba" in mixers:
        out.update(jamba_shares(eng_b, prompts[-1]))
    del eng_b

    # Teacher-forced: the kernel engine's tokens feed both engines. For the
    # xLSTM a third engine, the plain one with a one-ulp change of its input
    # embedding, is fed them too: its agreement with the plain engine is
    # what rounding alone leaves of the argmax bar (a report, not a bar).
    eng_k = Engine(model, params, n_lanes=8, max_len=4096, device=dev)
    eng_p = Engine(models.build(cfg, impl="torch"), params, n_lanes=8,
                   max_len=4096, device=dev)
    eng_n = (Engine(models.build(cfg, impl="torch"),
                    one_ulp_nudge(params, dev), n_lanes=8, max_len=4096,
                    device=dev)
             if "slstm" in mixers else None)
    errs_n, same_n = [], 0
    errs, same, total = [], 0, 0
    last = np.zeros(8, np.int32)
    routes = []
    undo = record_routing(routes) if n_moe else (lambda: None)
    for lane, prompt in enumerate(prompts):
        lk = eng_k.prefill_lane(prompt, lane)
        lp = eng_p.prefill_lane(prompt, lane)
        errs.append(float((lk - lp).abs().max()))
        last[lane] = int(torch.argmax(lk))
        same += int(last[lane] == int(torch.argmax(lp)))
        total += 1
        if eng_n is not None:
            ln = eng_n.prefill_lane(prompt, lane)
            errs_n.append(float((ln - lp).abs().max()))
            same_n += int(int(torch.argmax(ln)) == int(torch.argmax(lp)))
    forced = [last.copy()]
    for _ in range(N_TICKS):
        lk = eng_k.decode_logits(last)
        lp = eng_p.decode_logits(last)
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"{name} teacher-forced: non-finite logits")
        errs.append(float((lk - lp).abs().max()))
        nk, npl = torch.argmax(lk, -1), torch.argmax(lp, -1)
        same += int((nk == npl).sum())
        total += nk.numel()
        if eng_n is not None:
            ln = eng_n.decode_logits(last)
            errs_n.append(float((ln - lp).abs().max()))
            same_n += int((torch.argmax(ln, -1) == npl).sum())
        last = nk.cpu().numpy().astype(np.int32)
        forced.append(last.copy())
    undo()
    share = same / total
    replayed = int((np.stack(forced, 1) == served[:, :N_TICKS + 1]).sum())
    atol = LOGIT_ATOL[name]
    log(f"  teacher-forced kernel vs impl='torch' engine: max abs logit err "
        f"{max(errs):.3e} (prefill {max(errs[:8]):.3e}, decode "
        f"{max(errs[8:]):.3e}; bar {atol}); identical argmax on "
        f"{same}/{total} = {share:.4f} (bar {ARGMAX_SHARE}); the kernel "
        f"engine's greedy tokens repeat run (b)'s on {replayed}/"
        f"{8 * (N_TICKS + 1)}")
    if eng_n is not None:
        out.update(nudged_argmax_share=same_n / total,
                   nudged_max_logit_err=max(errs_n))
        log(f"  teacher-forced plain engine vs itself with a one-ulp change "
            f"of its input embedding: max abs logit err {max(errs_n):.3e}; "
            f"identical argmax on {same_n}/{total} = {same_n / total:.4f}")
    if n_moe:
        flips, routed, gap = routing_flips(routes, n_moe)
        out.update(routing_flips=flips, routed=routed)
        log(f"  routing, kernel vs plain engine: {flips} of {routed} top-"
            f"{cfg.top_k} decisions differ over the {n_moe} MoE layers; "
            f"largest gate gap (k-th minus next probability, plain run) "
            f"among them {gap:.3e}")
    if max(errs) > atol or share < ARGMAX_SHARE:
        raise AssertionError(f"{name} teacher-forced: kernel run outside "
                             "the bar against the plain run")
    out.update(max_logit_err=max(errs), argmax_share=share)
    if "slstm" in mixers:
        del eng_k, eng_p, eng_n
        out.update(xlstm_rounding(cfg, params, prompts[0], dev))
    if launcher:
        out["launcher"] = full_width_launcher(dev, model, params, reset,
                                              counts)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak device memory {out['peak_gb']:.2f} GB")
    return out


def full_width_launcher(dev, model, params, reset, counts):
    """The launcher's service (``launch.serve.build_service``, --engine)
    over an Engine of the full-width model: LAUNCHER_FULL_STREAMS
    streams, LAUNCHER_FULL_EPOCHS epochs of 3 s, LAUNCHER_FULL_FRAMES
    frames a stream. Both attention kernels must launch."""
    from repro_torch.serving import Engine

    eng = Engine(model, params, n_lanes=8, max_len=4096, decode_tokens=2,
                 device=dev)
    reset()
    argv = ["--engine", "--streams", str(LAUNCHER_FULL_STREAMS),
            "--epochs", str(LAUNCHER_FULL_EPOCHS)]
    svc, sec = launcher_run(dev, argv, "full width", engine=eng,
                            engine_frames_cap=LAUNCHER_FULL_FRAMES)
    launched = counts()
    if min(launched.values()) <= 0:
        raise AssertionError(f"full-width launcher: {launched}")
    frames = int(sum(r.telemetry.n_completed.sum() for r in svc.reports))
    log(f"  launcher --engine over this engine ({LAUNCHER_FULL_STREAMS} "
        f"streams, {LAUNCHER_FULL_EPOCHS} epochs of 3 s, frame cap "
        f"{LAUNCHER_FULL_FRAMES}, {svc.engine_backend}): {sec:.2f} s, "
        f"{frames} frames completed; launches {launched}")
    return dict(seconds=sec, frames=frames, launches=launched)


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
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import baselines, bcd, energy, lbcd, profiles
    from repro_torch.kernels import _build
    from repro_torch.kernels.dataplane import kernel as dp_kernel
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm import kernel as ml_kernel
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.slot_solver import kernel, ops

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"== phase 1: card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libraries = {"slot_solver": (kernel.SOURCES, _build.NVCC_FLAGS),
                 "flash_attention": (fa_kernel.SOURCES,
                                     _build.ATTENTION_FLAGS),
                 "flash_decode": (dec_kernel.SOURCES,
                                  _build.ATTENTION_FLAGS),
                 "mlstm_chunkwise": (ml_kernel.SOURCES,
                                     _build.ATTENTION_FLAGS),
                 "selective_scan": (ss_kernel.SOURCES, _build.NVCC_FLAGS),
                 "dataplane": (dp_kernel.SOURCES, _build.NVCC_FLAGS)}
    with ThreadPoolExecutor(len(libraries)) as pool:   # one nvcc each
        futures = {name: pool.submit(_build.build, name, *args)
                   for name, args in libraries.items()}
        lib_paths = {name: f.result() for name, f in futures.items()}
    for lib in (kernel, fa_kernel, dec_kernel, ml_kernel, ss_kernel,
                dp_kernel):
        lib.load()
    log(f"  build: {time.perf_counter() - t0:.2f} s -> "
        + ", ".join(p.name for p in lib_paths.values()))
    for lib_path in lib_paths.values():
        log_path = lib_path.with_suffix(".log")
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")

    log(f"== phase 2 (at {time.perf_counter() - t_start:.0f} s): kernels "
        "vs plain versions on the card")
    small = check_kernels(kernel_inputs(30, 3, 0, dev), "N=30 S=3",
                          timing=True)
    big = check_kernels(kernel_inputs(10_000, 32, 1, dev), "N=10000 S=32",
                        timing=True)
    virt = check_kernels(kernel_inputs(10_000, 1, 3, dev,
                                       server_id=[0] * 10_000),
                         "N=10000 S=1", timing=True)
    edge_cases = {
        "empty server": kernel_inputs(
            9, 3, 4, dev, server_id=[0, 0, 0, 2, 2, 0, 2, 0, 2]),
        "single-camera servers": kernel_inputs(6, 6, 5, dev,
                                               server_id=list(range(6))),
        "slack budget": kernel_inputs(8, 2, 6, dev, budget_scale=300.0,
                                      lcfsp_frac=0.0),
        "ragged N=1001 S=7": kernel_inputs(1001, 7, 7, dev),
    }
    for label, d in edge_cases.items():
        check_kernels(d, label, timing=False)

    # waterfill_tiled: MIN's virtual server at auto's tile (G=128), S=32
    # at auto's tile (G=4), and the edge cases split over 2, 16 and 128
    # CTAs (the tile picks the kernel, the sizes its team).
    big_n = 100_000
    auto_tile = bcd.DEFAULT_TILE_N
    tiled_virt = check_tiled(
        kernel_inputs(big_n, 1, 8, dev, server_id=[0] * big_n),
        "N=100000 S=1", ops.tiled_group(big_n, 1, auto_tile), timing=True)
    d32 = kernel_inputs(big_n, 32, 9, dev)
    tiled_32 = check_tiled(d32, "N=100000 S=32",
                           ops.tiled_group(big_n, 32, auto_tile),
                           timing=True)
    for label, d in edge_cases.items():
        for group in (2, 16, kernel.MAX_GROUP):
            check_tiled(d, label, group, timing=False)
    for name in ("waterfill_kernel", "waterfill_pair_kernel",
                 "waterfill_tiled_kernel"):
        for line in build_usage("slot_solver", kernel, _build.NVCC_FLAGS,
                                name, {name: name}):
            log(f"  {line}")

    # baseline_argmax: DOS (w=1) and JCAB (cap 0.5) at N=100,000, JCAB with
    # every config infeasible (cap 1e-6: the min-latency fallback), ragged.
    d_bl = kernel_inputs(big_n, 32, 10, dev)
    dos = check_baseline(d_bl, "N=100000", "dos", 1.0, timing=True)
    jcab = check_baseline(d_bl, "N=100000", "jcab", 0.5, timing=True)
    check_baseline(d_bl, "N=100000", "jcab", 1e-6, timing=False)
    for mode, thr in (("dos", 1.0), ("jcab", 0.5), ("jcab", 1e-6)):
        check_baseline(edge_cases["ragged N=1001 S=7"], "ragged N=1001",
                       mode, thr, timing=False)
    check_planted_ties(dev)
    scan_floors(lib_paths["slot_solver"], kernel, big["config_argmin"], dos,
                jcab, dev)
    attn = check_attention(dev)
    mlstm = check_mlstm(dev)
    scan = check_scan(dev)
    dp_timed = dataplane_kernels(dev)

    log(f"== phase 3 (at {time.perf_counter() - t_start:.0f} s): end to end")

    def system(n, s, n_slots):
        """The paper's per-camera share of bandwidth and compute."""
        share = n / (10 * s)
        return dict(n_cameras=n, n_servers=s, n_slots=n_slots,
                    mean_bandwidth_hz=30e6 * share,
                    mean_compute_flops=50e12 * share, seed=0)

    def lbcd_ctl(kw, backend):
        return lambda: lbcd.LBCDController(
            profiles.EdgeSystem(**kw), v=10.0, p_min=0.7,
            solver_backend=backend, device=dev)

    def baseline_ctl(name, kw, backend):
        return lambda: baselines.make(name, profiles.EdgeSystem(**kw),
                                      solver_backend=backend, device=dev)

    launches = {}

    def path(label, make_ctl, n_slots, kernels_of_path):
        """Drive one path with the counters zeroed just before and read
        just after; every kernel of the path must have launched."""
        ops.reset_launches()
        summary, sec = drive(make_ctl, n_slots)
        counts = dict(ops.launches)
        launches[label] = counts
        missing = [k for k in kernels_of_path if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched: "
                                 f"{counts}")
        log(f"  {label}: {sec:.2f} s, {n_slots / sec:.3f} slots/s, "
            f"launches {counts}")
        return summary, sec

    def plain(label, make_ctl, n_slots):
        summary, sec = drive(make_ctl, n_slots)
        log(f"  {label} plain (torch): {sec:.2f} s, "
            f"{n_slots / sec:.3f} slots/s")
        return summary

    def head(summary, k):
        return lbcd.RunSummary(summary.records[:k], summary.v, summary.p_min)

    big_sys = system(10_000, 32, 2)
    run_k, _ = path("LBCD N=10000 S=32 T=2", lbcd_ctl(big_sys, "auto"), 2,
                    ("config_argmin", "waterfill_pair"))
    run_p = plain("LBCD N=10000 S=32 T=2", lbcd_ctl(big_sys, "torch"), 2)
    err_big = contract("N=10000 rollout vs plain", run_k, run_p)
    split = split_times(big_sys, 2, dev)
    log("  per-slot split (default backend, s): " +
        ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    run_t, _ = path("LBCD N=10000 S=32 T=2 auto:tile=256",
                    lbcd_ctl(big_sys, "auto:tile=256"), 2,
                    ("config_argmin", "waterfill_tiled"))
    contract("N=10000 tile=256 vs plain", run_t, head(run_p, 2))

    paper = dict(n_cameras=30, n_servers=3, n_slots=25, seed=0)
    run_n, _ = path("N=30 S=3 T=25 auto:nofuse",
                    lbcd_ctl(paper, "auto:nofuse"), 25,
                    ("config_argmin", "waterfill"))
    path("N=30 S=3 T=25 auto (fused)", lbcd_ctl(paper, "auto"), 25,
         ("config_argmin", "waterfill_pair"))
    run_pp = plain("N=30 S=3 T=25", lbcd_ctl(paper, "torch"), 25)
    err_paper = contract("N=30 nofuse vs plain", run_n, run_pp)
    log(f"  slot-mean AoPI max rel diff vs plain: N=10000 {err_big:.2e}, "
        f"N=30 {err_paper:.2e}; mean AoPI N=10000 {run_k.mean_aopi:.5f} s, "
        f"N=30 {run_n.mean_aopi:.5f} s; mean accuracy N=10000 "
        f"{run_k.mean_acc:.4f}")

    def energy_ctl(backend):
        return lambda: energy.EnergyAwareLBCD(
            profiles.EdgeSystem(**paper), energy=energy.EnergyModel(),
            v=10.0, p_min=0.7, solver_backend=backend, device=dev)

    run_e, _ = path("energy N=30 S=3 T=25", energy_ctl("auto"), 25,
                    ("config_argmin", "waterfill_pair"))
    z = np.array([r.z for r in run_e.records])
    if not (z > 0).any():
        raise AssertionError("energy: z never rose above 0")
    # The plain ladder costs ~26 plain solves per slot: held over 3 slots.
    run_ep = plain("energy N=30 S=3 T=3", energy_ctl("torch"), 3)
    contract("energy vs plain (first 3 slots)", head(run_e, 3), run_ep)
    np.testing.assert_allclose([r.z for r in run_e.records[:3]],
                               [r.z for r in run_ep.records], rtol=1e-6)
    log(f"  energy: z > 0 in {int((z > 0).sum())}/25 slots (final z "
        f"{z[-1]:.4f}), mean power {np.mean([r.power for r in run_e.records]):.4f}"
        f" W per camera, mean AoPI {run_e.mean_aopi:.5f} s")

    sys100 = system(big_n, 32, 4)
    run_min, sec_min = path("MIN N=100000 S=32 T=2",
                            baseline_ctl("MIN", sys100, "auto"), 2,
                            ("config_argmin", "waterfill_tiled"))
    pooled = profiles.EdgeSystem(**sys100).horizon_numpy(2)
    used = [(np.sum(r.decision.b, dtype=np.float64)
             / np.sum(pooled["budgets_b"][t]),
             np.sum(r.decision.c, dtype=np.float64)
             / np.sum(pooled["budgets_c"][t]))
            for t, r in enumerate(run_min.records)]
    log(f"  MIN N=100000: {2 / sec_min:.3f} slots/s; share of the pooled "
        "budgets used per slot (bandwidth, compute): "
        + ", ".join(f"({b:.6g}, {c:.6g})" for b, c in used)
        + " -- far from (1, 1), the water-fill's dual search stops short "
        "at this N, so these times are those of a search that ends early")
    identical("MIN N=100000", run_min,
              plain("MIN N=100000 S=32 T=2",
                    baseline_ctl("MIN", sys100, "torch"), 2))
    run_jcab, _ = path("JCAB N=100000 S=32 T=4",
                       baseline_ctl("JCAB", sys100, "auto"), 4,
                       ("baseline_argmax",))
    identical("JCAB N=100000", run_jcab,
              plain("JCAB N=100000 S=32 T=4",
                    baseline_ctl("JCAB", sys100, "torch"), 4))
    dos_sys = system(10_000, 32, 2)
    run_dos, _ = path("DOS N=10000 S=32 T=2",
                      baseline_ctl("DOS", dos_sys, "auto"), 2,
                      ("baseline_argmax",))
    identical("DOS N=10000", run_dos,
              plain("DOS N=10000 S=32 T=2",
                    baseline_ctl("DOS", dos_sys, "torch"), 2))
    log(f"  mean AoPI (s): MIN N=100000 {run_min.mean_aopi:.5f}, JCAB "
        f"N=100000 {run_jcab.mean_aopi:.5f}, DOS N=10000 "
        f"{run_dos.mean_aopi:.5f}, LBCD N=10000 {run_k.mean_aopi:.5f}")

    tab100 = profiles.EdgeSystem(**sys100).horizon(1, device=dev)
    for label, fn in (
            ("MIN N=100000 one slot",
             lambda: baselines.rollout_min(tab100, device=dev)),
            ("JCAB N=100000 one slot",
             lambda: baselines.rollout_jcab(tab100, device=dev))):
        fn()                                   # warm-up
        profile_slot(fn, label)

    bcd.release_graphs()                 # the plain solves' memory pools
    torch.cuda.empty_cache()
    log(f"== phase 4 (at {time.perf_counter() - t_start:.0f} s): LM serving "
        "(qwen2.5-3b, full width and depth)")
    lm = serve_lm(dev, "qwen2.5-3b", launcher=True)
    torch.cuda.empty_cache()

    log(f"== phase 5 (at {time.perf_counter() - t_start:.0f} s): xLSTM "
        "serving (xlstm-1.3b, full width and depth)")
    xl = serve_lm(dev, "xlstm-1.3b")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"== phase 6 (at {time.perf_counter() - t_start:.0f} s): hybrid "
        "serving (jamba-1.5-large-398b, full width, "
        f"cut {JAMBA_CUT}); {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "still allocated")
    jamba = serve_lm(dev, "jamba-1.5-large-398b", cut=JAMBA_CUT)

    gc.collect()
    torch.cuda.empty_cache()
    log(f"== phase 7 (at {time.perf_counter() - t_start:.0f} s): scenario "
        "sweep (the full suite, all four policies)")
    sweep = sweep_phase(dev)

    bcd.release_graphs()
    torch.cuda.empty_cache()
    log(f"== phase 8 (at {time.perf_counter() - t_start:.0f} s): the data "
        "plane (AnalyticsService, the tick scan, the sweep's replay)")
    dplane = dataplane_phase(dev, dp_timed)

    bcd.release_graphs()
    torch.cuda.empty_cache()
    log(f"== phase 9 (at {time.perf_counter() - t_start:.0f} s): the rest "
        "of core/ (interior-point LBCD, rate frontiers), island failover "
        "and the serving launcher")
    core = core_phase(dev)

    for module in ("repro_torch.obs", "repro_torch.obs.report",
                   "repro_torch.training.failure",
                   "repro_torch.launch.serve",
                   "repro_torch.faults", "repro_torch.scenarios",
                   "repro_torch.serving.service",
                   "repro_torch.serving.replay",
                   "repro_torch.serving.tick_plane",
                   "repro_torch.core.threefry"):
        if module not in sys.modules:
            raise AssertionError(f"{module} was not imported")
    if "jax" in sys.modules or any(m.split(".")[0] == "repro"
                                   for m in sys.modules):
        raise AssertionError("chip_smoke imported jax or repro")

    main_path = {"config_argmin": "LBCD N=10000 S=32 T=2",
                 "waterfill_pair": "LBCD N=10000 S=32 T=2",
                 "waterfill": "N=30 S=3 T=25 auto:nofuse",
                 "waterfill_tiled": "MIN N=100000 S=32 T=2",
                 "baseline_argmax": "JCAB N=100000 S=32 T=4"}
    slots = {"LBCD N=10000 S=32 T=2": 2, "N=30 S=3 T=25 auto:nofuse": 25,
             "MIN N=100000 S=32 T=2": 2, "JCAB N=100000 S=32 T=4": 4}
    counts = {k: launches[label][k] for k, label in main_path.items()}
    log("  launches per slot: " + ", ".join(
        f"{k} {counts[k] / slots[main_path[k]]:g} ({main_path[k]})"
        for k in counts))

    src = "src/repro_torch/kernels/slot_solver/csrc/slot_solver.cu"
    pallas = "src/repro/kernels/slot_solver/kernel.py"
    replaces = {"config_argmin": f"{pallas}:118", "waterfill": f"{pallas}:259",
                "waterfill_pair": f"{pallas}:333",
                "waterfill_tiled": f"{pallas}:527",
                "baseline_argmax": f"{pallas}:623"}
    timed = {"config_argmin": big["config_argmin"],
             "waterfill_pair": big["waterfill_pair"],
             "waterfill": small["waterfill"],
             "waterfill_tiled": tiled_virt, "baseline_argmax": jcab}
    errs = {name: max(x[name]["max_abs_err"] for x in (small, big, virt))
            for name in ("config_argmin", "waterfill", "waterfill_pair")}
    errs.update(waterfill_tiled=max(tiled_virt["max_abs_err"],
                                    tiled_32["max_abs_err"]),
                baseline_argmax=max(dos["max_abs_err"], jcab["max_abs_err"]))
    timed["config_argmin"]["n30_device_ms"] = small["config_argmin"][
        "device_ms"]
    kernels = []
    for name in main_path:
        r = timed[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces[name],
            launches=counts[name], max_abs_err=errs[name], ms=r["ms"],
            device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            sweep_launches=sweep["launches"][name],
            launcher_launches=core["launcher"]["mm1"]["launches"].get(
                name, 0),
            failover_launches=core["failover"]["launches"][name],
            **{k: r[k] for k in ("team", "lanes", "cold_device_ms",
                                 "issue_floor_ms", "sass_loop",
                                 "n30_device_ms") if k in r}))
    # The LM kernels: launches from the engine rung of the model that runs
    # them, phase 4 (a), 5 (a) or 6 (a).
    lm_kernels = {
        "flash_attention": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:83", attn, lm),
        "flash_decode": (
            "src/repro_torch/kernels/decode_attention/csrc/flash_decode.cu",
            "src/repro/kernels/decode_attention/kernel.py:65", attn, lm),
        "mlstm_chunkwise": (
            "src/repro_torch/kernels/mlstm/csrc/mlstm_chunkwise.cu",
            "src/repro/kernels/mlstm/kernel.py:80", mlstm, xl),
        "selective_scan": (
            "src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu",
            "src/repro/kernels/selective_scan/kernel.py:52", scan, jamba)}
    for name, (source, replaced, timed_lm, served) in lm_kernels.items():
        r = timed_lm[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaced,
            launches=served["counts_a"][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("tc_bound_ms", "n_split", "passes",
                                 "tiling", "lanes") if k in r}))
        if name in core["launcher"]["engine"]["launches"]:
            kernels[-1]["launcher_launches"] = core["launcher"]["engine"][
                "launches"][name]
            kernels[-1]["full_width_launcher_launches"] = lm["launcher"][
                "launches"][name]
    # The data-plane kernels: no TPU kernel; each replaces a lax.scan of
    # the JAX package. Launches from phase 8's main path.
    dp_src = "src/repro_torch/kernels/dataplane/csrc/dataplane.cu"
    dp_replaces = {"gi_g1_window": "src/repro/core/queues.py:330",
                   "tick_scan": "src/repro/serving/tick_plane.py:94"}
    for name, replaced in dp_replaces.items():
        r = dplane["timed"][name]
        kernels.append(dict(
            name=name, route="cuda", source=dp_src, replaces=replaced,
            launches=dplane["launches"][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            chain_floor_ms=r["chain_floor_ms"], tpu_kernel=None,
            run_launches={k: v["launches"][name]
                          for k, v in dplane["runs"].items()},
            launcher_launches=core["launcher"]["mm1"]["launches"].get(
                name, 0),
            **{k: r[k] for k in ("service_window_ms", "sweep_window_ms",
                                 "engine_epoch_ms", "host_draw_s")
               if k in r}))
    log("  timed shapes: config_argmin and waterfill_pair at N=10000 S=32 "
        "(loop effort), waterfill at N=30 S=3 (bandwidth, loop effort), "
        f"waterfill_tiled at N=100000 S=1 (bandwidth, loop effort, team "
        f"{tiled_virt['team']}), baseline_argmax at N=100000 (jcab, cap "
        "0.5); virtual-server pair at N=10000 S=1 (team "
        f"{virt['waterfill_pair']['team']}): "
        f"{virt['waterfill_pair']['ms']:.4f} ms, "
        f"{virt['waterfill_pair']['device_ms']} ms on the device; "
        f"baseline_argmax dos at N=100000: {dos['ms']:.4f} ms; "
        f"waterfill_tiled at N=100000 S=32 (team {tiled_32['team']}): "
        f"{tiled_32['ms']:.4f} ms, {tiled_32['device_ms']} ms on the "
        "device; "
        "flash_attention at b=1 s=t=2048 h=16 kvh=2 d=128 f32 (s=6: "
        f"{attn['flash_attention s=6']['ms']:.4f} ms, s=192: "
        f"{attn['flash_attention s=192']['ms']:.4f} ms); flash_decode at "
        f"b=8 t=4096 h=16 kvh=2 d=128 f32, kv_len {list(PROMPT_LENS)}; "
        "mlstm_chunkwise at b=1 s=2048 h=4 d=1024 f32 (s=6: "
        f"{mlstm['s=6']['ms']:.4f} ms, s=3072: {mlstm['s=3072']['ms']:.4f} "
        "ms); selective_scan at b=1 s=2048 inner=16384 n=16 f32 (s=6: "
        f"{scan['s=6']['ms']:.4f} ms, s=3072: {scan['s=3072']['ms']:.4f} "
        f"ms); LM launches (b): {lm['counts_b']}, {xl['counts_b']}, "
        f"{jamba['counts_b']}; gi_g1_window at E={CHECK_WINDOW[0]} "
        f"N={CHECK_WINDOW[1]} F={CHECK_WINDOW[2]} f64 (a sweep cell's "
        f"window), tick_scan at S={CHECK_EPOCH[0]} F={CHECK_EPOCH[1]} "
        "(the engine rung's shortest epoch)")
    log(f"  chip_smoke: {time.perf_counter() - t_start:.1f} s, the kernels' "
        "build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
