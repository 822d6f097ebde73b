#!/usr/bin/env python3
"""The port's multi-device half on four cards of one host (NCCL).

    python3 scripts/mesh_cards.py [--only yi34b,train,dbrx,qwen_split,
                                          jamba_split,xlstm,xlstm_heads,
                                          mla,vlm,encdec,sp,launcher,
                                          phase12]

Spawns one rank per card (four; a FileStore rendezvous, no port), each
on its card, and runs:

  yi34b     mesh (1, 4): yi-34b at full width and depth (60 layers, f32,
            137.6 GB, which no one card holds: 34.4 GB a card), its
            slices drawn on each card (``models.common.init_sharded``),
            served in ``plan_cell``'s serving layout (no FSDP split): a
            prefill of 2 x
            1,024 tokens and 16 greedy decode steps through ``plan_cell``
            on the kernels, teacher-forced against ``impl="torch"`` on
            the same mesh (phase 10's bars: logits within 2e-3, >= 99% of
            the argmax tokens equal); launches of both attention kernels;
  train     mesh (2, 2): qwen2.5-3b cut to 8 layers in f32 (phase 11 (b)'s
            cut, batch 4 x 512, 2 microbatches, the FSDP gather hoisted):
            the planned train step against ``make_train_step`` on one
            card (loss within 1e-5 relative, parameters within 2e-5);
  dbrx      mesh (2, 2): dbrx-132b at full width cut to 2 of 40 layers
            (all 16 experts, f32) on the all-to-all MoE path: prefill of 4
            x 256 tokens and 8 decode steps against the same model on one
            card, teacher-forced (2e-3, >= 99% tokens), the routing
            decisions that differ counted;
  qwen_split
            mesh (1, 4): qwen2.5-3b at full width and depth (36 layers,
            f32) with the decode cache's rows over ``model`` (its 2 kv
            heads do not divide the axis): batch 8, 32,768 cache rows
            (19.3 GB in f32, 4.8 GB a card), a prompt of 24,704 tokens
            (every card's block live) and 16 greedy decode steps, against
            the same model unsharded on one card (each rank runs it on its
            own card first; the prompt prefilled a sequence at a time);
  jamba_split
            mesh (1, 4): jamba's phase-6 cut (8 of 72 layers, 4 of 16
            experts, f32, 64.99 GB: 16.2 GB a card) with ``{"cache_seq":
            "model", "kv_heads": None}``: Mamba's channels, the attention
            heads, the expert-MLP columns and the cache rows over
            ``model``; a prefill of 2 x 1,024 tokens and 16 decode steps
            against the unsharded cut on one card, the routing decisions
            that differ counted. Both split parts: logits within 2e-3 and
            >= 99% of the argmax tokens equal, the split and combine
            entries launched once per attention layer and step;
  xlstm, mla, vlm, encdec
            the families sharded last, at full width and depth in f32
            (``chip_smoke.mesh_family_serve``): each rank serves the
            unsharded model on its own card first (a prefill and 16 greedy
            decode steps), then plan_cell's prefill and decode on the mesh
            are fed the same tokens and held to it (logits within 2e-3,
            0.1 for xlstm-1.3b at full depth, whose 48 random f32 layers
            are chaotic: ``chip_smoke.LOGIT_ATOL``; >= 99% of the argmax
            tokens equal), with their kernels' launches exact. xlstm:
            xlstm-1.3b on (1, 4), one head a card, 2 x 512, then one
            period of it (8 layers) at 2e-3; xlstm_heads: that period
            with ``{"heads": None}``, the heads whole on every card while
            the mLSTM's channels split, as the rules place xlstm-1.3b's 4
            heads on a model axis of 8 or 16; mla: minicpm3-4b on (1,
            4), 2 x 512, its latent cache whole, then its rows over
            ``model``; vlm: llama-3.2-vision-11b on (1, 4), 2 x 512 with
            1,601 vision tokens; encdec: seamless-m4t-large-v2 on (2, 2),
            4 x 256 with 272 audio frames. Each prints the card's GB of
            parameter slices, the ms of a decode step and the
            collectives' calls and bytes, beside the card's name and
            power limit;
  sp        the sequence-parallel residual (``{"act_seq": "model"}``) on
            phase 12 (b)'s plan, qwen2.5-3b cut to 8 layers in f32: one
            train step of 4 x 2,048 tokens on (1, 4) and on (2, 2) with
            the rule and without it, from the same parameters and batch
            (loss within 1e-5 relative, parameters within 2e-5: phase 11
            (b)'s bars), then two more steps of each timed; and a prefill
            of 4 x 2,048 with 16 greedy decode steps on (1, 4) with the
            rule against the unsharded model on one card
            (``chip_smoke.mesh_family_serve``: 2e-3, >= 99% of the argmax
            tokens). Each way prints its ms a step (the median of steps
            2-3), ``max_memory_allocated`` a rank over step 1, and its
            collectives by kind, beside the dry run's argument + temp GiB
            of the same (1, 4) plan (``launch.dryrun.measure_cell``, run
            on the host before the ranks start);
  launcher  ``torchrun --standalone --nproc-per-node 4 -m
            repro_torch.launch.train --arch qwen2.5-3b --steps 16 --batch
            8 --seq 512`` (full width, bf16, FSDP over data 4);
  phase12   ``chip_smoke.py``'s phase 12 alone on its world of four ranks
            (``chip_smoke.mesh_phase``): the planned serving and train
            step, ``compressed_psum`` and the sweep's shard_map over four
            ranks, then loop and fleet over the four cards from this
            process.

Each part prints its times, launches and the collectives by kind and
bytes (``sharding.ctx.counts``, rank 0); the last line is one JSON object
of the results. A part that misses its bar is reported and the script
exits 1 after the others have run. Needs four cards; raises on fewer.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

WORLD = 4
PARTS = ("yi34b", "train", "dbrx", "qwen_split", "jamba_split", "xlstm",
         "xlstm_heads", "mla", "vlm", "encdec", "sp", "launcher",
         "phase12")
# Parts run here, not on the ranks this script spawns.
HERE = ("launcher", "phase12")
YI_PROMPT = (2, 1024)
DBRX_CUT = dict(n_layers=2, dtype="float32")
DBRX_PROMPT = (4, 256)
DECODE_STEPS = 16
LOGIT_ATOL = 2e-3
ARGMAX_SHARE = 0.99
# (name, cut, batch, prompt, cache rows, decode steps, rule overrides)
SPLIT_PARTS = {
    "qwen_split": ("qwen2.5-3b", dict(dtype="float32"), 8, 24_704, 32_768,
                   16, None),
    "jamba_split": ("jamba-1.5-large-398b", dict(cs.JAMBA_CUT,
                                                 dtype="float32"),
                    2, 1024, 1040, 16, cs.SPLIT_RULES)}
# part -> (name, mesh, (batch, prompt), decode steps, runs): each run a
# (label, depth cut, rule overrides). At full depth a run is held to the
# architecture's LOGIT_ATOL of chip_smoke.py, cut in depth to LOGIT_ATOL.
FAMILY_PARTS = {
    "xlstm": ("xlstm-1.3b", (1, WORLD), (2, 512), DECODE_STEPS,
              [("whole", {}, None), ("period", dict(n_layers=8), None)]),
    "xlstm_heads": ("xlstm-1.3b", (1, WORLD), (2, 512), DECODE_STEPS,
                    [("period", dict(n_layers=8), {"heads": None})]),
    "mla": ("minicpm3-4b", (1, WORLD), (2, 512), DECODE_STEPS,
            [("whole", {}, None), ("split", {}, {"cache_seq": "model"})]),
    "vlm": ("llama-3.2-vision-11b", (1, WORLD), (2, 512), DECODE_STEPS,
            [("whole", {}, None)]),
    "encdec": ("seamless-m4t-large-v2", (2, 2), (4, 256), DECODE_STEPS,
               [("whole", {}, None)])}
LAUNCHER = ["--arch", "qwen2.5-3b", "--steps", "16", "--batch", "8",
            "--seq", "512"]
# The sequence-parallel part: phase 12 (b)'s cut, (batch, tokens) of its
# train step and of its prefill, the train steps (the first compared, the
# others timed), and its meshes.
SP_CUT = dict(n_layers=8)
SP_TRAIN = (4, 2048)
SP_PROMPT = (4, 2048)
SP_STEPS = 3
SP_MESHES = ((1, WORLD), (2, 2))


def log(msg: str) -> None:
    print(msg, flush=True)


def _teacher_forced(label, mesh, kernel_plans, plain_plans, params, toks,
                    n_steps, counts, reset):
    """Prefill and greedy decode on the kernels' plans, the plain plans
    fed the same tokens; returns the worst logit gap, the share of equal
    argmax tokens, launches and times."""
    import torch
    pre, dec = kernel_plans
    rules = pre.spmd.model_rules
    shape = (toks.shape[0], pre.cfg.padded_vocab)
    _, batch, _ = pre.shard(None, {"tokens": toks}, None)
    runs = {}
    for name, (p_plan, d_plan) in (("kernels", kernel_plans),
                                   ("plain", plain_plans)):
        cache = p_plan.cache()
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = p_plan.step_fn(params, batch, cache)
        steps = [cs._mesh_gather(logits[:, 0], ("batch", "vocab"), shape,
                                 mesh, rules)]
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        forced = name == "plain"
        fed = runs["kernels"]["tokens"] if forced else []
        t0 = time.perf_counter()
        for i in range(n_steps):
            if forced:
                nxt = fed[i]
            else:
                nxt = torch.argmax(steps[-1], -1).to(torch.int32)
                fed.append(nxt)
            _, tok_l, _ = d_plan.shard(None, nxt, None)
            logits, cache = d_plan.step_fn(params, tok_l, cache)
            steps.append(cs._mesh_gather(logits, ("batch", "vocab"), shape,
                                         mesh, rules))
        torch.cuda.synchronize()
        runs[name] = dict(logits=steps, tokens=fed, prefill_ms=t_pre * 1e3,
                          ms_per_step=(time.perf_counter() - t0) * 1e3
                          / n_steps, launches=counts())
        del cache
    gaps = [float((a - b).abs().max()) for a, b in
            zip(runs["kernels"]["logits"], runs["plain"]["logits"])]
    same = sum(int((torch.argmax(a, -1) == torch.argmax(b, -1)).sum())
               for a, b in zip(runs["kernels"]["logits"],
                               runs["plain"]["logits"]))
    total = sum(a.shape[0] for a in runs["kernels"]["logits"])
    res = dict(max_abs=max(gaps), argmax_share=same / total,
               **{f"{k}_{n}": runs[n][k] for n in runs
                  for k in ("prefill_ms", "ms_per_step", "launches")})
    log(f"  {label}: kernels prefill {res['prefill_ms_kernels']:.1f} ms, "
        f"{res['ms_per_step_kernels']:.2f} ms a decode step (plain "
        f"{res['prefill_ms_plain']:.1f}, {res['ms_per_step_plain']:.2f}); "
        f"logits within {res['max_abs']:.3e} (bar {LOGIT_ATOL}), argmax "
        f"share {res['argmax_share']:.4f}; launches "
        f"{ {k: v for k, v in res['launches_kernels'].items() if v} }")
    if not (res["max_abs"] <= LOGIT_ATOL
            and res["argmax_share"] >= ARGMAX_SHARE):
        raise AssertionError(f"{label}: outside the bars")
    return res


def part_yi34b(dev):
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import plan_cell
    from repro_torch.models.common import init_sharded, tree_leaves
    reset, counts = cs._all_counters()
    mesh = make_mesh((1, WORLD), ("data", "model"), device=dev.type)
    cfg = dataclasses.replace(configs.get("yi-34b"), dtype="float32")
    b, s = YI_PROMPT
    max_len = s + DECODE_STEPS
    plans = {impl: tuple(plan_cell(cfg, InputShape(kind, max_len, b, kind),
                                   mesh, impl=impl)
                         for kind in ("prefill", "decode"))
             for impl in ("auto", "torch")}
    pre = plans["auto"][0]
    t0 = time.perf_counter()
    params = init_sharded(pre.model.template(), pre.rules, mesh, seed=0)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    log(f"  yi-34b: {cfg.n_layers} layers, this rank's slices "
        f"{n_bytes / 1e9:.2f} GB, drawn in {time.perf_counter() - t0:.1f} "
        f"s; peak {_peak_gb():.2f} GB")
    toks = torch.randint(0, cfg.vocab, (b, s), device=dev,
                         dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    cs._collectives()
    res = _teacher_forced("yi-34b on (1, 4)", mesh, plans["auto"],
                          plans["torch"], params, toks, DECODE_STEPS, counts,
                          reset)
    res["collectives"] = cs._collectives()
    res["rank_gb"] = n_bytes / 1e9
    res["peak_gb"] = _peak_gb()
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * DECODE_STEPS}
    got = {k: res["launches_kernels"][k] for k in want}
    if got != want:
        raise AssertionError(f"yi-34b: launches {got}, want {want}")
    return res


def _peak_gb() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 1e9 \
        if torch.cuda.is_available() else 0.0


def part_train(dev):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"), device=dev.type)
    cs._collectives()
    res = cs.mesh_train(mesh, dev)
    return res


def part_dbrx(dev):
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import plan_cell
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    reset, counts = cs._all_counters()
    mesh = make_mesh((2, 2), ("data", "model"), device=dev.type)
    cfg = dataclasses.replace(configs.get("dbrx-132b"), **DBRX_CUT)
    b, s = DBRX_PROMPT
    max_len = s + DECODE_STEPS
    pre, dec = (plan_cell(cfg, InputShape(kind, max_len, b, kind), mesh)
                for kind in ("prefill", "decode"))
    params = init_params(pre.model.template(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    toks = torch.randint(0, cfg.vocab, (b, s), device=dev,
                         dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    # The one-card run (every rank: the same model on its own card).
    one = pre.model
    routes = {"one": [], "mesh": []}
    real = moe._routing
    which = ["one"]

    def record(*a, **k):
        out = real(*a, **k)
        routes[which[0]].append(torch.where(out[2], out[0], -1))
        return out
    moe._routing = record
    cache = init_params(one.cache_template(b, max_len),
                        torch.Generator(device=dev), device=dev)
    with torch.no_grad():
        logits, cache = one.prefill(params, {"tokens": toks}, cache)
        want, chosen = [logits[:, 0]], []
        for _ in range(DECODE_STEPS):
            nxt = torch.argmax(want[-1], -1).to(torch.int32)
            chosen.append(nxt)
            logits, cache = one.decode_step(params, nxt, cache)
            want.append(logits)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    which[0] = "mesh"
    p_l, batch, _ = pre.shard(params, {"tokens": toks}, None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rules, shape = pre.spmd.model_rules, (b, cfg.padded_vocab)
    cache = pre.cache()
    cs._collectives()
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pre.step_fn(p_l, batch, cache)
    got = [cs._mesh_gather(logits[:, 0], ("batch", "vocab"), shape, mesh,
                           rules)]
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    for nxt in chosen:
        _, tok_l, _ = dec.shard(None, nxt, None)
        logits, cache = dec.step_fn(p_l, tok_l, cache)
        got.append(cs._mesh_gather(logits, ("batch", "vocab"), shape, mesh,
                                   rules))
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / DECODE_STEPS
    moe._routing = real
    coll = cs._collectives()
    gap = max(float((a - w).abs().max()) for a, w in zip(got, want))
    same = sum(int((torch.argmax(a, -1) == torch.argmax(w, -1)).sum())
               for a, w in zip(got, want)) / sum(a.shape[0] for a in got)
    # Routing decisions of this rank's rows against the one-card run's.
    lo = mesh.coord("data") * (b // 2)
    flips = total = 0
    for r_one, r_mesh in zip(routes["one"], routes["mesh"]):
        mine = r_one[lo:lo + r_mesh.shape[0]]
        flips += int((mine != r_mesh).sum())
        total += r_mesh.numel()
    t = torch.tensor([flips, total], device=dev)
    dist.all_reduce(t)
    res = dict(max_abs=gap, argmax_share=same, prefill_ms=t_pre * 1e3,
               ms_per_step=t_dec * 1e3, routing_flips=int(t[0]) // 2,
               routing_decisions=int(t[1]) // 2, collectives=coll,
               launches=counts())
    log(f"  dbrx-132b {cfg.n_layers} of 40 layers on (2, 2), all-to-all: "
        f"prefill {b} x {s} {t_pre * 1e3:.1f} ms, {t_dec * 1e3:.2f} ms a "
        f"decode step; against one card: logits within {gap:.3e}, argmax "
        f"share {same:.4f}, routing decisions that differ "
        f"{res['routing_flips']} of {res['routing_decisions']}; "
        f"collectives {coll}")
    if not (gap <= LOGIT_ATOL and same >= ARGMAX_SHARE):
        raise AssertionError("dbrx: outside the bars")
    return res


def _split_serve(dev, part):
    """One SPLIT_PARTS entry: the unsharded model's greedy prefill and
    decode on this rank's card (every rank: the same parameters from one
    seed), then the parameters cut to this rank's slices leaf by leaf and
    plan_cell's prefill and decode on the (1, 4) mesh fed the same
    tokens."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import plan_cell
    from repro_torch.models import moe
    from repro_torch.models.common import init_params, tree_leaves
    name, cut, b, s, max_len, n_steps, over = SPLIT_PARTS[part]
    reset, counts = cs._all_counters()
    mesh = make_mesh((1, WORLD), ("data", "model"), device=dev.type)
    cfg = dataclasses.replace(configs.get(name), **cut)
    pre, dec = (plan_cell(cfg, InputShape(kind, max_len, b, kind), mesh,
                          rule_overrides=over)
                for kind in ("prefill", "decode"))
    model = pre.model
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model.template(), gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (b, s), device=dev,
                         dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    routes = {"one": [], "mesh": []}
    real = moe._routing
    which = ["one"]

    def record(*a, **k):
        out = real(*a, **k)
        routes[which[0]].append(torch.where(out[2], out[0], -1))
        return out
    moe._routing = record
    full = init_params(model.cache_template(b, max_len),
                       torch.Generator(device=dev), device=dev)
    with torch.no_grad():
        last = []
        for i in range(b):
            # A sequence at a time: the prompt's activations of one.
            row = {k: v[:, i:i + 1] if v.dim() > 1 else v[i:i + 1]
                   for k, v in _flat_leaves(full).items()}
            logits, _ = model.prefill(params, {"tokens": toks[i:i + 1]},
                                      _nest(row))
            last.append(logits[:, 0])
        full["len"].fill_(s)
        want, chosen = [torch.cat(last)], []
        for _ in range(n_steps):
            chosen.append(torch.argmax(want[-1], -1).to(torch.int32))
            logits, full = model.decode_step(params, chosen[-1], full)
            want.append(logits)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    del full
    which[0] = "mesh"
    p_l = cs.shard_leafwise(params, pre.in_shardings[0], mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(p_l))
    _, batch, _ = pre.shard(None, {"tokens": toks}, None)
    rules, shape = pre.spmd.model_rules, (b, cfg.padded_vocab)
    cache = pre.cache()
    cache_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(cache)) / 1e9
    cs._collectives()
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pre.step_fn(p_l, batch, cache)
    got = [cs._mesh_gather(logits[:, 0], ("batch", "vocab"), shape, mesh,
                           rules)]
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre_coll = cs._collectives()
    t0 = time.perf_counter()
    for nxt in chosen:
        _, tok_l, _ = dec.shard(None, nxt, None)
        logits, cache = dec.step_fn(p_l, tok_l, cache)
        got.append(cs._mesh_gather(logits, ("batch", "vocab"), shape, mesh,
                                   rules))
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / n_steps
    moe._routing = real
    coll = cs._collectives()
    launches = counts()
    gap = max(float((a - w).abs().max()) for a, w in zip(got, want))
    same = sum(int((torch.argmax(a, -1) == torch.argmax(w, -1)).sum())
               for a, w in zip(got, want)) / sum(a.shape[0] for a in got)
    # Every rank routes every sequence (data extent 1): this rank's
    # decisions against the one-card run's, which routed the prefill a
    # sequence at a time (concatenated over the sequences of each layer).
    one = routes["one"]
    n_moe = len(routes["mesh"]) // (n_steps + 1)
    one = ([torch.cat(one[i:b * n_moe:n_moe]) for i in range(n_moe)]
           + one[b * n_moe:])
    flips = sum(int((o != m).sum()) for o, m in zip(one, routes["mesh"]))
    total = sum(m.numel() for m in routes["mesh"])
    n_attn = model.n_periods * sum(sp.mixer == "attn" for sp in model.period)
    want_l = {"flash_attention": n_attn, "flash_decode": 0,
              "flash_decode_split": n_attn * n_steps,
              "flash_decode_combine": n_attn * n_steps}
    got_l = {k: launches[k] for k in want_l}
    res = dict(max_abs=gap, argmax_share=same, prefill_ms=t_pre * 1e3,
               ms_per_step=t_dec * 1e3, one_card_s=t_one,
               rank_gb=n_bytes / 1e9, cache_gb=cache_gb,
               peak_gb=_peak_gb(), routing_flips=flips,
               routing_decisions=total, launches=launches,
               prefill_collectives=pre_coll, decode_collectives=coll)
    log(f"  {name} {cfg.n_layers} layers on (1, 4), cache rows over model "
        f"({max_len} rows, {cache_gb:.2f} GB a card), slices "
        f"{n_bytes / 1e9:.2f} GB a card, peak {res['peak_gb']:.2f} GB: "
        f"prefill {b} x {s} {t_pre * 1e3:.1f} ms, {t_dec * 1e3:.2f} ms a "
        f"decode step (one card, prefill and decode: {t_one:.1f} s); "
        f"against one card: logits within {gap:.3e}, argmax share "
        f"{same:.4f}, routing decisions that differ {res['routing_flips']} "
        f"of {res['routing_decisions']}; launches {got_l} (want {want_l}); "
        f"collectives: prefill {pre_coll}, {n_steps} decode steps {coll}")
    if got_l != want_l:
        raise AssertionError(f"{name}: launches {got_l}, want {want_l}")
    if not (gap <= LOGIT_ATOL and same >= ARGMAX_SHARE):
        raise AssertionError(f"{name}: outside the bars")
    return res


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _card(dev) -> str:
    """This rank's card: name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _family(dev, part):
    """One FAMILY_PARTS entry: ``chip_smoke.mesh_family_serve`` for each
    of its runs."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    name, shape, prompt, n_steps, runs = FAMILY_PARTS[part]
    mesh = make_mesh(shape, ("data", "model"), device=dev.type)
    card = _card(dev)
    res = {"card": card}
    for key, cut, rules in runs:
        atol = LOGIT_ATOL if cut else cs.LOGIT_ATOL.get(name, LOGIT_ATOL)
        cs._collectives()
        r = cs.mesh_family_serve(mesh, dev, name, cut, prompt, n_steps,
                                 rules, atol=atol)
        r["peak_gb"] = _peak_gb()
        log(f"  {part} ({key}) on {card}: {r['rank_gb']:.2f} GB of slices "
            f"a card, peak {r['peak_gb']:.2f} GB, {r['ms_per_step']:.2f} ms "
            f"a decode step, prefill {r['prefill_ms']:.1f} ms; logits "
            f"within {r['max_abs']:.3e} (bar {atol}), argmax share "
            f"{r['argmax_share']:.4f}")
        res[key] = r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return res


def part_xlstm(dev):
    return _family(dev, "xlstm")


def part_xlstm_heads(dev):
    return _family(dev, "xlstm_heads")


def part_mla(dev):
    return _family(dev, "mla")


def part_vlm(dev):
    return _family(dev, "vlm")


def part_encdec(dev):
    return _family(dev, "encdec")


def part_qwen_split(dev):
    return _split_serve(dev, "qwen_split")


def part_jamba_split(dev):
    return _split_serve(dev, "jamba_split")


def _sp_train(mesh, dev, rules) -> dict:
    """SP_STEPS planned train steps of qwen2.5-3b cut to SP_CUT (f32,
    SP_TRAIN tokens, one microbatch, lr 1e-3) under rule overrides
    ``rules``, from parameters and a batch drawn from seed 0: the first
    step's loss, grad norm and parameter slices (cloned), its collectives
    and peak memory, and the median ms of the other steps."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.specs import plan_cell
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.train_step import make_train_step
    cfg = cs._family_cfg("qwen2.5-3b", SP_CUT)
    b, s = SP_TRAIN
    plan = plan_cell(cfg, InputShape("sp-train", s, b, "train"), mesh,
                     n_microbatches=1, rule_overrides=rules)
    ocfg = opt_mod.AdamWConfig(lr=1e-3)
    step = make_train_step(plan.model, ocfg, n_microbatches=1, donate=True,
                           spmd=plan.spmd)
    params = init_params(plan.model.template(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, s, b, seed=0))
    batch = train_mod.device_batch(pipe, cfg, 0, s, dev)
    args = plan.shard(params, opt_mod.init(params, ocfg), batch)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out, times = {}, []
    for i in range(SP_STEPS):
        if i == 0:
            cs._collectives()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, metrics = step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out.update(collectives=cs._collectives(), peak_gb=_peak_gb(),
                       loss=float(metrics["loss"]),
                       grad_norm=float(metrics["grad_norm"]),
                       params=[t.detach().clone()
                               for t in tree_leaves(p)])
        args = (p, o, args[2])
    out["ms_per_step"] = sorted(times[1:])[len(times[1:]) // 2]
    out["first_ms"] = times[0]
    return out


def part_sp(dev):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    res = {}
    for shape in SP_MESHES:
        mesh = make_mesh(shape, ("data", "model"), device=dev.type)
        ways = {}
        for way, rules in (("plain", None), ("sp", cs.SP_RULES)):
            ways[way] = _sp_train(mesh, dev, rules)
            gc.collect()
            torch.cuda.empty_cache()
        a, b = ways["plain"], ways["sp"]
        perr = torch.tensor(max(float((x - y).abs().max()) for x, y in
                                zip(a.pop("params"), b.pop("params"))),
                            device=dev)
        dist.all_reduce(perr, op=dist.ReduceOp.MAX)
        loss_rel = abs(b["loss"] - a["loss"]) / abs(a["loss"])
        gn_rel = abs(b["grad_norm"] - a["grad_norm"]) / a["grad_norm"]
        key = f"train {shape[0]}x{shape[1]}"
        res[key] = dict(ways, loss_rel=loss_rel, grad_norm_rel=gn_rel,
                        param_max_abs=float(perr))
        for way, r in ways.items():
            log(f"  sp: train mesh {shape} {way}: {r['ms_per_step']:.1f} "
                f"ms a step (first {r['first_ms']:.1f}), peak "
                f"{r['peak_gb']:.2f} GB a rank, collectives "
                f"{r['collectives']}")
        log(f"  sp: train mesh {shape}: SP against plain: loss rel "
            f"{loss_rel:.3e}, grad norm rel {gn_rel:.3e}, parameters max "
            f"abs {float(perr):.3e} (bars 1e-5, 2e-5)")
        if loss_rel > 1e-5 or float(perr) > 2e-5:
            raise AssertionError(f"sp: train {shape} outside the bars")
    mesh = make_mesh((1, WORLD), ("data", "model"), device=dev.type)
    res["serve"] = cs.mesh_family_serve(mesh, dev, "qwen2.5-3b", SP_CUT,
                                        SP_PROMPT, DECODE_STEPS,
                                        rules=cs.SP_RULES, atol=LOGIT_ATOL)
    return res


def sp_predictions() -> dict:
    """The dry run's argument + temp GiB a rank of the sp part's (1, 4)
    train plans, with the rule and without it (host, fake tensors)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import measure_cell
    from repro_torch.launch.mesh import Mesh
    cfg = cs._family_cfg("qwen2.5-3b", SP_CUT)
    b, s = SP_TRAIN
    out = {}
    for way, rules in (("plain", None), ("sp", cs.SP_RULES)):
        t0 = time.perf_counter()
        rec = measure_cell(cfg, InputShape("sp-train", s, b, "train"),
                           Mesh(("data", "model"), (1, WORLD)),
                           skip_extrapolation=True, n_microbatches=1,
                           rule_overrides=rules)
        mem = rec["memory"]
        out[way] = dict(argument_gib=mem["argument_gib"],
                        temp_gib=mem["temp_gib"],
                        predicted_gib=mem["argument_gib"] + mem["temp_gib"],
                        collectives=rec["collectives_full_hlo"]["counts"])
        log(f"  sp: dry run of the (1, {WORLD}) train plan, {way}: argument "
            f"{mem['argument_gib']:.4f} + temp {mem['temp_gib']:.4f} = "
            f"{out[way]['predicted_gib']:.4f} GiB a rank, collective calls "
            f"{out[way]['collectives']} ({time.perf_counter() - t0:.1f} s)")
    return out


def rank_main(rank: int, world: int, tmp: str, parts) -> int:
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm import kernel as ml_kernel
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.launch.mesh import init_distributed
    for lib in (fa_kernel, dec_kernel, ss_kernel, ml_kernel):
        lib.load()
    dev = init_distributed("cuda", rank=rank, world_size=world,
                           store=dist.FileStore(str(Path(tmp) / "store"),
                                                world), local_rank=rank)
    if rank:
        globals()["log"] = lambda msg: None
        cs.log = lambda msg: None
    res = {}
    for part in parts:
        t0 = time.perf_counter()
        try:
            res[part] = globals()[f"part_{part}"](dev)
        except AssertionError as e:
            # A missed bar is reported and fails the script at its end,
            # after the other parts have run.
            res[part] = {"failed": str(e)}
            log(f"  {part}: FAILED: {e}")
        res[part]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
    if rank == 0:
        (Path(tmp) / "result.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def launcher() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.train",
         *LAUNCHER, "--log-every", "1"], env=env, capture_output=True,
        text=True, timeout=900)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    for line in out.splitlines():
        log(f"  [torchrun] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}")
    losses = [float(m) for m in re.findall(r"loss ([0-9.]+)", out)]
    return dict(wall_s=wall, losses=losses)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(PARTS))
    args = ap.parse_args(argv)
    parts = [p for p in args.only.split(",") if p]
    import torch
    from concurrent.futures import ThreadPoolExecutor
    if torch.cuda.device_count() < WORLD:
        raise SystemExit(f"needs {WORLD} cards; "
                         f"{torch.cuda.device_count()} visible")
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm import kernel as ml_kernel
    from repro_torch.kernels.selective_scan import kernel as ss_kernel
    from repro_torch.kernels.slot_solver import kernel as sl_kernel
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"cards:\n{smi}\ntorch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        for f in [pool.submit(_build.build, name, lib.SOURCES, flags)
                  for name, lib, flags in (
                      ("flash_attention", fa_kernel, _build.ATTENTION_FLAGS),
                      ("flash_decode", dec_kernel, _build.ATTENTION_FLAGS),
                      ("mlstm_chunkwise", ml_kernel,
                       _build.ATTENTION_FLAGS),
                      ("selective_scan", ss_kernel, _build.NVCC_FLAGS),
                      ("slot_solver", sl_kernel, _build.NVCC_FLAGS))]:
            f.result()
    log(f"build {time.perf_counter() - t0:.1f} s")
    res = {}
    predicted = sp_predictions() if "sp" in parts else None
    ranked = [p for p in parts if p not in HERE]
    if ranked:
        tmp = tempfile.mkdtemp(prefix="mesh-cards-")
        procs = [subprocess.Popen([sys.executable, __file__, "--rank",
                                   str(r), str(WORLD), tmp, ",".join(ranked)])
                 for r in range(WORLD)]
        codes = [p.wait(timeout=1800) for p in procs]
        if any(codes):
            raise SystemExit(f"ranks exited {codes}")
        res = json.loads((Path(tmp) / "result.json").read_text())
    if predicted is not None and "sp" in res:
        res["sp"]["predicted"] = predicted
    if "launcher" in parts:
        res["launcher"] = launcher()
    if "phase12" in parts:
        for lib in (sl_kernel, fa_kernel, dec_kernel, ss_kernel, ml_kernel):
            lib.load()
        res["phase12"] = cs.mesh_phase(torch.device("cuda", 0))
    print(json.dumps(res, default=str))
    failed = [p for p, r in res.items() if "failed" in r]
    if failed:
        log(f"bars missed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                           sys.argv[5].split(",")))
    sys.exit(main())
