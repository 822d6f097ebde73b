"""Ranks of the port's multi-rank tests, one process each: gloo on the
CPU, or NCCL with one card a rank (``args["device"] == "cuda"``).

    python tests/torch_mesh_workers.py TASK RANK WORLD DIR

``spawn`` starts WORLD such processes with ``PYTHONPATH=src`` and waits
for them. Each joins the group through a ``FileStore`` in DIR (no port),
runs TASK with one thread, reads its inputs from ``DIR/in.npz`` and
``DIR/args.json`` (written by the test: numpy arrays made from a seed,
parameters from the JAX package's ``init_params`` or the port's), and
writes its results to ``DIR/out_RANK.npz``. Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def spawn(task: str, world: int, tmp, args: dict | None = None,
          arrays: dict | None = None, timeout: float = 240.0) -> list:
    """Run ``task`` on ``world`` ranks; return each rank's outputs."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "args.json").write_text(json.dumps(args or {}))
    np.savez(tmp / "in.npz", **(arrays or {}))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(r), str(world), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {task} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    return [dict(np.load(tmp / f"out_{r}.npz")) for r in range(world)]


def flat_numpy(tree, prefix: str = "p/") -> dict:
    """A nested dict of arrays (numpy, JAX or torch on the CPU) as flat
    ``prefix + "a/b/c"`` keys of numpy arrays, for ``in.npz``."""
    out = {}

    def rec(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{path}/{k}" if path else k)
        else:
            out[prefix + path] = np.asarray(t)
    rec(tree, "")
    return out


# ---------------------------------------------------------------------------
# Helpers inside a rank
# ---------------------------------------------------------------------------

def _cfg(args):
    from repro_torch import configs
    cfg = configs.get(args["arch"]).reduced()
    return dataclasses.replace(cfg, **args.get("cfg", {}))


def _params(inp, prefix="p/"):
    """The nested dict stored flat in the npz under ``prefix``."""
    from repro_torch.models.convert import params_from_numpy
    tree = {}
    for key, a in inp.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a
    return params_from_numpy(tree, device="cpu")


def _flat(tree, prefix):
    import torch
    out = {}

    def rec(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{path}/{k}" if path else k)
        else:
            out[prefix + path] = t.detach().float().cpu().numpy() \
                if isinstance(t, torch.Tensor) else np.asarray(t)
    rec(tree, "")
    return out


def _gather(t, axes, shape, mesh, rules):
    """The full tensor of global ``shape`` from this rank's slice laid
    out along logical ``axes``."""
    from repro_torch.models.common import P, gather_tree
    return gather_tree({"x": t}, {"x": P(tuple(shape), tuple(axes))}, rules,
                       mesh)["x"]


# The stub modalities' inputs a test may pass beside the tokens (rows
# split over the data axes as the tokens are).
EMBEDS = ("vision_embeds", "audio_embeds")


def _embeds(inp, lo=0, n=None) -> dict:
    """The stub modalities' inputs in ``inp``, rows [lo, lo + n)."""
    import torch
    return {k: torch.from_numpy(inp[k][lo:None if n is None else lo + n])
            for k in EMBEDS if k in inp}


def _device(args) -> str:
    return args.get("device", "cpu")


def _mesh(args):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(tuple(args["mesh"]), ("data", "model"),
                     device=_device(args))


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------

def task_forward(rank, inp, args):
    """The model's forward on the mesh: full logits, aux, and this rank's
    routing decisions (MoE)."""
    import torch

    from repro_torch.models import build, moe
    from repro_torch.models.common import shard_tree
    from repro_torch.sharding import ctx, rules as rules_mod
    from repro_torch.training.train_step import MeshStep
    cfg = _cfg(args)
    mesh = _mesh(args)
    rules = rules_mod.make_rules(cfg, mesh, overrides=args.get("overrides"))
    model = build(cfg, impl="torch", ep_degree=rules_mod.ep_degree(mesh))
    tmpl = model.template()
    params = shard_tree(_params(inp), tmpl, rules, mesh)
    spmd = MeshStep(mesh, rules, tmpl)
    toks = torch.from_numpy(inp["tokens"]).to(mesh.device)
    b_loc = toks.shape[0] // mesh.shape["data"]
    lo = mesh.coord("data") * b_loc
    routes = []
    real = moe._routing

    def record(*a, **k):
        out = real(*a, **k)
        routes.append(torch.where(out[2], out[0] * 1000 + out[1],
                                  torch.full_like(out[0], -1)))
        return out
    moe._routing = record
    if args.get("local_norm"):
        # The mLSTM's out_norm taken over the rank's channels alone: what
        # the planted test must tell apart from the whole-width norm.
        from repro_torch.models import xlstm

        def local_norm(params, h, inner, axis=None, eps=1e-6):
            _, lo_c = ctx.split("ssm_inner", h.shape[-1], inner)
            scale = params["out_norm"]["scale"].narrow(0, lo_c, h.shape[-1])
            x = h.float()
            var = torch.mean(torch.square(x), dim=-1, keepdim=True)
            return (x * torch.rsqrt(var + eps) * scale).to(h.dtype)
        xlstm._out_norm = local_norm
    batch = {"tokens": toks[lo:lo + b_loc], **_embeds(inp, lo, b_loc)}
    with torch.no_grad(), ctx.activation_rules(spmd.model_rules):
        logits, aux = model.forward(spmd.gather(params), batch)
        logits = _gather(logits, ("batch", None, "vocab"),
                         (toks.shape[0], toks.shape[1], cfg.padded_vocab),
                         mesh, spmd.model_rules)
    out = {"logits": logits.cpu().numpy(), "aux": np.asarray(float(aux)),
           "rows": np.asarray([lo, b_loc])}
    for i, r in enumerate(routes):
        out[f"route_{i}"] = r.cpu().numpy()
    return out


def task_serve(rank, inp, args):
    """Prefill and greedy decode through plan_cell: full logits of each
    step and the tokens."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.launch.specs import plan_cell
    cfg = _cfg(args)
    mesh = _mesh(args)
    toks = torch.from_numpy(inp["tokens"])
    gb, s = toks.shape
    max_len = args["max_len"]
    over = args.get("overrides")
    pre = plan_cell(cfg, InputShape("p", max_len, gb, "prefill"), mesh,
                    impl="torch", rule_overrides=over)
    dec = plan_cell(cfg, InputShape("d", max_len, gb, "decode"), mesh,
                    impl="torch", rule_overrides=over)
    full = _params(inp)
    params, batch, _ = pre.shard(full, {"tokens": toks, **_embeds(inp)},
                                 None)
    # The encoder-decoder's frames, where the test's differ from max_len.
    enc = {"enc_len": args["enc_len"]} if args.get("enc_len") else {}
    cache = pre.cache(**enc)
    logits, cache = pre.step_fn(params, batch, cache)
    rules = pre.spmd.model_rules
    shape = (gb, cfg.padded_vocab)
    steps = [_gather(logits[:, 0], ("batch", "vocab"), shape, mesh, rules)]
    chosen = []
    for _ in range(args["n_decode"]):
        nxt = torch.argmax(steps[-1], dim=-1).to(torch.int32)
        chosen.append(nxt)
        _, tok_l, _ = dec.shard(None, nxt, None)
        logits, cache = dec.step_fn(params, tok_l, cache, **enc)
        steps.append(_gather(logits, ("batch", "vocab"), shape, mesh,
                             rules))
    from repro_torch.sharding import ctx
    flat = _flat(cache, "")
    rows = {t.shape[-3] for k, t in flat.items() if k.endswith("self/k")}
    rows |= {t.shape[-2] for k, t in flat.items() if k.endswith("self/ckv")}
    enc_rows = {t.shape[-3] for k, t in flat.items() if k.endswith("enc/k")}
    return {"logits": torch.stack(steps, 1).cpu().numpy(),
            "tokens": torch.stack(chosen, 1).cpu().numpy(),
            "cache_rows": np.asarray(sorted(rows)),
            "enc_rows": np.asarray(sorted(enc_rows)),
            "all_to_all": np.asarray(ctx.counts["all_to_all"]["calls"])}


def task_train(rank, inp, args):
    """One planned train step: full parameters after it, loss, grad
    norm; with ``args["grads"]`` also the full gradients the step handed
    the optimizer ("g/" keys)."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.launch.specs import plan_cell
    from repro_torch.models.common import gather_tree, tree_map
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.train_step import make_train_step
    cfg = _cfg(args)
    mesh = _mesh(args)
    toks = torch.from_numpy(inp["tokens"])
    gb, s = toks.shape[0], toks.shape[1] - 1
    ocfg = opt_mod.AdamWConfig(**args["opt"])
    nm = args["microbatches"]
    plan = plan_cell(cfg, InputShape("t", s, gb, "train"), mesh,
                     n_microbatches=nm, hoist_fsdp_gather=args["hoist"],
                     rule_overrides=args.get("overrides"))
    # The plan's step with this optimizer: the plan's own takes
    # opt_config's, whose warm-up moves a parameter by ~3e-6 in the first
    # step, below the tests' bars.
    step = make_train_step(plan.model, ocfg, n_microbatches=nm, donate=True,
                           spmd=plan.spmd)
    full = _params(inp)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(), **_embeds(inp)}
    params, opt_state, batch = plan.shard(full, opt_mod.init(full, ocfg),
                                          batch)
    seen = []
    update = opt_mod.update
    if args.get("grads"):
        def record(params, grads, *a, **kw):
            seen.append(tree_map(lambda g: g.detach().clone(), grads))
            return update(params, grads, *a, **kw)
        opt_mod.update = record
    try:
        params, opt_state, metrics = step(params, opt_state, batch)
    finally:
        opt_mod.update = update
    tmpl = plan.model.template()
    out = _flat(gather_tree(params, tmpl, plan.rules, mesh), "p/")
    if seen:
        out.update(_flat(gather_tree(seen[0], tmpl, plan.rules, mesh),
                         "g/"))
    out.update(loss=np.asarray(float(metrics["loss"])),
               grad_norm=np.asarray(float(metrics["grad_norm"])),
               hoist=np.asarray(plan.spmd.hoist))
    return out


def task_remat(rank, inp, args):
    """Gradients under remat "full" against remat "none" on the mesh, the
    backward pass taken outside the rules' context (as autograd's own
    thread takes it on the card): full parameters' gradients and loss."""
    import torch

    from repro_torch.models import build
    from repro_torch.models.common import (gather_tree, shard_tree,
                                           tree_leaves, tree_map)
    from repro_torch.sharding import ctx, rules as rules_mod
    from repro_torch.training.train_step import MeshStep
    mesh = _mesh(args)
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(_cfg(args), remat=remat)
        rules = rules_mod.make_rules(cfg, mesh)
        model = build(cfg, impl="torch", ep_degree=rules_mod.ep_degree(mesh))
        tmpl = model.template()
        spmd = MeshStep(mesh, rules, tmpl)
        params = spmd.gather(shard_tree(_params(inp), tmpl, rules, mesh))
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        toks = torch.from_numpy(inp["tokens"]).to(mesh.device)
        b_loc = toks.shape[0] // mesh.shape["data"]
        lo = mesh.coord("data") * b_loc
        rows = toks[lo:lo + b_loc]
        with torch.enable_grad():
            with ctx.activation_rules(spmd.model_rules):
                loss = model.loss(params, {"tokens": rows[:, :-1],
                                           "labels": rows[:, 1:]})
            grads = torch.autograd.grad(loss, tree_leaves(params))
        grads = list(grads)
        grads.reverse()
        tree = spmd.reduce(tree_map(lambda p: grads.pop().float(), params))
        out.update(_flat(gather_tree(tree, tmpl, rules, mesh), f"{remat}/"))
        out[f"{remat}/loss"] = np.asarray(float(spmd.mean(loss)))
    return out


def task_psum(rank, inp, args):
    """compressed_psum of this rank's rows."""
    import torch

    from repro_torch.training.compression import compressed_psum
    return {f"out_{n}": compressed_psum(
        torch.from_numpy(inp[f"x_{n}"][rank]).to(_rank_device(args, rank)),
        block=args["block"]).cpu().numpy() for n in args["lengths"]}


def task_sweep(rank, inp, args):
    """The sweep's shard_map over the world (the caller runs loop and
    fleet itself, with no rank waiting on a collective meanwhile)."""
    from repro_torch import scenarios
    return sweep_series(scenarios, args, "shard_map",
                        device=_rank_device(args, rank))


def sweep_series(scenarios, suite: dict, backend: str, device,
                 **kw) -> dict:
    """``scenarios.sweep`` of ``suite`` (names and dims) under ``backend``:
    ``{"backend": tag, "POLICY/KEY": [K, T] series}``."""
    st = scenarios.suite(suite["names"], device=device, **suite["dims"])
    res = scenarios.sweep(st, backend=backend, device=device, **kw)
    if res.errors:
        raise AssertionError(f"{backend}: {res.errors}")
    out = {"backend": np.asarray(res.backend)}
    for p in res.policies:
        for key in ("aopi", "acc", "q"):
            out[f"{p}/{key}"] = getattr(res, key)[p]
    return out


def task_launch(rank, inp, args):
    """launch.train.run over the world."""
    from repro_torch.launch import train
    out = train.run(_cfg(args), device="cpu", log_every=0, **args["run"])
    return {"losses": np.asarray(out["losses"]),
            "grad_norms": np.asarray(out["grad_norms"]),
            "mesh": np.asarray(str(out["mesh"].shape))}


def task_plan_counts(rank, inp, args):
    """One step of ``plan_cell``'s plan (``args["kind"]``: "train" or
    "decode", at ``args["seq"]`` x ``args["batch"]``) on parameters drawn
    from seed 0: the calls and bytes per kind of ``sharding.ctx.counts``
    over the step ("calls/KIND", "bytes/KIND")."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.launch.specs import opt_config, plan_cell
    from repro_torch.models.common import init_params
    from repro_torch.sharding import ctx
    from repro_torch.training import optimizer as opt_mod
    cfg = _cfg(args)
    mesh = _mesh(args)
    kind = args["kind"]
    plan = plan_cell(cfg, InputShape("c", args["seq"], args["batch"], kind),
                     mesh, impl="torch",
                     n_microbatches=args.get("microbatches"),
                     rule_overrides=args.get("overrides"))
    params = init_params(plan.model.template(),
                         torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(inp["tokens"])
    if kind == "train":
        args_ = plan.shard(params, opt_mod.init(params, opt_config(cfg)),
                           {"tokens": toks, "labels": toks})
    else:
        params_l, toks_l, _ = plan.shard(params, toks[:, 0].contiguous(),
                                         None)
        args_ = (params_l, toks_l, plan.cache())
    ctx.reset_counts()
    plan.step_fn(*args_)
    out = {}
    for k, v in ctx.counts.items():
        out[f"calls/{k}"] = np.asarray(v["calls"])
        out[f"bytes/{k}"] = np.asarray(v["bytes"])
    return out


def task_sp(rank, inp, args):
    """On each mesh of ``args["meshes"]`` in turn, in one group: the
    forward, one planned train step (``args["microbatches"]`` a
    mesh), and the planned prefill with greedy decode (``task_forward``,
    ``task_train`` and ``task_serve`` under ``args["overrides"]``):
    their outputs under the keys "MESH/fwd/", "MESH/train/" and
    "MESH/serve/" (MESH as "1x4"), and the forward's collective counts
    ("MESH/fwd/calls/KIND"). The train step reads ``train_tokens`` and
    the stub modalities' ``train_*`` inputs in place of the others."""
    from repro_torch.models import moe
    from repro_torch.sharding import ctx
    train_inp = {k: v for k, v in inp.items()
                 if k.startswith("p/")}
    train_inp.update({k[len("train_"):]: v for k, v in inp.items()
                      if k.startswith("train_")})
    out = {}
    for mesh, nm in zip(args["meshes"], args["microbatches"]):
        tag = f"{mesh[0]}x{mesh[1]}/"
        margs = dict(args, mesh=mesh, microbatches=nm)
        routing = moe._routing
        ctx.reset_counts()
        try:
            fwd = task_forward(rank, inp, margs)
        finally:
            moe._routing = routing
        out.update({f"{tag}fwd/calls/{k}": np.asarray(v["calls"])
                    for k, v in ctx.counts.items()})
        out.update({f"{tag}fwd/{k}": v for k, v in fwd.items()})
        out.update({f"{tag}serve/{k}": v
                    for k, v in task_serve(rank, inp, margs).items()})
        out.update({f"{tag}train/{k}": v for k, v in
                    task_train(rank, train_inp, margs).items()})
    return out


def _rank_device(args, rank: int) -> str:
    return f"cuda:{rank}" if _device(args) == "cuda" else "cpu"


def main(task, rank, world, tmp) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed
    torch.set_num_threads(1)
    tmp = Path(tmp)
    args = json.loads((tmp / "args.json").read_text())
    inp = dict(np.load(tmp / "in.npz"))
    init_distributed(_device(args), rank=rank, world_size=world,
                     store=dist.FileStore(str(tmp / "store"), world),
                     local_rank=rank)
    try:
        out = globals()[f"task_{task}"](rank, inp, args)
        np.savez(tmp / f"out_{rank}.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
