"""Training launcher: real steps on one card, on every card of a host
(``torchrun``), or on the CPU when asked.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 50 --batch 8 --seq 128 [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch qwen2.5-3b --reduced

The JAX package's ``launch/train.py`` on one device: the model is built
with the plain versions (``impl="torch"``, as the JAX launcher builds
with ``impl="ref"``; the CUDA kernels have no backward pass) and its
Mamba layers' scan in the chunked form (``ssm_impl="chunked"``, the JAX
package's default, not the per-token loop), parameters
are initialised in ``cfg.dtype`` from a seeded ``torch.Generator`` (bf16
parameters with f32 AdamW state for the full configs), the data are the
deterministic Zipf pipeline (with the vision and audio stubs), step times
feed a ``StragglerMonitor``, and checkpoints are saved every
``ckpt_every`` steps and resumed with ``resume``.

Under ``torchrun`` (``WORLD_SIZE`` > 1), or in a process group of more
than one rank, each rank joins the group (NCCL on its card, gloo on the
CPU) and trains over ``make_host_mesh()`` with the JAX package's rules:
data parallel, FSDP for the full configs. Every rank draws the same full
parameters from the seed and keeps its slices; each takes its rows of
the global batch; the loss and grad norm are the whole batch's, the same
on every rank. Checkpoints hold the full trees (gathered, written by rank
0) in the same format.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from .. import configs
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import build
from ..models.common import (P, gather_tree, init_params, shard_by,
                             shard_tree)
from ..models.registry import DTYPES
from ..sharding import rules as rules_mod
from ..sharding.spec import spec_dims
from ..training import checkpoint as ckpt_mod
from ..training import optimizer as opt_mod
from ..training.failure import StragglerMonitor
from ..training.train_step import MeshStep, make_train_step
from .mesh import init_distributed, make_host_mesh


def device_batch(pipe: TokenPipeline, cfg, step: int, seq: int,
                 device) -> dict:
    """Step ``step``'s batch on ``device``: tokens and labels, and the
    stub embeddings of the VLM and audio families."""
    b = {k: torch.from_numpy(v).to(device)
         for k, v in pipe.batch(step).items()}
    if cfg.family == "vlm":
        b["vision_embeds"] = torch.from_numpy(pipe.modality_stub(
            step, cfg.n_vision_tokens, cfg.d_model)).to(device)
    if cfg.family == "audio":
        b["audio_embeds"] = torch.from_numpy(pipe.modality_stub(
            step, seq, cfg.d_model, kind="audio")).to(device)
    return b


def _distributed() -> bool:
    """A world of more than one rank: joined, or asked for by
    ``torchrun``'s environment."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    return int(os.environ.get("WORLD_SIZE", 1)) > 1


class _Sharded:
    """The launcher's data-parallel layout over the host mesh: the rules,
    the placements of the trees it keeps, the slicing of the batch."""

    def __init__(self, cfg, device):
        device = init_distributed(device)
        self.mesh = make_host_mesh(device=device)
        self.rules = rules_mod.make_rules(cfg, self.mesh)
        self.ep = rules_mod.ep_degree(self.mesh)
        self.rank = dist.get_rank()

    def templates(self, tmpl):
        state = {"m": tmpl, "v": tmpl, "step": P((), ())}
        return tmpl, state

    def shard(self, tree, tmpl):
        return shard_tree(tree, tmpl, self.rules, self.mesh)

    def gather(self, tree, tmpl):
        return gather_tree(tree, tmpl, self.rules, self.mesh)

    def batch(self, b: dict) -> dict:
        """This rank's rows of each leaf of the global batch."""
        return shard_by(b, {k: spec_dims(
            x.shape, ("batch",) + (None,) * (x.dim() - 1), self.rules)
            for k, x in b.items()}, self.mesh)


def run(cfg, *, steps: int, batch: int, seq: int, ckpt_dir=None,
        ckpt_every: int = 0, n_microbatches: int = 1, lr: float = 3e-4,
        log_every: int = 10, resume: bool = False, seed: int = 0,
        device=DEFAULT_DEVICE) -> dict:
    """Train ``cfg`` for steps [start, steps) (start 0, or the latest
    checkpoint's step with ``resume``). Returns {"losses", "grad_norms",
    "step_s" (per step, ending in a host read of the loss), "wall_s",
    "params", "opt_state", "straggler" (the monitor)}; over a mesh the
    trees are this rank's slices and "mesh" is added."""
    device = resolve_device(device)
    sh = _Sharded(cfg, device) if _distributed() else None
    if sh is not None:
        device = sh.mesh.device
    model = build(cfg, impl="torch", ssm_impl="chunked",
                  ep_degree=1 if sh is None else sh.ep)
    tmpl = model.template()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(tmpl, gen, DTYPES[cfg.dtype], device)
    ocfg = dataclasses.replace(opt_mod.AdamWConfig(), lr=lr,
                               total_steps=steps)
    opt_state = None
    start = 0
    if resume and ckpt_dir and ckpt_mod.latest_step(ckpt_dir) is not None:
        (params, opt_state), start = ckpt_mod.restore(
            ckpt_dir, (params, opt_mod.init(params, ocfg)), device=device)
        print(f"resumed from step {start}")
    spmd = None
    if sh is not None:
        p_t, s_t = sh.templates(tmpl)
        params = sh.shard(params, p_t)
        if opt_state is not None:
            opt_state = sh.shard(opt_state, s_t)
        spmd = MeshStep(sh.mesh, sh.rules, tmpl)
    if opt_state is None:
        opt_state = opt_mod.init(params, ocfg)

    step_fn = make_train_step(model, ocfg, n_microbatches=n_microbatches,
                              donate=True, spmd=spmd)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, seq, batch, seed=seed))
    monitor = StragglerMonitor(n_workers=1)
    losses, gnorms, step_s = [], [], []
    t_start = time.perf_counter()
    for step in range(start, steps):
        b = device_batch(pipe, cfg, step, seq, device)
        if sh is not None:
            b = sh.batch(b)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.observe([dt])
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        step_s.append(dt)
        rank0 = sh is None or sh.rank == 0
        if log_every and step % log_every == 0 and rank0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {gnorms[-1]:.3f} "
                  f"tok/s {batch * seq / max(dt, 1e-9):,.0f}", flush=True)
        if ckpt_every and ckpt_dir and (step + 1) % ckpt_every == 0:
            tree = (params, opt_state)
            if sh is not None:
                tree = (sh.gather(params, p_t), sh.gather(opt_state, s_t))
            if rank0:
                ckpt_mod.save(ckpt_dir, step + 1, tree)
            if sh is not None:
                dist.barrier()
    wall = time.perf_counter() - t_start
    out = {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
           "wall_s": wall, "params": params, "opt_state": opt_state,
           "straggler": monitor}
    if sh is not None:
        out["mesh"] = sh.mesh
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
              n_microbatches=args.microbatches, lr=args.lr,
              log_every=args.log_every, resume=args.resume,
              device=args.device)
    if "mesh" not in out or dist.get_rank() == 0:
        print(f"final loss {out['losses'][-1]:.4f} "
              f"({out['wall_s']:.1f}s total)"
              + (f" over {out['mesh']}" if "mesh" in out else ""))
    return out


if __name__ == "__main__":
    main()
