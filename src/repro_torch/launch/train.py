"""Training launcher: real steps on one card (or the CPU when asked).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

The JAX package's ``launch/train.py`` on one device: the model is built
with the plain versions (``impl="torch"``, as the JAX launcher builds
with ``impl="ref"``; the CUDA kernels have no backward pass), parameters
are initialised in ``cfg.dtype`` from a seeded ``torch.Generator`` (bf16
parameters with f32 AdamW state for the full configs), the data are the
deterministic Zipf pipeline (with the vision and audio stubs), step times
feed a ``StragglerMonitor``, and checkpoints are saved every
``ckpt_every`` steps and resumed with ``resume``. There is no mesh: the
port shards nothing yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import configs
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import build
from ..models.common import init_params
from ..models.registry import DTYPES
from ..training import checkpoint as ckpt_mod
from ..training import optimizer as opt_mod
from ..training.failure import StragglerMonitor
from ..training.train_step import make_train_step


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


def run(cfg, *, steps: int, batch: int, seq: int, ckpt_dir=None,
        ckpt_every: int = 0, n_microbatches: int = 1, lr: float = 3e-4,
        log_every: int = 10, resume: bool = False, seed: int = 0,
        device=DEFAULT_DEVICE) -> dict:
    """Train ``cfg`` for steps [start, steps) (start 0, or the latest
    checkpoint's step with ``resume``). Returns {"losses", "grad_norms",
    "step_s" (per step, ending in a host read of the loss), "wall_s",
    "params", "opt_state", "straggler" (the monitor)}."""
    device = resolve_device(device)
    model = build(cfg, impl="torch")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model.template(), gen, DTYPES[cfg.dtype], device)
    ocfg = dataclasses.replace(opt_mod.AdamWConfig(), lr=lr,
                               total_steps=steps)
    opt_state = opt_mod.init(params, ocfg)
    start = 0
    if resume and ckpt_dir and ckpt_mod.latest_step(ckpt_dir) is not None:
        (params, opt_state), start = ckpt_mod.restore(
            ckpt_dir, (params, opt_state), device=device)
        print(f"resumed from step {start}")

    step_fn = make_train_step(model, ocfg, n_microbatches=n_microbatches,
                              donate=True)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, seq, batch, seed=seed))
    monitor = StragglerMonitor(n_workers=1)
    losses, gnorms, step_s = [], [], []
    t_start = time.perf_counter()
    for step in range(start, steps):
        b = device_batch(pipe, cfg, step, seq, device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.observe([dt])
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        step_s.append(dt)
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {gnorms[-1]:.3f} "
                  f"tok/s {batch * seq / max(dt, 1e-9):,.0f}", flush=True)
        if ckpt_every and ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_mod.save(ckpt_dir, step + 1, (params, opt_state))
    wall = time.perf_counter() - t_start
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "wall_s": wall, "params": params, "opt_state": opt_state,
            "straggler": monitor}


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
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
              n_microbatches=args.microbatches, lr=args.lr,
              resume=args.resume, device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"({out['wall_s']:.1f}s total)")
    return out


if __name__ == "__main__":
    main()
