"""End-to-end training run on the PyTorch port (``repro_torch``), the
steps, flags and printed lines of ``examples/train_e2e.py``: train a
qwen2.5-family model (20.3M parameters at the defaults, which the
reference's docstring calls ~100M) for a few hundred steps on the card,
with checkpoint and restart.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200] \
        [--d-model 256] [--device cuda|cpu]

A crash mid-run resumes from the last atomic checkpoint:
    PYTHONPATH=src python examples/train_e2e_torch.py --resume

The parameters are drawn by ``torch.Generator`` from the seed, not by the
JAX package's threefry, so the losses are not the reference script's.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.launch.train import run
from repro_torch.models import build


def main(argv=None) -> dict:
    """Train as the flags say; return ``launch.train.run``'s output and
    the parameter count (``"n_params"``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_e2e"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # A decoder-only qwen-family model: GQA, qkv bias, SwiGLU.
    n_heads = max(args.d_model // 64, 2)
    cfg = dataclasses.replace(
        configs.get("qwen2.5-3b"),
        n_layers=args.layers, d_model=args.d_model,
        n_heads=n_heads, n_kv_heads=2 if n_heads % 2 == 0 else 1,
        d_ff=args.d_model * 4, vocab=args.vocab, head_dim=64,
        remat="none", fsdp=False, dtype="float32")
    n = build(cfg).param_count()
    print(f"model: {n/1e6:.1f}M params, {args.layers}L d{args.d_model}")

    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt, ckpt_every=50, log_every=10,
              resume=args.resume, lr=1e-3, device=args.device)
    first = sum(out["losses"][:10]) / min(len(out["losses"]), 10)
    last = sum(out["losses"][-10:]) / min(len(out["losses"]), 10)
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({out['wall_s']:.0f}s)")
    return dict(out, n_params=n)


if __name__ == "__main__":
    main()
