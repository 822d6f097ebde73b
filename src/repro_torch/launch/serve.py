"""Serving launcher: an LBCD-controlled analytics service.

    PYTHONPATH=src python -m repro_torch.launch.serve --streams 16 \\
        --epochs 8 [--islands 4] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --streams 8

Each epoch the controller (Algorithm 3) plans every stream's model,
resolution, policy, island and bandwidth/compute shares, and the data
plane measures the epoch's AoPI against the plan's closed form. Without
``--engine`` the data plane is the GI/G/1 window (1,200 s epochs); with it
a reduced qwen2.5-3b ``Engine`` with random weights serves the frames
event by event (3 s epochs), one of its 8 lanes per stream, so at most 8
streams. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from ..core import lbcd, profiles
from ..device import DEFAULT_DEVICE, resolve_device
from ..serving import AnalyticsService, Engine


def parse_args(argv=None, device=DEFAULT_DEVICE) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--v", type=float, default=10.0)
    ap.add_argument("--p-min", type=float, default=0.7)
    ap.add_argument("--bandwidth-mhz", type=float, default=12.0)
    ap.add_argument("--tflops", type=float, default=15.0)
    ap.add_argument("--device", default=str(device))
    return ap.parse_args(argv)


def reduced_engine(device=DEFAULT_DEVICE) -> Engine:
    """The launcher's engine: reduced qwen2.5-3b, random weights from a
    seeded generator, 8 lanes of 96 tokens, 2 decode tokens a frame."""
    from .. import configs
    from ..models import build
    from ..models.common import init_params

    dev = resolve_device(device)
    model = build(configs.get("qwen2.5-3b").reduced())
    params = init_params(model.template(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    return Engine(model, params, n_lanes=8, max_len=96, decode_tokens=2,
                  device=dev)


def build_service(args: argparse.Namespace, engine: Engine | None = None,
                  **service_kw) -> AnalyticsService:
    """The service of parsed ``args`` on ``args.device``; with
    ``args.engine``, the engine rung serves through ``engine`` (by default
    :func:`reduced_engine`). ``service_kw`` go to ``AnalyticsService``.

    The engine rung pins one lane per stream, so ``--engine`` needs at
    most as many streams as the engine has lanes (8): at the default 16
    streams the first epoch raises ``ValueError``, as the reference's
    launcher does."""
    dev = resolve_device(args.device)
    system = profiles.EdgeSystem(
        n_cameras=args.streams, n_servers=args.islands,
        n_slots=max(args.epochs, 8),
        mean_bandwidth_hz=args.bandwidth_mhz * 1e6,
        mean_compute_flops=args.tflops * 1e12, seed=0)
    ctrl = lbcd.LBCDController(system, v=args.v, p_min=args.p_min,
                               device=dev)
    if not args.engine:
        return AnalyticsService(ctrl, mode="mm1", epoch_duration=1200.0,
                                **service_kw)
    return AnalyticsService(ctrl, mode="engine",
                            engine=engine or reduced_engine(dev),
                            epoch_duration=3.0, **service_kw)


def main(argv=None, device=DEFAULT_DEVICE) -> AnalyticsService:
    """Run the launcher on ``argv`` (default: the command line) and print
    its table; ``device`` is ``--device``'s default. Returns the
    service."""
    args = parse_args(argv, device)
    svc = build_service(args)
    print("epoch  pred-AoPI  meas-AoPI  acc     q")
    for t in range(args.epochs):
        r = svc.run_epoch(t)
        print(f"{t:>5d}  {r.predicted_aopi:9.4f}  {r.measured_aopi:9.4f}"
              f"  {r.accuracy:5.3f}  {r.q:5.2f}")
    print(f"\nmean measured AoPI {svc.mean_measured:.4f} s "
          f"(predicted {svc.mean_predicted:.4f} s)")
    return svc


if __name__ == "__main__":
    main()
