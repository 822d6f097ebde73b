"""End-to-end serving run on the PyTorch port (``repro_torch``), the
steps, flags and printed lines of ``examples/serve_e2e.py``: a small LM
serves batched frame-analysis requests from multiple streams while the
LBCD controller adapts per-stream configuration (model, fidelity,
policy) each epoch.

Two data planes:
  * default   - the M/M/1 data plane at the controller's chosen rates
                (validates the closed forms at service scale);
  * --engine  - the continuous-batching engine serving the reduced
                qwen2.5-3b on the card (its attention kernels), with
                LCFSP preemption at step boundaries.

    PYTHONPATH=src python examples/serve_e2e_torch.py [--engine] \
        [--epochs 6] [--streams 12] [--device cuda|cpu]
"""
import argparse

from repro_torch.core import lbcd, profiles
from repro_torch.serving import AnalyticsService, Engine


def main(argv=None, epoch_duration: float = 1500.0) -> list:
    """Print each epoch's report and the means; return the reports.
    ``epoch_duration``: the M/M/1 plane's epoch (seconds)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--streams", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    system = profiles.EdgeSystem(
        n_cameras=args.streams, n_servers=2, n_slots=max(args.epochs, 8),
        mean_bandwidth_hz=12e6, mean_compute_flops=15e12, seed=0)
    ctrl = lbcd.LBCDController(system, v=10.0, p_min=0.7,
                               device=args.device)

    if args.engine:
        import torch

        from repro_torch import configs
        from repro_torch.models import build
        from repro_torch.models.common import init_params

        cfg = configs.get("qwen2.5-3b").reduced()
        model = build(cfg)
        params = init_params(model.template(),
                             torch.Generator(device=args.device)
                             .manual_seed(0), device=args.device)
        # The engine replay plane pins one lane per stream.
        eng = Engine(model, params, n_lanes=args.streams, max_len=96,
                     decode_tokens=2, device=args.device)
        svc = AnalyticsService(ctrl, mode="engine", engine=eng,
                               epoch_duration=3.0, engine_frames_cap=32)
    else:
        svc = AnalyticsService(ctrl, mode="mm1",
                               epoch_duration=epoch_duration)

    print("epoch  predicted-AoPI  measured-AoPI  accuracy     q")
    reports = []
    for t in range(args.epochs):
        r = svc.run_epoch(t)
        reports.append(r)
        print(f"{t:>5d}  {r.predicted_aopi:13.4f}  {r.measured_aopi:12.4f}"
              f"  {r.accuracy:8.3f}  {r.q:6.3f}")
    dev = abs(svc.mean_predicted - svc.mean_measured) / max(
        svc.mean_measured, 1e-9)
    print(f"\nmean predicted {svc.mean_predicted:.4f} s | "
          f"mean measured {svc.mean_measured:.4f} s | deviation {dev:.1%}")
    return reports


if __name__ == "__main__":
    main()
