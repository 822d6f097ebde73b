"""Scenario-suite quickstart on the PyTorch port (``repro_torch``), the
steps, flags and printed lines of ``examples/scenario_suite.py``:
adversarial dynamics x every policy.

1. Build the registered scenario suite (Gilbert-Elliott bursty channels,
   diurnal + flash-crowd load, server outages, camera SNR mobility,
   content bursts, camera churn, correlated fades, plus the steady AR(1)
   anchor) as one stacked ``HorizonTables``.
2. Sweep LBCD and the MIN/DOS/JCAB baselines over the whole suite, per
   policy on the card (``loop``), or, started under ``torchrun`` with
   several ranks, the scenarios split over them (``shard_map``)::

       torchrun --nproc-per-node 4 examples/scenario_suite_torch.py --smoke

   (``--device cpu`` runs the ranks over gloo). The port's backends are
   ``loop``, ``shard_map`` and ``fleet``; ``XLA_FLAGS`` plays no part.
3. ``--dataplane`` also replays every (policy, scenario) pair through the
   GI/G/1 data plane for measured AoPI beside the closed form;
   ``--delay-model`` picks the delay family, ``auto`` fits it from the
   service's telemetry.
4. ``--engine`` (implies ``--dataplane``) climbs to the third rung: every
   cell also drives the continuous-batching engine (``--engine-backend``
   ``des``, ``scan`` or ``auto``).
5. Print the per-family robustness report and each policy's worst family
   (with ``--dataplane``, its worst model-vs-measurement gap).
6. ``--obs DIR`` streams spans and metrics of the run into DIR.

    PYTHONPATH=src python examples/scenario_suite_torch.py \
        [--smoke] [--dataplane] [--engine] \
        [--engine-backend des|scan|auto] \
        [--delay-model mm1|uniform|gamma|lognormal|weibull|auto] \
        [--obs DIR] [--device cuda|cpu]
"""
import argparse
import os

from repro_torch import obs, scenarios, serving
from repro_torch.core import queues


def main(smoke: bool = False, dataplane: bool = False,
         delay_model: str = "mm1", engine: bool = False,
         engine_backend: str = "scan", obs_dir: str | None = None,
         device: str = "cuda", names=None, dims: dict | None = None):
    """Print the sweep and its report; return the sweep's result.
    ``names``: a subset of the registered scenarios (all by default);
    ``dims`` replaces the sizes ``smoke`` picks."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        from repro_torch.launch.mesh import init_distributed
        device = init_distributed(device)
    say = print if int(os.environ.get("RANK", 0)) == 0 else \
        (lambda *a, **k: None)
    if obs_dir:
        obs.configure(run_dir=obs_dir)
    dataplane = dataplane or engine
    dims = dims or (dict(n_cameras=6, n_slots=16, n_servers=2) if smoke
                    else dict(n_cameras=16, n_slots=60, n_servers=3))
    s = scenarios.suite(names, device=device, **dims)
    say(f"suite: {s.n_scenarios} scenarios / "
        f"{len(set(s.families))} families -> {', '.join(s.names)}")

    dp_params = (dict(n_epochs=6, epoch_duration=400.0) if smoke
                 else dict(n_epochs=16, epoch_duration=600.0))
    dp_params["delay_model"] = delay_model
    if engine:
        dp_params["mode"] = "engine"
        if engine_backend == "des":
            # The DES pins one lane per stream and replays real decode
            # steps, so bound its per-epoch work tightly.
            dp_params["engine_params"] = {"backend": "des",
                                          "frames_cap": 24 if smoke else 96}
        else:
            # The tick-scan backend replays the same engine as one kernel
            # launch an epoch, at the full frames cap.
            dp_params["engine_params"] = {"backend": engine_backend}
        if smoke:
            dp_params["n_epochs"] = 3
            dp_params["epoch_duration"] = 120.0
    res = scenarios.sweep(s, v=10.0, p_min=0.7, dataplane=dataplane,
                          dataplane_params=dp_params, device=device)
    say(f"sweep backend: {res.backend} ({world} rank(s))"
        + (f"; data plane: {delay_model} x {dp_params['n_epochs']} "
           f"epochs" if dataplane else "")
        + (f"; rung 3: engine backend={engine_backend}" if engine
           else "") + "\n")

    rep = scenarios.robustness(res)
    say(rep)
    say()
    for policy in res.policies:
        fam, stats = rep.worst_family(policy)
        line = (f"{policy:<5s} worst family: {fam} "
                f"(worst-slot AoPI {stats.worst_aopi:.4f}, "
                f"p95 {stats.pct_aopi:.4f})")
        if dataplane:
            dfam, div = rep.worst_divergence(policy)
            line += f"; worst model-vs-measured gap: {dfam} ({div:+.2%})"
        say(line)
    if engine and rep.has_engine:
        say("\nengine rung present for all families:",
            all(rep.table[p][f].engine_mean is not None
                for p in res.policies for f in rep.families))

    if obs_dir:
        paths = obs.write_artifacts(obs_dir)
        say(f"\nobs artifacts: {', '.join(sorted(paths.values()))}")
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny dimensions for CI smoke runs")
    ap.add_argument("--dataplane", action="store_true",
                    help="replay each (policy, scenario) through the "
                         "data plane for measured-vs-predicted AoPI")
    ap.add_argument("--engine", action="store_true",
                    help="also drive every cell through the "
                         "continuous-batching engine (truth ladder rung "
                         "3; implies --dataplane)")
    ap.add_argument("--engine-backend", default="scan",
                    choices=serving.ENGINE_BACKENDS,
                    help="engine-rung executor: 'scan' (default), 'des' "
                         "or 'auto'")
    ap.add_argument("--delay-model", default="mm1",
                    choices=queues.DELAY_MODELS + (queues.AUTO_DELAY_MODEL,),
                    help="data-plane delay family; 'auto' fits the family "
                         "from service telemetry")
    ap.add_argument("--obs", default=None, metavar="DIR",
                    help="write repro_torch.obs artifacts here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.smoke, args.dataplane, args.delay_model, args.engine,
         args.engine_backend, args.obs, args.device)
