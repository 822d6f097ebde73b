"""Quickstart on the PyTorch port (``repro_torch``): the paper's core
loop, the steps and printed lines of ``examples/quickstart.py``.

1. Validate the AoPI closed forms (Theorems 1-2) against the
   discrete-event oracle for one configuration.
2. Run the LBCD controller on a small edge system (its slot-solver
   kernels on the card) and compare against the DOS / JCAB / MIN
   baselines.
3. Sweep the (V, P_min) hyperparameter grid with ``lbcd.rollout_grid``.

Where the port differs: ``rollout_grid`` is a loop of rollouts, one a
grid point, not one vmapped call.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]
"""
import argparse

import torch

from repro_torch.core import aopi, baselines, lbcd, profiles, queues


def main(device: str = "cuda", n_slots: int = 25) -> dict:
    """Print the three steps; return their numbers. ``n_slots``: the
    horizon of steps 2 and 3."""
    out = {}
    # --- 1. AoPI theory vs simulation --------------------------------
    lam, mu, p = 5.0, 10.0, 0.8
    a_f, a_l = float(aopi.aopi_fcfs(lam, mu, p)), float(
        aopi.aopi_lcfsp(lam, mu, p))
    s_f = queues.simulate_fcfs(lam, mu, p, 200_000).mean_aopi
    s_l = queues.simulate_lcfsp(lam, mu, p, 200_000).mean_aopi
    print("Theorem 1 (FCFS):   A_F =", f"{a_f:.4f} s (sim: {s_f:.4f})")
    print("Theorem 2 (LCFSP):  A_L =", f"{a_l:.4f} s (sim: {s_l:.4f})")
    rho = lam / mu
    thr = float(aopi.policy_threshold(rho))
    lcfsp = bool(aopi.optimal_policy(lam, mu, p))
    print(f"Theorem 3 threshold at rho={rho}: p* = {thr:.3f} -> optimal "
          f"policy for p={p}: {'LCFSP' if lcfsp else 'FCFS'}")
    out.update(a_f=a_f, a_l=a_l, sim_f=s_f, sim_l=s_l, threshold=thr,
               lcfsp=lcfsp)

    # --- 2. LBCD vs baselines ----------------------------------------
    def system():
        return profiles.EdgeSystem(n_cameras=20, n_servers=3,
                                   n_slots=n_slots,
                                   mean_bandwidth_hz=15e6,
                                   mean_compute_flops=25e12, seed=0)

    print("\ncontroller     mean AoPI   mean accuracy")
    s = lbcd.LBCDController(system(), v=10.0, p_min=0.7,
                            device=device).run(n_slots)
    print(f"LBCD           {s.mean_aopi:9.4f}   {s.mean_acc:.3f}")
    out["LBCD"] = (s.mean_aopi, s.mean_acc)
    for name in ("MIN", "DOS", "JCAB"):
        b = baselines.make(name, system(), device=device).run(n_slots)
        print(f"{name:<14s} {b.mean_aopi:9.4f}   {b.mean_acc:.3f}")
        out[name] = (b.mean_aopi, b.mean_acc)

    # --- 3. (V, P_min) grid: one rollout a grid point ----------------
    tables = system().horizon(n_slots, device=device)
    vs = torch.tensor([1.0, 10.0, 100.0])
    p_mins = torch.tensor([0.7, 0.7, 0.7])
    grid = lbcd.rollout_grid(tables, vs, p_mins, device=device)
    print("\nV sweep (rollout_grid, a loop of rollouts):")
    out["grid"] = []
    for g, v in enumerate(vs.tolist()):
        a, c = float(grid.aopi[g].mean()), float(grid.acc[g].mean())
        print(f"  V={v:6.1f}  mean AoPI {a:.4f}  mean acc {c:.3f}")
        out["grid"].append((a, c))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
