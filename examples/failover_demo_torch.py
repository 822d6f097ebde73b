"""Failover demo on the PyTorch port (``repro_torch``), the steps,
printed lines and assert of ``examples/failover_demo.py``: an island (a
model-parallel subgroup) dies mid-service and LBCD's server-selection
subproblem re-places its streams on the next epoch (the paper's
Algorithm 2 doubling as the fault-tolerance mechanism). Island 1 must be
drained.

    PYTHONPATH=src python examples/failover_demo_torch.py [--device cuda|cpu]
"""
import argparse

import numpy as np

from repro_torch.core import lbcd, profiles
from repro_torch.training.failure import failover_assignment


def main(device: str = "cuda") -> list:
    """Print the five epochs; return each epoch's (AoPI, island loads)."""
    system = profiles.EdgeSystem(n_cameras=16, n_servers=4, n_slots=12,
                                 seed=0)
    ctrl = lbcd.LBCDController(system, v=10.0, p_min=0.7, device=device)
    out = []

    def record(rec):
        load = np.bincount(np.asarray(rec.assign), minlength=4)
        out.append((rec.mean_aopi, load.tolist()))
        return load

    print("epoch 0-2: healthy islands")
    for t in range(3):
        rec = ctrl.step(t)
        load = record(rec)
        print(f"  t={t} AoPI={rec.mean_aopi:.4f} island-load={load}")

    print("\nepoch 3: island 1 fails -> LBCD re-solves placement")
    dead = np.array([False, True, False, False])
    rec = failover_assignment(ctrl, 3, dead)
    load = record(rec)
    print(f"  t=3 AoPI={rec.mean_aopi:.4f} island-load={load} "
          f"(island 1 drained)")
    assert load[1] == 0

    print("\nepoch 4: island restored")
    rec = ctrl.step(4)
    load = record(rec)
    print(f"  t=4 AoPI={rec.mean_aopi:.4f} island-load={load}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
