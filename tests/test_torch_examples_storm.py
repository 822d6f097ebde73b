"""``examples/fault_storm_torch.py`` on the CPU, held against the JAX
package's functions that ``examples/fault_storm.py`` calls with the same
arguments: the storm plan over its 16 slots, four cameras on two
servers, 20 s epochs (the reference script's smoke run takes minutes on
this CPU's plain data plane), the LBCD policy, the churned scenario (the
fleet mask through every rollout; the other two replay as the card's
smoke run shows, PERF.md), a 2-epoch degradation report.

Bars: every fault counter exactly, the measured AoPI of every slot
within 1e-3 relative, and the obs reconciliation the script asserts.
One slot is pinned apart (``PINNED``, ROADMAP §3): in slot 10 of
``camera_churn`` the two packages' first-fit placements of the three
live cameras differ (the reference puts camera 1 alone on server 1, the
port camera 3), so its AoPI differs by 2.5%. Neither package is wrong:
fed the same plan window, both place every camera of every slot alike
(held below). Their windows differ: the telemetry-corrected link
efficiencies of the window planned at slot 8 differ by up to 9.06e-6
(1.3e-6 relative), grown through the telemetry EWMA from the f32 solves'
ulp-level differences (and dead camera 2's accuracy by 7.4e-5, which the
mask keeps out of the solve). Four BCD iterations of the virtual-server
solve do not converge on that slot's flat objective (camera 1's
bandwidth moves by 5% between 4 and 16 iterations, the score by 1e-5
relative): the eff difference moves camera 1's bandwidth from 4,124,076
to 4,042,970 Hz, and camera 3's Eq. (56) volume, 0.6495 against camera
1's 0.6624, passes it (0.6559 against 0.6534), which changes the
first-fit order.
"""
import contextlib
import dataclasses
import importlib.util
import io
import pathlib

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import scenarios  # noqa: E402
from repro.core import lbcd as j_lbcd  # noqa: E402
from repro.faults import storm_plan  # noqa: E402
from repro.serving.replay import replay_tables  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DIMS = dict(n_cameras=4, n_slots=16, n_servers=2, mean_bandwidth_hz=15e6,
            mean_compute_flops=20e12)
REPLAY = dict(epoch_duration=20.0)
# (scenario, slot) -> (the reference's measured AoPI, the port's): the
# inputs that differ and by how much are in the module docstring.
PINNED = {("camera_churn", 10): (0.0239022, 0.0233013)}


@pytest.fixture(scope="module")
def storm():
    """The port's script (its output captured) and the reference's
    replays of the same cells, each package's LBCD plan windows
    recorded: (the script's result, its output, {cell: the reference's
    replay}, {package: [(tables as numpy, q0, v, p_min, kw, assign)]})."""
    spec = importlib.util.spec_from_file_location(
        "fault_storm_torch", ROOT / "examples/fault_storm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from repro_torch import obs
    from repro_torch.core import lbcd as t_lbcd
    windows = {"ref": [], "port": []}

    def recorder(cls, key, to_np):
        real = cls.plan

        def plan(self, tables, q0=None):
            out = real(self, tables, q0)
            windows[key].append((
                {f.name: to_np(getattr(tables, f.name))
                 for f in dataclasses.fields(tables)},
                self.queue.q if q0 is None else q0, self.v,
                self.queue.p_min,
                dict(n_bcd_iters=self.n_bcd_iters, method=self.method,
                     solver_effort=self.solver_effort),
                to_np(out.assign)))
            return out
        return plan

    def t_np(t):
        return None if t is None else t.cpu().numpy()

    def j_np(t):
        return None if t is None else np.asarray(t)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_lbcd.LBCDController, "plan",
                   recorder(t_lbcd.LBCDController, "port", t_np))
        mp.setattr(j_lbcd.LBCDController, "plan",
                   recorder(j_lbcd.LBCDController, "ref", j_np))
        # The script reconciles the process's obs counters with its own
        # service lists, as its own process would hold them: none from
        # other tests of this worker.
        obs.reset()
        try:
            with contextlib.redirect_stdout(out):
                got = mod.main(policies=("lbcd",), device="cpu", dims=DIMS,
                               n_epochs=2, replay_kw=REPLAY,
                               names=("camera_churn",))
        finally:
            obs.reset()
        plan = storm_plan(DIMS["n_slots"], seed=0)
        reps = {cell: replay_tables(scenarios.build(cell[0], **DIMS),
                                    cell[1], plan_window=4,
                                    telemetry_gain=0.2, faults=plan,
                                    **REPLAY)
                for cell in got["cells"]}
    return got, out.getvalue(), reps, windows


def test_fault_storm(storm):
    got, text, reps, _ = storm
    assert "reconciled:" in text and "degradation report" in text
    assert got["totals"]["service.fallback"] > 0
    for (scen, policy), (measured, counts) in got["cells"].items():
        svc = reps[scen, policy].service
        assert counts == {
            "service.fallback": len(svc.fallbacks),
            "service.degraded_epoch": len(svc.degraded_epochs),
            "service.plan_retry": len(svc.plan_failures),
            "service.telemetry_gap": len(svc.telemetry_gaps)}, scen
        want = np.asarray(reps[scen, policy].measured, np.float64)
        measured = np.asarray(measured, np.float64)
        keep = np.ones(len(want), bool)
        for (s, t), (ref, port) in PINNED.items():
            if s == scen:
                keep[t] = False
                np.testing.assert_allclose([want[t], measured[t]],
                                           [ref, port], rtol=1e-4)
        np.testing.assert_allclose(measured[keep], want[keep], rtol=1e-3,
                                   err_msg=scen)


def test_storm_placements_agree_on_the_same_windows(storm):
    """Every LBCD plan window of the churned replay, fed to the other
    package's rollout: the same placement of every camera in every slot,
    both ways. The pinned slot's windows differ only in the link
    efficiencies (within 1e-5 relative) and the dead camera's accuracy."""
    from repro.core import profiles as j_profiles
    from repro_torch.core import lbcd as t_lbcd
    from repro_torch.core import profiles as t_profiles
    _, _, _, windows = storm
    ref = windows["ref"]
    # The script's storm replay plans first; its degradation report
    # (which the reference's replay has no counterpart of here) after.
    port = windows["port"][:len(ref)]
    assert len(ref) == len(port) >= 4
    for (tab, q0, v, p_min, kw, assign) in ref:
        t_tab = t_profiles.HorizonTables(**{
            k: None if a is None else torch.tensor(a)
            for k, a in tab.items()})
        got = t_lbcd.rollout(t_tab, v, p_min, q0, device="cpu", **kw)
        np.testing.assert_array_equal(got.assign.numpy(), assign)
    for (tab, q0, v, p_min, kw, assign) in port:
        j_tab = j_profiles.HorizonTables(**{
            k: None if a is None else jnp.asarray(a)
            for k, a in tab.items()})
        got = j_lbcd.rollout(j_tab, v, p_min, q0, **kw)
        np.testing.assert_array_equal(np.asarray(got.assign), assign)
    # The window holding slot 10: planned from slot 8, its third slot.
    (scen, t), _ = next(iter(PINNED.items()))
    i = next(k for k, w in enumerate(ref)
             if not np.array_equal(w[5], port[k][5]))
    (rt, *_, ra), (pt, *_, pa) = ref[i], port[i]
    j = t - 8
    assert not np.array_equal(ra[j], pa[j])
    live = rt["active"][j] > 0
    for k in rt:
        if k == "eff":
            np.testing.assert_allclose(pt[k], rt[k], rtol=1e-5)
        elif k == "acc":
            np.testing.assert_array_equal(pt[k][:, live], rt[k][:, live])
        elif rt[k] is not None:
            np.testing.assert_array_equal(pt[k], rt[k], err_msg=k)
