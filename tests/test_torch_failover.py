"""The port's straggler monitor and island failover held against the JAX
package's on the CPU: the EWMA masks and microbatch weights bitwise, the
zeroed capacities bitwise, and one failover epoch of the LBCD controller
(assignment bitwise, floats at the rollout contract's 1e-3)."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import lbcd as j_lbcd  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro.training import failure as j_fail  # noqa: E402
from repro_torch.core import lbcd as t_lbcd  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402
from repro_torch.training import failure as t_fail  # noqa: E402

SYSTEM = dict(n_cameras=10, n_servers=3, seed=0)
DEAD = np.array([False, True, False])


def _step_times(seed, n_steps=40, n_workers=6):
    """Step times around 1 s with one worker slowing down from step 20."""
    rng = np.random.default_rng(seed)
    times = rng.normal(1.0, 0.02, (n_steps, n_workers))
    times[20:, 3] *= np.linspace(1.0, 1.6, n_steps - 20)
    return times


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, dict(alpha=0.3,
                                                      k_sigma=2.0,
                                                      warmup=4))])
def test_straggler_monitor_bitwise(seed, kw):
    mj = j_fail.StragglerMonitor(6, **kw)
    mt = t_fail.StragglerMonitor(6, **kw)
    flagged = False
    for times in _step_times(seed):
        a, b = mj.observe(times), mt.observe(times)
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(mt.mean, mj.mean)
        np.testing.assert_array_equal(mt.var, mj.var)
        np.testing.assert_array_equal(mt.rebalance_weights(),
                                      mj.rebalance_weights())
        flagged |= bool(b[3])
        assert not b[[0, 1, 2, 4, 5]].any()
    assert flagged and mt.count == mj.count == 40


def test_fail_islands_bitwise():
    rng = np.random.default_rng(2)
    b = rng.uniform(1e7, 3e7, 5).astype(np.float32)
    c = rng.uniform(1e13, 4e13, 5)
    for dead in (np.array([0, 1, 0, 0, 1], bool), np.array([3]),
                 np.zeros(5, bool)):
        for x, y in zip(t_fail.fail_islands(b, c, dead),
                        j_fail.fail_islands(b, c, dead)):
            assert x.dtype == y.dtype == np.float64
            np.testing.assert_array_equal(x, y)
    assert b.dtype == np.float32 and (b > 0).all()       # inputs untouched


def test_failover_assignment_matches_reference():
    """Server 1 dead at slot 3: no stream lands on it, the record matches
    the reference's, and the system's capacities are the undamaged ones
    afterwards."""
    cj = j_lbcd.LBCDController(j_prof.EdgeSystem(**SYSTEM))
    ct = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM), device="cpu")
    healthy = ct.system.capacities(3)
    rj = j_fail.failover_assignment(cj, 3, DEAD)
    rt = t_fail.failover_assignment(ct, 3, DEAD)
    assert not DEAD[rt.assign].any()
    np.testing.assert_array_equal(rt.assign, rj.assign)
    for f in ("r_idx", "m_idx", "pol"):
        np.testing.assert_array_equal(getattr(rt.decision, f),
                                      getattr(rj.decision, f))
    for f in ("b", "c", "lam", "mu", "acc", "aopi"):
        np.testing.assert_allclose(getattr(rt.decision, f),
                                   getattr(rj.decision, f), rtol=1e-3,
                                   err_msg=f)
    assert rt.q == pytest.approx(rj.q, rel=1e-3)
    assert rt.t == 3
    for x, y in zip(ct.system.capacities(3), healthy):
        np.testing.assert_array_equal(x, y)
        assert (x > 0).all()
    # The same epoch without failover places streams on every server.
    rec = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM),
                                device="cpu").step(3)
    assert set(rec.assign.tolist()) == {0, 1, 2}


def test_failover_restores_capacities_when_step_raises():
    ct = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM), device="cpu")
    sys = ct.system
    orig = sys.capacities
    seen = []

    def failing(t, tables=None):
        seen.append(sys.capacities(t))
        raise RuntimeError("solver failed")

    ct.step = failing
    with pytest.raises(RuntimeError, match="solver failed"):
        t_fail.failover_assignment(ct, 2, DEAD)
    assert seen and (seen[0][0][1] == 0 and seen[0][1][1] == 0)
    assert sys.capacities == orig
    np.testing.assert_array_equal(sys.capacities(2)[0], orig(2)[0])
    assert sys.capacities(2)[0][1] > 0


def test_failover_refuses_a_stream_on_a_dead_island():
    """The assertion that guards the re-placement: a controller whose step
    leaves a stream on the dead island fails it."""
    ct = t_lbcd.LBCDController(t_prof.EdgeSystem(**SYSTEM), device="cpu")
    good = ct.step

    def stuck(t, tables=None):
        rec = good(t)
        return dataclasses.replace(rec, assign=np.ones_like(rec.assign))

    ct.step = stuck
    with pytest.raises(AssertionError, match="dead island"):
        t_fail.failover_assignment(ct, 1, DEAD)
