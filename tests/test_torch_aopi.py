"""The port's AoPI math, Lyapunov queue, profiles and device policy held
against the JAX package on the same numpy-seeded inputs (CPU)."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import aopi as j_aopi  # noqa: E402
from repro.core import lyapunov as j_lyap  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro_torch import device as t_device  # noqa: E402
from repro_torch.core import aopi as t_aopi  # noqa: E402
from repro_torch.core import lyapunov as t_lyap  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402


def _rates(seed, n=257):
    """lam, mu, p with both stable and unstable FCFS points."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(2.0, 60.0, n).astype(np.float32)
    lam = (mu * rng.uniform(0.05, 1.3, n)).astype(np.float32)
    p = rng.uniform(0.05, 1.0, n).astype(np.float32)
    pol = (rng.random(n) < 0.5).astype(np.int32)
    return lam, mu, p, pol


def _both(fn_name, *args):
    j = np.asarray(getattr(j_aopi, fn_name)(*map(jnp.asarray, args)))
    t = getattr(t_aopi, fn_name)(*map(torch.as_tensor, args)).numpy()
    return j, t


@pytest.mark.parametrize("fn", ["aopi_fcfs", "aopi_lcfsp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_closed_forms_match_reference(fn, seed):
    lam, mu, p, _ = _rates(seed)
    j, t = _both(fn, lam, mu, p)
    np.testing.assert_array_equal(np.isinf(j), np.isinf(t))
    fin = np.isfinite(j)
    np.testing.assert_allclose(t[fin], j[fin], rtol=1e-5)


def test_policy_dispatch_and_masked_match_reference():
    lam, mu, p, pol = _rates(2)
    j, t = _both("aopi", lam, mu, p, pol)
    fin = np.isfinite(j)
    np.testing.assert_array_equal(fin, np.isfinite(t))
    np.testing.assert_allclose(t[fin], j[fin], rtol=1e-5)
    # Dead streams (zero rates or inactive) give exactly 0.0.
    lam[:5] = 0.0
    mu[5:10] = 0.0
    active = np.ones_like(lam)
    active[10:15] = 0.0
    jm = np.asarray(j_aopi.aopi_masked(lam, mu, p, pol, active=active))
    tm = t_aopi.aopi_masked(torch.as_tensor(lam), torch.as_tensor(mu),
                            torch.as_tensor(p), torch.as_tensor(pol),
                            active=torch.as_tensor(active)).numpy()
    assert (tm[:15] == 0.0).all()
    fin = np.isfinite(jm)
    np.testing.assert_allclose(tm[fin], jm[fin], rtol=1e-5)


@pytest.mark.parametrize("fn", ["d_aopi_lcfsp_dlam", "d_aopi_lcfsp_dmu",
                                "d_aopi_fcfs_dlam", "d_aopi_fcfs_dmu"])
def test_derivatives_match_reference(fn):
    lam, mu, p, _ = _rates(3)
    lam = np.minimum(lam, 0.95 * mu).astype(np.float32)   # stable branch
    j, t = _both(fn, lam, mu, p)
    np.testing.assert_allclose(t, j, rtol=1e-5)


def test_policy_threshold_and_optimal_policy():
    rho = np.linspace(0.01, 1.5, 300).astype(np.float32)
    j, t = _both("policy_threshold", rho)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
    lam, mu, p, _ = _rates(4)
    j, t = _both("optimal_policy", lam, mu, p)
    assert (j != t).mean() < 0.01     # only where p sits on the threshold


def test_argmin_lam_fcfs_matches_reference():
    _, mu, p, _ = _rates(5)
    j, t = _both("argmin_lam_fcfs", mu, p)
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert (t < mu).all() and (t > 0).all()


def test_powers_are_explicit_products():
    """x**3 and x**4 follow XLA's integer_pow association bitwise."""
    x = torch.as_tensor(np.random.default_rng(6).uniform(0.1, 50.0, 1000)
                        .astype(np.float32))
    np.testing.assert_array_equal(t_aopi._cube(x).numpy(),
                                  (x * (x * x)).numpy())
    np.testing.assert_array_equal(t_aopi._quad(x).numpy(),
                                  ((x * x) * (x * x)).numpy())


def test_lyapunov_matches_reference():
    rng = np.random.default_rng(7)
    aopi_v = rng.uniform(0.01, 0.2, 30).astype(np.float32)
    acc = rng.uniform(0.3, 0.9, 30).astype(np.float32)
    for q in (0.0, 0.4, 2.5):
        assert float(t_lyap.queue_update(torch.tensor(q), 0.65, 0.7)) == \
            pytest.approx(float(j_lyap.queue_update(q, 0.65, 0.7)), rel=1e-6)
        assert float(t_lyap.drift_plus_penalty(
            torch.as_tensor(aopi_v), torch.as_tensor(acc), q, 10.0)) == \
            pytest.approx(float(j_lyap.drift_plus_penalty(
                aopi_v, acc, q, 10.0)), rel=1e-5)
    vq_j, vq_t = j_lyap.VirtualQueue(0.7), t_lyap.VirtualQueue(0.7)
    for p_bar in (0.5, 0.9, 0.6):
        assert vq_t.update(p_bar) == vq_j.update(p_bar)


# ---------------------------------------------------------------------------
# Profiles: host numpy draws seeded as the reference seeds them.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,s,t,seed", [(10, 3, 8, 0), (37, 5, 4, 3)])
def test_edge_system_horizon_bitwise(n, s, t, seed):
    j = j_prof.EdgeSystem(n_cameras=n, n_servers=s, n_slots=6, seed=seed)
    tt = t_prof.EdgeSystem(n_cameras=n, n_servers=s, n_slots=6, seed=seed)
    hj = j.horizon(t)
    ht = tt.horizon(t, device="cpu")
    for f in ("acc", "xi", "size", "eff", "budgets_b", "budgets_c"):
        a, b = np.asarray(getattr(hj, f)), getattr(ht, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ht.active is None and ht.n_slots == t and ht.n_servers == s
    # The per-slot legacy path draws the same stream too.
    for k in range(2):
        sj, st = j.tables(k), tt.tables(k)
        np.testing.assert_array_equal(sj.acc, st.acc)
        np.testing.assert_array_equal(j.capacities(k)[0],
                                      tt.capacities(k)[0])


def test_horizon_from_numpy_roundtrip_and_views():
    hj = j_prof.EdgeSystem(n_cameras=12, n_servers=3, n_slots=5,
                           seed=2).horizon(5)
    fields = {f: np.asarray(getattr(hj, f))
              for f in ("acc", "xi", "size", "eff", "budgets_b",
                        "budgets_c")}
    ht = t_prof.horizon_from_numpy(fields, "cpu")
    back = t_prof.horizon_to_numpy(ht)
    assert set(back) == set(fields)
    for f, a in fields.items():
        np.testing.assert_array_equal(back[f], a, err_msg=f)
    # window / eff_sequence / stack_horizons mirror the reference.
    wj, wt = hj.window(1, 4), ht.window(1, 4)
    np.testing.assert_array_equal(np.asarray(wj.acc), wt.acc.numpy())
    np.testing.assert_array_equal(np.asarray(j_prof.eff_sequence(hj)),
                                  t_prof.eff_sequence(ht).numpy())
    with pytest.raises(ValueError, match="outside horizon"):
        ht.window(3, 9)
    st = t_prof.stack_horizons([ht, ht])
    assert tuple(st.acc.shape) == (2,) + tuple(ht.acc.shape)
    other = t_prof.EdgeSystem(n_cameras=7, n_servers=3).horizon(
        5, device="cpu")
    with pytest.raises(ValueError, match="'acc'"):
        t_prof.stack_horizons([ht, other])


def test_host_generators_match_reference():
    u = np.random.default_rng(8).normal(size=(33, 4))
    np.testing.assert_array_equal(t_prof.ar1_scan(u, 0.85),
                                  j_prof.ar1_scan(u, 0.85))
    np.testing.assert_array_equal(t_prof.drift_path(5, 9, 11),
                                  j_prof.drift_path(5, 9, 11))
    for tp, jp in ((t_prof.paper_pool(), j_prof.paper_pool()),
                   (t_prof.lm_pool(), j_prof.lm_pool())):
        assert [dataclass_tuple(m) for m in tp] == \
            [dataclass_tuple(m) for m in jp]
    assert t_prof.RESOLUTIONS == j_prof.RESOLUTIONS


def dataclass_tuple(m):
    return (m.name, m.params_m, m.gflops_ref, m.p_max, m.r_knee, m.task)


# ---------------------------------------------------------------------------
# Device policy
# ---------------------------------------------------------------------------

def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_prof.EdgeSystem(n_cameras=4, n_servers=2, n_slots=2).horizon(2)
    assert t_device.resolve_device("cpu") == torch.device("cpu")
