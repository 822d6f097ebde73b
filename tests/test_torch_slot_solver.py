"""The port's slot solver held against the JAX package on the CPU. The
kernels against their plain versions on the card: tests/test_torch_gpu.py.

On the CPU every wrapper in ``repro_torch.kernels.slot_solver.ops`` takes
its plain PyTorch version; the JAX side runs its jnp path and its Pallas
kernels in interpret mode, as the JAX package's own tests do.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import allocate as j_alloc  # noqa: E402
from repro.core import bcd as j_bcd  # noqa: E402
from repro.core import profiles as j_prof  # noqa: E402
from repro.kernels import slot_solver as j_ss  # noqa: E402
from repro_torch.core import allocate as t_alloc  # noqa: E402
from repro_torch.core import bcd as t_bcd  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.slot_solver import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.slot_solver import ops as t_ops  # noqa: E402
from repro_torch.kernels.slot_solver import ref as t_ref  # noqa: E402

# Largest score gap, in float32 ulps, at which a config index may differ
# from the JAX side: XLA-CPU contracts a*b+c into FMA inside fused loops,
# the port never does, so two candidates whose scores are within a few ulp
# can swap order. Any other mismatch fails.
NEAR_TIE_ULPS = 4


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x)) if dtype is None else \
        torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------------------
# ServerLayout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sid,n_servers,capacity", [
    ([2, 0, 2, 1, 0, 2, 0], 3, None),
    ([0, 0, 2, 2], 3, None),                        # empty server 1
    ([0] * 130, 1, 100),                            # row-view overflow
    (list(np.random.default_rng(0).integers(0, 5, 300)), 5, None),
])
def test_server_layout_bitwise(sid, n_servers, capacity):
    sid = np.asarray(sid, np.int32)
    lj = j_ss.server_layout(jnp.asarray(sid), n_servers, capacity=capacity)
    lt = t_ops.server_layout(_t(sid), n_servers, capacity=capacity)
    for f in ("counts", "flat_order", "flat_sid", "flat_mask", "order",
              "mask"):
        a, b = np.asarray(getattr(lj, f)), getattr(lt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert lt.capacity == lj.capacity
    # The kernels' view: server s owns camera_order[start[s]:+counts[s]].
    order = lt.camera_order.numpy()
    for s in range(n_servers):
        seg = order[lt.start[s]:lt.start[s] + lt.counts[s]]
        assert (sid[seg] == s).all() and list(seg) == sorted(seg)


# ---------------------------------------------------------------------------
# config_argmin: the plain version vs the reference's ref and Pallas kernel
# ---------------------------------------------------------------------------

def _config_inputs(n, seed=0, m=5, r=6):
    rng = np.random.default_rng(seed)
    acc = rng.uniform(0.2, 0.95, (n, m, r)).astype(np.float32)
    xi = np.sort(rng.uniform(1e9, 2e11, (m, r)), axis=1).astype(np.float32)
    size = (1.2 * np.asarray(j_prof.RESOLUTIONS)[:r] ** 2).astype(np.float32)
    eff = rng.uniform(4.0, 7.0, n).astype(np.float32)
    b = rng.uniform(1e6, 1e7, n).astype(np.float32)
    c = rng.uniform(1e12, 1e13, n).astype(np.float32)
    return b, c, acc, xi, size, eff


def _paper_config_inputs(n, seed):
    """Paper pool (M=9, R=6) at the per-camera budget share of 30
    cameras on 3 servers."""
    tab = j_prof.EdgeSystem(n_cameras=n, n_servers=3, n_slots=2,
                            seed=seed).horizon(1)
    rng = np.random.default_rng(seed)
    b = rng.uniform(0.3, 3.0, n).astype(np.float32) * 3e6
    c = rng.uniform(0.3, 3.0, n).astype(np.float32) * 5e12
    return (b, c, np.asarray(tab.acc[0]), np.asarray(tab.xi),
            np.asarray(tab.size), np.asarray(tab.eff))


def _score_table(b, c, acc, xi, size, eff, q, v, n):
    """The port's [N, M*R*2] float32 score table (flat (m, r, pol))."""
    lam = (_t(b) * _t(eff))[:, None] / _t(size)[None, :]
    mu = _t(c)[:, None, None] / _t(xi)[None]
    lam_b = lam[:, None, :].expand(mu.shape)
    p = torch.clamp_min(_t(acc), 1e-3)
    from repro_torch.core import aopi as t_aopi
    a = torch.stack([t_aopi.aopi_fcfs(lam_b, mu, p),
                     t_aopi.aopi_lcfsp(lam_b, mu, p)], -1)
    s = (v * a - float(np.float32(q)) * _t(acc)[..., None]) / torch.tensor(
        float(n))
    return s.reshape(s.shape[0], -1).numpy()


def _assert_indices(port, other, scores, n_r, label):
    """Bitwise equal indices except documented near-ties; returns the
    number of near-ties (each measured at <= NEAR_TIE_ULPS)."""
    r_p, m_p, pol_p = (np.asarray(x) for x in port)
    r_o, m_o, pol_o = (np.asarray(x) for x in other)
    diff = (r_p != r_o) | (m_p != m_o) | (pol_p != pol_o)
    for i in np.flatnonzero(diff):
        f_p = m_p[i] * n_r * 2 + r_p[i] * 2 + pol_p[i]
        f_o = m_o[i] * n_r * 2 + r_o[i] * 2 + pol_o[i]
        s_p, s_o = scores[i, f_p], scores[i, f_o]
        gap = abs(float(s_p) - float(s_o)) / float(
            np.spacing(max(abs(s_p), abs(s_o))))
        assert gap <= NEAR_TIE_ULPS, (
            f"{label}: camera {i} picks flat {f_p} vs {f_o}, score gap "
            f"{gap:.1f} ulp")
    return int(diff.sum())


@pytest.mark.parametrize("kind,n,seed", [
    ("random", 7, 0), ("random", 40, 1), ("random", 64, 2),
    ("paper", 30, 0), ("paper", 300, 1), ("paper", 1000, 2)])
def test_config_argmin_ref_matches_reference(kind, n, seed):
    inputs = (_config_inputs(n, seed=seed) if kind == "random"
              else _paper_config_inputs(n, seed))
    q, v = np.float32(1.3), 10.0
    port = t_ref.config_argmin_ref(*map(_t, inputs), _t(q), v, n)
    scores = _score_table(*inputs, q, v, n)
    j_in = tuple(map(jnp.asarray, inputs))
    ref = j_ss.config_argmin_ref(*j_in, jnp.float32(q), v, n)
    pallas = j_ss.config_argmin(*j_in, jnp.float32(q), v, n,
                                backend="pallas", block_n=16)
    n_r = inputs[3].shape[1]
    ties = (_assert_indices(port, ref, scores, n_r, "jnp ref") +
            _assert_indices(port, pallas, scores, n_r, "pallas"))
    # Near-ties are rare: at most one camera in a hundred.
    assert ties <= max(1, n // 100), ties
    # The CPU wrapper is the plain version and launches nothing.
    t_ops.reset_launches()
    out = t_ops.config_argmin(*map(_t, inputs), _t(q), v, n)
    for a, b in zip(out, port):
        assert torch.equal(a, b)
    assert t_ops.launches["config_argmin"] == 0


# ---------------------------------------------------------------------------
# Water-fills: plain versions vs repro.allocate and the Pallas kernels
# ---------------------------------------------------------------------------

def _fill_setup(n, s, seed=0, lcfsp_frac=0.5, budget_lo=2e7, budget_hi=5e7,
                server_id=None):
    rng = np.random.default_rng(seed)
    k = rng.uniform(1e-6, 5e-6, n).astype(np.float32)
    p = rng.uniform(0.3, 0.95, n).astype(np.float32)
    pol = (rng.random(n) < lcfsp_frac).astype(np.int32)
    mu = rng.uniform(5.0, 40.0, n).astype(np.float32)
    inv_xi = rng.uniform(1e-12, 5e-12, n).astype(np.float32)
    if server_id is None:
        server_id = rng.integers(0, s, n).astype(np.int32)
    budgets_b = rng.uniform(budget_lo, budget_hi, s).astype(np.float32)
    budgets_c = rng.uniform(3e13, 8e13, s).astype(np.float32)
    return dict(k=k, p=p, pol=pol, mu=mu, inv_xi=inv_xi,
                sid=np.asarray(server_id, np.int32), bb=budgets_b,
                bc=budgets_c, s=s)


FILL_CASES = {
    "mixed": dict(n=12, s=3, seed=7),
    "all_fcfs": dict(n=10, s=2, seed=1, lcfsp_frac=0.0),
    "all_lcfsp": dict(n=10, s=2, seed=2, lcfsp_frac=1.0),
    "slack_budget": dict(n=8, s=2, seed=11, lcfsp_frac=0.0, budget_lo=5e9,
                         budget_hi=9e9),
    "single_camera_servers": dict(n=6, s=6, seed=3,
                                  server_id=np.arange(6)),
    "empty_server": dict(n=9, s=3, seed=4,
                         server_id=np.array([0, 0, 0, 2, 2, 0, 2, 0, 2])),
    "ragged": dict(n=37, s=5, seed=5),
}


def _fill_args(d, torch_side):
    cv = _t if torch_side else jnp.asarray
    return {k: (cv(v) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_waterfills_match_reference(case):
    d = _fill_setup(**FILL_CASES[case])
    t, j = _fill_args(d, True), _fill_args(d, False)
    s = d["s"]
    # Bandwidth.
    b_t = t_alloc.waterfill_bandwidth(t["k"], t["p"], t["pol"], t["mu"],
                                      t["sid"], t["bb"], s).numpy()
    b_j = np.asarray(j_alloc.waterfill_bandwidth(
        j["k"], j["p"], j["pol"], j["mu"], j["sid"], j["bb"], n_servers=s))
    b_pl = np.asarray(j_ss.waterfill_bandwidth(
        j["k"], j["p"], j["pol"], j["mu"], j["sid"], j["bb"], n_servers=s))
    np.testing.assert_allclose(b_t, b_j, rtol=2e-4, atol=1e-2)
    np.testing.assert_allclose(b_t, b_pl, rtol=2e-4, atol=1e-2)
    for srv in range(s):
        assert b_t[d["sid"] == srv].sum() <= d["bb"][srv] * 1.001
    # Compute at the reference's lam, so both sides see the same input.
    lam = (b_j * d["k"]).astype(np.float32)
    c_t = t_alloc.waterfill_compute(t["inv_xi"], t["p"], t["pol"], _t(lam),
                                    t["sid"], t["bc"], s).numpy()
    c_j = np.asarray(j_alloc.waterfill_compute(
        j["inv_xi"], j["p"], j["pol"], jnp.asarray(lam), j["sid"], j["bc"],
        n_servers=s))
    c_pl = np.asarray(j_ss.waterfill_compute(
        j["inv_xi"], j["p"], j["pol"], jnp.asarray(lam), j["sid"], j["bc"],
        n_servers=s))
    np.testing.assert_allclose(c_t, c_j, rtol=2e-4, atol=1e4)
    np.testing.assert_allclose(c_t, c_pl, rtol=2e-4, atol=1e4)
    # Pair: bandwidth -> floors -> compute.
    pb_t, pc_t = (x.numpy() for x in t_alloc.waterfill_pair(
        t["k"], t["p"], t["pol"], t["mu"], t["inv_xi"], t["sid"], t["bb"],
        t["bc"], s))
    pb_j, pc_j = (np.asarray(x) for x in j_ss.waterfill_pair(
        j["k"], j["p"], j["pol"], j["mu"], j["inv_xi"], j["sid"], j["bb"],
        j["bc"], s))
    np.testing.assert_allclose(pb_t, pb_j, rtol=2e-4, atol=1e-2)
    np.testing.assert_allclose(pc_t, pc_j, rtol=2e-4, atol=1e4)
    # The CPU wrappers are the plain versions and launch nothing.
    t_ops.reset_launches()
    wb, wc = t_ops.waterfill_pair(t["k"], t["p"], t["pol"], t["mu"],
                                  t["inv_xi"], t["sid"], t["bb"], t["bc"], s)
    np.testing.assert_array_equal(wb.numpy(), pb_t)
    np.testing.assert_array_equal(wc.numpy(), pc_t)
    assert sum(t_ops.launches.values()) == 0


def _kernel_segment_sum(x):
    """The water-fill kernels' segment_sum, step by step: pad to a power
    of two, then buf[j] = buf[j] + buf[j + h] for h = P/2, ..., 1."""
    x = [np.float32(v) for v in x]
    if len(x) <= 1:
        return x[0] if x else np.float32(0.0)
    h = 1
    while 2 * h < len(x):
        h *= 2
    buf = [x[j] + (x[j + h] if j + h < len(x) else np.float32(0.0))
           for j in range(h)]
    h //= 2
    while h >= 1:
        buf = [buf[j] + buf[j + h] for j in range(h)] + buf[2 * h:]
        h //= 2
    return buf[0]


@pytest.mark.parametrize("n,s", [(1, 1), (2, 1), (13, 3), (300, 7),
                                 (1000, 1)])
def test_tree_segment_sum_follows_the_kernel_order(n, s):
    """Bitwise the kernels' per-server reduction, stable order within each
    server, whatever the padding width."""
    rng = np.random.default_rng(n)
    x = rng.lognormal(0.0, 3.0, n).astype(np.float32)
    sid = rng.integers(0, s, n).astype(np.int32)
    if s == 3:
        sid[sid == 1] = 2                           # an empty segment
    got = t_alloc.tree_segment_sum(_t(x), t_alloc.segment_tree(_t(sid), s))
    for seg in range(s):
        want = _kernel_segment_sum(x[sid == seg])
        assert got[seg].item() == float(want), seg
    np.testing.assert_allclose(got.numpy(), np.bincount(sid, x, s),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The tiled water-fill: its sum order, its CTA count, and its plain version
# ---------------------------------------------------------------------------

def _residue_class_sum(x, group):
    """The tiled kernel's fill sum, step by step (csrc class_sum and
    ClusterTeam::sum): class g holds positions j = g (mod G) and is folded
    by the halving tree of width P/G (P = 2^k >= count); the G class sums
    are then folded by the halving tree of width G."""
    x = [np.float32(v) for v in x]
    count, zero = len(x), np.float32(0.0)
    p = 1
    while p < count:
        p *= 2
    parts = []
    for g in range(group):
        if count <= 1:
            parts.append(x[0] if g == 0 and count == 1 else zero)
        elif p <= group:
            parts.append(x[g] if g < count else zero)
        else:
            h = p // group // 2
            cnt = (count - g + group - 1) // group
            buf = [x[g + group * i] +
                   (x[g + group * (i + h)] if i + h < cnt else zero)
                   for i in range(h)]
            h //= 2
            while h >= 1:
                buf = [buf[i] + buf[i + h] for i in range(h)]
                h //= 2
            parts.append(buf[0])
    h = group // 2
    while h >= 1:
        parts = [parts[j] + parts[j + h] for j in range(h)]
        h //= 2
    return parts[0]


def _assert_residue_split_bitwise(count, group, seed):
    rng = np.random.default_rng(seed)
    # Values spanning six decades, so that any change of order shows.
    x = (rng.random(count) * 10.0 ** rng.integers(-3, 3, count)).astype(
        np.float32)
    want = t_alloc.tree_segment_sum(
        _t(x), t_alloc.segment_tree(_t(np.zeros(count, np.int32)), 1))[0]
    got = _residue_class_sum(x, group)
    assert np.float32(want.item()) == got, (count, group, seed)
    assert got == _kernel_segment_sum(x)


@pytest.mark.parametrize("group", [1, 2, 8, 64])
@pytest.mark.parametrize("count", [0, 1, 2, 3, 7, 8, 9, 63, 64, 65, 130,
                                   1001, 4097])
def test_residue_class_split_equals_tree_sum(count, group):
    """Splitting a segment over G CTAs by residue class and folding the G
    class sums by a width-G tree is bitwise the plain version's sum."""
    _assert_residue_split_bitwise(count, group, seed=count * 7 + group)


def test_residue_class_split_equals_tree_sum_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None, database=None)
    @given(st.integers(0, 5000), st.sampled_from([1, 2, 8, 64]),
           st.integers(0, 2**31 - 1))
    def inner(count, group, seed):
        _assert_residue_split_bitwise(count, group, seed)
    inner()


@pytest.mark.parametrize("n,s,tile,group", [
    (100_000, 1, 16384, 8),      # MIN's virtual server at auto's tile
    (10_000, 32, 256, 2),        # LBCD with tile=256: ~312 per server
    (100_000, 32, 128, 8),       # capped at one portable cluster
    (300, 5, 128, 1),            # tiled, but a mean segment fits one CTA
    (1001, 7, 128, 2),
    (128, 1, 128, None),         # the fleet fits in one tile: untiled
    (300, 5, None, None),
])
def test_tiled_group_follows_the_reference_switch(n, s, tile, group):
    """CTAs per server from the sizes alone; tiled exactly where the
    reference's ops switch to its tiled kernel (padded width > tile)."""
    assert t_ops.tiled_group(n, s, tile) == group
    if tile is not None:
        cap = j_ss.server_layout(jnp.zeros(n, jnp.int32), s).flat_order.shape[0]
        rounded = max(128, -(-tile // 128) * 128)
        assert (group is not None) == (cap > rounded)


@pytest.mark.parametrize("n,s,tile", [(37, 3, 128), (130, 2, 128),
                                      (300, 5, 256)])
def test_waterfills_match_reference_tiled(n, s, tile):
    """The tiled kernel's plain version (the port's water-fills) against
    repro's tiled Pallas kernel in interpret mode, at the bar the reference
    holds that kernel to against its jnp path (rtol=2e-4)."""
    for seed in (0, 1):
        d = _fill_setup(n, s, seed=seed)
        t, j = _fill_args(d, True), _fill_args(d, False)
        b_t = t_ops.waterfill_bandwidth(t["k"], t["p"], t["pol"], t["mu"],
                                        t["sid"], t["bb"], s,
                                        tile_n=tile).numpy()
        b_j = np.asarray(j_ss.waterfill_bandwidth(
            j["k"], j["p"], j["pol"], j["mu"], j["sid"], j["bb"],
            n_servers=s, tile_n=tile))
        np.testing.assert_allclose(b_t, b_j, rtol=2e-4, atol=1e-2)
        lam = (b_j * d["k"]).astype(np.float32)
        c_t = t_ops.waterfill_compute(t["inv_xi"], t["p"], t["pol"],
                                      _t(lam), t["sid"], t["bc"], s,
                                      tile_n=tile).numpy()
        c_j = np.asarray(j_ss.waterfill_compute(
            j["inv_xi"], j["p"], j["pol"], jnp.asarray(lam), j["sid"],
            j["bc"], n_servers=s, tile_n=tile))
        np.testing.assert_allclose(c_t, c_j, rtol=2e-4, atol=1e4)


def test_solve_slot_tiled_spec_matches_reference():
    """A tiled spec against repro's pallas:tile=128 solve end to end (as
    the reference's test_solve_slot_tiled_spec_matches_jnp): indices
    bitwise, allocations at rtol=5e-4."""
    arrays, q, v = _slot_instance(1, n=40)
    d_t = t_bcd.solve_slot(*map(_t, arrays), _t(q), v, n_servers=3,
                           solver_backend="torch:tile=128")
    j_args = tuple(map(jnp.asarray, arrays)) + (jnp.float32(q),
                                                jnp.float32(v))
    d_j = j_bcd.solve_slot(*j_args, n_servers=3,
                           solver_backend="pallas:tile=128")
    for f in ("r_idx", "m_idx", "pol"):
        np.testing.assert_array_equal(getattr(d_t, f).numpy(),
                                      np.asarray(getattr(d_j, f)), err_msg=f)
    for f in ("b", "c", "acc", "aopi"):
        np.testing.assert_allclose(getattr(d_t, f).numpy(),
                                   np.asarray(getattr(d_j, f)), rtol=5e-4,
                                   err_msg=f)


def test_wrapper_checks_reject_bad_inputs():
    x = torch.zeros(4)
    t_ops._check("x", x, torch.float32, (4,), x.device)
    with pytest.raises(TypeError, match="dtype"):
        t_ops._check("x", x.double(), torch.float32, (4,), x.device)
    with pytest.raises(ValueError, match="shape"):
        t_ops._check("x", x, torch.float32, (5,), x.device)
    with pytest.raises(ValueError, match="contiguous"):
        t_ops._check("x", torch.zeros(8)[::2], torch.float32, (4,),
                     x.device)
    with pytest.raises(ValueError, match="on"):
        t_ops._check("x", x, torch.float32, (4,), torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        t_ops.config_argmin(torch.zeros(2, device="meta"), None, None, None,
                            None, None, 0.0, 1.0, 2)


# ---------------------------------------------------------------------------
# solve_slot vs the reference (jnp and Pallas)
# ---------------------------------------------------------------------------

def _slot_instance(seed, n=12, s=3):
    rng = np.random.default_rng(seed)
    tab = j_prof.EdgeSystem(n_cameras=n, n_servers=s, n_slots=4,
                            seed=seed).horizon(1)
    sid = rng.integers(0, s, n).astype(np.int32)
    arrays = (np.asarray(tab.acc[0]), np.asarray(tab.xi),
              np.asarray(tab.size), np.asarray(tab.eff), sid,
              np.asarray(tab.budgets_b[0]), np.asarray(tab.budgets_c[0]))
    return arrays, np.float32(rng.uniform(0.0, 3.0)), \
        float(np.float32(rng.uniform(1.0, 30.0)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("backend", ["torch", "torch:nofuse"])
def test_solve_slot_matches_reference(seed, backend):
    arrays, q, v = _slot_instance(seed)
    d_t = t_bcd.solve_slot(*map(_t, arrays), _t(q), v, n_servers=3,
                           solver_backend=backend)
    j_args = tuple(map(jnp.asarray, arrays)) + (jnp.float32(q),
                                                jnp.float32(v))
    for jb in ("jnp", "pallas"):
        d_j = j_bcd.solve_slot(*j_args, n_servers=3, solver_backend=jb)
        for f in ("r_idx", "m_idx", "pol"):
            np.testing.assert_array_equal(
                getattr(d_t, f).numpy(), np.asarray(getattr(d_j, f)),
                err_msg=f"{f} vs {jb}")
        for f in ("b", "c", "lam", "mu", "acc", "aopi"):
            np.testing.assert_allclose(
                getattr(d_t, f).numpy(), np.asarray(getattr(d_j, f)),
                rtol=5e-4, err_msg=f"{f} vs {jb}")
        assert float(d_t.score) == pytest.approx(float(d_j.score), rel=1e-4)


def test_solve_slot_seed_effort_and_numpy_wrapper():
    arrays, q, v = _slot_instance(4)
    j_args = tuple(map(jnp.asarray, arrays)) + (jnp.float32(q),
                                                jnp.float32(v))
    d_j = j_bcd.solve_slot(*j_args, n_servers=3, solver_effort="seed")
    d_t = t_bcd.solve_slot(*map(_t, arrays), float(q), v, n_servers=3,
                           solver_effort="seed")
    np.testing.assert_array_equal(d_t.m_idx.numpy(), np.asarray(d_j.m_idx))
    np.testing.assert_allclose(d_t.b.numpy(), np.asarray(d_j.b), rtol=5e-4)
    tables = j_prof.SlotTables(*arrays[:4])
    dn = t_bcd.solve_slot_np(tables, arrays[4], arrays[5], arrays[6], q, v,
                             3, device="cpu")
    assert isinstance(dn.b, np.ndarray)
    np.testing.assert_allclose(
        dn.b, t_bcd.solve_slot(*map(_t, arrays), float(q), v,
                               n_servers=3).b.numpy(), rtol=0)


# ---------------------------------------------------------------------------
# Backend grammar
# ---------------------------------------------------------------------------

def test_parse_and_resolve_backend():
    assert t_bcd.parse_backend("cuda") == t_bcd.SolverSpec("cuda", None,
                                                           True)
    assert t_bcd.parse_backend("auto:nofuse").fuse is False
    assert t_bcd.parse_backend("cuda:tile=4096").tile_n == 4096
    spec = t_bcd.SolverSpec("torch", None, False)
    assert t_bcd.parse_backend(spec) is spec
    with pytest.raises(ValueError, match="unknown solver_backend knob"):
        t_bcd.parse_backend("cuda:block=4")
    with pytest.raises(ValueError, match="unknown solver_backend"):
        t_bcd.parse_backend("pallas")
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    # auto follows the tensors' device, with no fleet-size threshold.
    assert t_bcd.resolve_spec("auto", cpu, 30).backend == "torch"
    assert t_bcd.resolve_spec("auto", gpu, 30).backend == "cuda"
    assert t_bcd.resolve_spec("auto:nofuse", gpu, 30) == t_bcd.SolverSpec(
        "cuda", None, False)
    assert t_bcd.resolve_spec("torch", gpu, 30).backend == "torch"
    assert t_bcd.resolve_spec("cuda:tile=0", gpu, 30).tile_n is None
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_bcd.resolve_spec("cuda", cpu, 30)


def test_resolve_spec_tile_policy():
    """The reference's tile policy (tests/test_slot_solver.py's
    test_resolve_spec_tile_policy), with cuda in the place of pallas and
    torch in the place of jnp."""
    gpu = torch.device("cuda")
    thr = t_bcd.AUTO_TILE_MIN_CAMERAS
    assert (thr, t_bcd.DEFAULT_TILE_N) == (j_bcd.AUTO_TILE_MIN_CAMERAS,
                                           j_bcd.DEFAULT_TILE_N)
    # Auto-tiling engages from the threshold, on auto and on explicit cuda.
    assert t_bcd.resolve_spec("auto", gpu, thr).tile_n == t_bcd.DEFAULT_TILE_N
    assert t_bcd.resolve_spec("cuda", gpu, thr).tile_n == t_bcd.DEFAULT_TILE_N
    assert t_bcd.resolve_spec("cuda", gpu, thr - 1).tile_n is None
    # tile=0 pins the untiled kernels even at scale.
    assert t_bcd.resolve_spec("cuda:tile=0", gpu, 10 * thr).tile_n is None
    # A tile the whole fleet fits inside resolves to untiled.
    assert t_bcd.resolve_spec(f"cuda:tile={t_bcd.DEFAULT_TILE_N}", gpu,
                              3000).tile_n is None
    assert t_bcd.resolve_spec("cuda:tile=128", gpu, 300).tile_n == 128
    assert t_bcd.resolve_spec("auto:tile=128:nofuse", gpu, 300) == \
        t_bcd.SolverSpec("cuda", 128, False)
    # torch never tiles; a resolved spec never carries "auto".
    assert t_bcd.resolve_spec("torch:tile=4096", gpu,
                              10 * thr).tile_n is None
    assert t_bcd.resolve_spec("auto", torch.device("cpu"), 10 * thr) == \
        t_bcd.SolverSpec("torch", None, True)
    assert t_bcd.resolve_spec("auto", gpu, 10 * thr).backend == "cuda"
    # The reference resolves the same tiles for its own backends.
    for spec, n in (("auto", thr), ("auto", thr - 1), ("auto:tile=0", 10 *
                                                        thr),
                    ("auto:tile=128", 300), ("auto:tile=16384", 3000)):
        assert (t_bcd.resolve_spec(spec, gpu, n).tile_n ==
                j_bcd.resolve_spec(spec, n).tile_n), (spec, n)


def test_unported_options_raise():
    arrays, q, v = _slot_instance(5)
    args = tuple(map(_t, arrays)) + (float(q), v)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        t_bcd.solve_slot(*args, n_servers=3, solver_backend="cuda")
    # tile= is ported: on the CPU a tiled spec resolves to the plain path.
    d_tiled = t_bcd.solve_slot(*args, n_servers=3,
                               solver_backend="auto:tile=128")
    d_plain = t_bcd.solve_slot(*args, n_servers=3)
    assert torch.equal(d_tiled.b, d_plain.b)
    with pytest.raises(NotImplementedError, match="interior"):
        t_bcd.solve_slot(*args, n_servers=3, method="interior")
    with pytest.raises(NotImplementedError, match="active"):
        t_bcd.solve_slot(*args, n_servers=3, active=torch.ones(12))


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def test_build_command_targets_hopper_without_fma(tmp_path):
    cmd = _build.build_command(t_kernel.SOURCES, tmp_path / "lib.so",
                               nvcc="nvcc")
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert {"-shared", "-O3"} <= set(cmd)
    assert str(t_kernel.SOURCES[0]) in cmd
    assert _build.BUILD_DIR.name == "_build"
    assert _build.BUILD_DIR.parent.name == "repro_torch"
    src = tmp_path / "a.cu"
    src.write_text("// a")
    h1 = _build.source_hash([src])
    src.write_text("// b")
    assert _build.source_hash([src]) != h1


def test_cuda_source_has_the_three_kernels():
    """The five kernels (three from the first slice, waterfill_tiled and
    baseline_argmax since) and their C entry points, each bound in
    kernel.py, and no fast-math intrinsics."""
    src = "".join(p.read_text() for p in t_kernel.SOURCES)
    for name in ("config_argmin_kernel", "waterfill_kernel",
                 "waterfill_pair_kernel", "waterfill_tiled_kernel",
                 "baseline_argmax_kernel", "illinois_waterfill",
                 "class_sum"):
        assert f"{name}" in src
    for name in ("slot_config_argmin", "slot_waterfill",
                 "slot_waterfill_pair", "slot_waterfill_tiled",
                 "slot_baseline_argmax"):
        assert f"int {name}(" in src
        assert name in t_kernel._ARGTYPES
    assert "__expf" not in src and "__fdividef" not in src
    assert f"kMaxGroup = {t_kernel.MAX_GROUP};" in src
