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

import re  # noqa: E402

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


# Every lane count the kernels launch (kernel.scan_lanes), and 1 (one
# lane walks the whole row: the sequential scan).
LANES = [1, 2, 4, 8, 16, 32]


def _flat_config(idx, n_r):
    r, m, pol = (np.asarray(x) for x in idx)
    return m * n_r * 2 + r * 2 + pol


@pytest.mark.parametrize("q,v", [(1.3, 10.0), (50.0, 10.0)])
@pytest.mark.parametrize("n,seed", [(40, 0), (37, 1)])
def test_config_argmin_planted_ties_bitwise(n, seed, q, v):
    """On inputs with exact ties (``tied_scan_inputs``: duplicated models
    and resolutions, b = 0 rows of +inf scores, +-0 accuracies), the
    reference's jnp scan and its Pallas kernel (interpret mode), the
    port's plain version and its lane twins at every L pick the same
    indices bitwise: the tied values are the same floats, so no near-tie
    allowance."""
    inputs = t_ref.tied_scan_inputs(n, seed)
    q = np.float32(q)
    port = t_ref.config_argmin_ref(*map(_t, inputs), _t(q), v, n)
    # The ties decide: at least a third of the cameras' winning scores
    # are shared with another entry (every entry, where b = 0).
    scores = _score_table(*inputs, q, v, n)
    win = scores[np.arange(n), _flat_config(port, 6)]
    tied = (scores == win[:, None]).sum(axis=1)
    assert (tied > 1).sum() >= n // 3, tied
    assert (tied[3::4] == scores.shape[1]).all()
    j_in = tuple(map(jnp.asarray, inputs))
    others = {
        "jnp ref": j_ss.config_argmin_ref(*j_in, jnp.float32(q), v, n),
        "pallas": j_ss.config_argmin(*j_in, jnp.float32(q), v, n,
                                     backend="pallas", block_n=16)}
    for lanes in LANES:
        others[f"lanes={lanes}"] = t_ref.config_argmin_lanes_ref(
            *map(_t, inputs), _t(q), v, n, lanes=lanes)
    for label, other in others.items():
        for name, a, o in zip(("r", "m", "pol"), port, other):
            np.testing.assert_array_equal(a.numpy(), np.asarray(o),
                                          err_msg=f"{label} {name}")


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("kind,n,seed", [("random", 64, 2),
                                         ("paper", 1000, 2)])
def test_config_argmin_lanes_ref_equals_plain(kind, n, seed, lanes):
    """The kernel's order (lanes, then a butterfly) picks the plain
    version's indices bitwise on the existing inputs."""
    inputs = (_config_inputs(n, seed=seed) if kind == "random"
              else _paper_config_inputs(n, seed))
    args = (*map(_t, inputs), _t(np.float32(1.3)), 10.0, n)
    for a, b in zip(t_ref.config_argmin_lanes_ref(*args, lanes=lanes),
                    t_ref.config_argmin_ref(*args)):
        assert torch.equal(a, b)


def test_config_argmin_lanes_ref_rejects_bad_lanes():
    args = (*map(_t, _config_inputs(4)), _t(np.float32(1.3)), 10.0, 4)
    for lanes in (0, 3, 64):
        with pytest.raises(ValueError, match="power of two"):
            t_ref.config_argmin_lanes_ref(*args, lanes=lanes)


@pytest.mark.parametrize("n_sms", [132, 114, 1])
def test_scan_lanes_from_the_size_alone(n_sms):
    """A power of two within the bounds, falling as the fleet grows, and
    the fewest lanes whose n * L covers SCAN_LANES_PER_SM of every SM."""
    sizes = [1, 30, 1000, 2000, 5000, 10_000, 20_000, 100_000, 10 ** 6]
    lanes = [t_kernel.scan_lanes(n, n_sms) for n in sizes]
    assert lanes == sorted(lanes, reverse=True)
    target = t_kernel.SCAN_LANES_PER_SM * n_sms
    for n, l in zip(sizes, lanes):
        assert t_kernel.SCAN_MIN_LANES <= l <= t_kernel.SCAN_MAX_LANES
        assert l & (l - 1) == 0
        assert n * l >= target or l == t_kernel.SCAN_MAX_LANES
        assert n * (l // 2) < target or l == t_kernel.SCAN_MIN_LANES
    if n_sms == 132:       # the main paths' sizes on an H100
        assert lanes[:8] == [32, 32, 32, 32, 16, 8, 4, 2]


def _nan_config_inputs():
    """One camera, M = R = 2, whose model-1 entries are unstable under
    FCFS (lam >= mu: AoPI +inf), so V = 0 makes their FCFS scores 0 * inf
    = NaN; the pair keeps FCFS (NaN < x is false), so flats 4 and 6 are
    NaN. The least finite pair value is flat 2."""
    b, c, eff = (np.full(2, x, np.float32) for x in (1e7, 1e12, 5.0))
    size = np.float32([1e4, 1e6])
    xi = np.float32([[1e8, 1e8], [1e11, 1e11]])
    acc = np.float32([[[0.5, 0.6], [0.9, 0.8]], [[0.5, 0.6], [0.7, 0.8]]])
    return b, c, acc, xi, size, eff


def test_config_argmin_nan_scores_split_the_sides():
    """A known disagreement (ROADMAP.md section 3), pinned: on a NaN score
    torch.argmin and jnp.argmin pick the first NaN (flat 4), while the
    Pallas kernel's fold and the CUDA kernels' total order (the lane
    twins) never pick a NaN (flat 2). No path calls config_argmin with
    V = 0; NaN scores are outside the kernels' contract."""
    inputs = _nan_config_inputs()
    q = np.float32(1.3)
    scores = _score_table(*inputs, q, 0.0, 2)
    assert np.isnan(scores[:, [4, 6]]).all()
    assert not np.isnan(scores[:, [0, 1, 2, 3, 5, 7]]).any()
    port = t_ref.config_argmin_ref(*map(_t, inputs), _t(q), 0.0, 2)
    j_in = tuple(map(jnp.asarray, inputs))
    want = {"port": (port, 4),
            "jnp ref": (j_ss.config_argmin_ref(*j_in, jnp.float32(q), 0.0,
                                               2), 4),
            "pallas": (j_ss.config_argmin(*j_in, jnp.float32(q), 0.0, 2,
                                          backend="pallas", block_n=16), 2)}
    for lanes in LANES:
        want[f"lanes={lanes}"] = (t_ref.config_argmin_lanes_ref(
            *map(_t, inputs), _t(q), 0.0, 2, lanes=lanes), 2)
    for label, (idx, flat) in want.items():
        assert (_flat_config(idx, 2) == flat).all(), label


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
    (100_000, 1, 16384, 128),    # MIN's virtual server at auto's tile
    (10_000, 32, 256, 2),        # LBCD with tile=256: ~312 per server
    (100_000, 32, 128, 4),       # one wave: 32 x 4 CTAs <= 132 SMs
    (300, 5, 128, 1),            # tiled, but a mean segment fits one CTA
    (1001, 7, 128, 1),
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


# ---------------------------------------------------------------------------
# The water-fill team's fill sum (csrc Team::sum), step by step
# ---------------------------------------------------------------------------

def _shfl_down(v, h):
    """__shfl_down_sync over one warp: lane l reads lane l + h, or keeps
    its own value where l + h is past the warp."""
    return np.concatenate([v[h:], v[32 - h:]])


def _team_sum(x, group, threads, slots=t_kernel.SLOTS):
    """The kernels' fill sum over a segment ``x`` as the team takes it:
    thread t of CTA g owns class c = g + G t, positions c + Q i (Q = G T);
    (1) each thread folds its class by the halving tree of width w = P/Q
    (P = 2^k >= count), positions past ``slots`` through its scratch row
    first, the rest in registers; (2) each CTA folds its T class sums, the
    levels h >= 32 from one shared stage (lane l folds t = l + 32 k over
    k), the levels below by shuffles; (3) every warp folds the G CTA
    partials, lane l reading CTA l + 32 k, then by shuffles. Each level is
    one float32 addition per pair, as in the kernel."""
    x = np.asarray(x, np.float32)
    count, q = x.size, group * threads
    p = 1
    while p < count:
        p *= 2
    w = p // q if p > q else 1
    cls = np.arange(q)
    pos = cls[None, :] + q * np.arange(max(w, slots))[:, None]
    live = pos < count
    vals = np.where(live, x[np.minimum(pos, max(count - 1, 0))]
                    if count else 0, np.float32(0)).astype(np.float32)
    # (1) the class trees: positions past the register slots fold through
    # the scratch row (tmp) first, adding into the slots at each level.
    reg, tmp = vals[:slots].copy(), vals.copy()
    h = w // 2
    while h >= slots:
        src = vals if h == w // 2 else tmp
        reg = reg + src[h:h + slots]
        tmp[slots:h] = src[slots:h] + src[slots + h:2 * h]
        h //= 2
    h = slots // 2
    while h >= 1:
        if h < w:
            reg[:h] = reg[:h] + reg[h:2 * h]
        h //= 2
    cls_sum = reg[0].reshape(threads, group)      # [t, g]: class g + G t
    # (2) the CTA trees, one per g.
    parts = []
    for g in range(group):
        s = cls_sum[:, g]
        if threads > 32:
            u = s.reshape(threads // 32, 32)       # u[k, lane] = t = l + 32k
            k = threads // 64
            while k >= 1:
                u[:k] = u[:k] + u[k:2 * k]
                k //= 2
            s = u[0]
        for hh in (16, 8, 4, 2, 1):
            s = s + _shfl_down(s, hh)
        parts.append(s[0])
    # (3) the width-G tree, as one warp takes it.
    if group == 1:
        return parts[0]
    ng = group // 32 if group > 32 else 1
    lanes = np.arange(32)
    u = np.stack([np.where(lanes + 32 * k < group,
                           np.asarray(parts + [np.float32(0)] * 128,
                                      np.float32)[lanes + 32 * k],
                           np.float32(0)) for k in range(ng)])
    k = ng // 2
    while k >= 1:
        u[:k] = u[:k] + u[k:2 * k]
        k //= 2
    s = u[0]
    for hh in (16, 8, 4, 2, 1):
        if hh < group:
            s = s + _shfl_down(s, hh)
    return s[0]


TEAMS = [(1, 256), (4, 256), (16, 512), (128, 256)]
TEAM_COUNTS = [0, 1, 2, 3, 7, 63, 64, 65, 1001, 4097, 10_000, 100_000]


def _assert_team_sum_bitwise(count, group, threads, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random(count) * 10.0 ** rng.integers(-3, 3, count)).astype(
        np.float32)
    want = t_alloc.tree_segment_sum(
        _t(x), t_alloc.segment_tree(_t(np.zeros(count, np.int32)), 1))[0]
    got = _team_sum(x, group, threads)
    assert np.float32(want.item()) == got, (count, group, threads, seed)
    if count <= 4097:        # the list-based model is slow beyond that
        assert got == _kernel_segment_sum(x)
    # The residue identity the team rests on: group G * T.
    if count <= 10_000:
        assert got == _residue_class_sum(x, group * threads)


@pytest.mark.parametrize("group,threads", TEAMS)
@pytest.mark.parametrize("count", TEAM_COUNTS)
def test_team_sum_equals_tree_sum(count, group, threads):
    """The team's fill sum (class trees in registers and scratch, the CTA
    tree by one shared stage and shuffles, the width-G tree) is bitwise
    the plain version's tree sum, at every (G, T) and count."""
    _assert_team_sum_bitwise(count, group, threads,
                             seed=count * 11 + group + threads)


def test_team_sum_spills_past_the_register_slots():
    """Segments larger than G * T * SLOTS fold their extra positions
    through the scratch row first; the sum stays bitwise."""
    for count, group, threads in ((300, 1, 32), (4097, 2, 64),
                                  (100_000, 4, 256)):
        assert count > group * threads * t_kernel.SLOTS
        _assert_team_sum_bitwise(count, group, threads, seed=count)


def test_team_sum_equals_tree_sum_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=60, deadline=None, database=None)
    @given(st.integers(0, 5000), st.sampled_from(TEAMS + [(2, 32), (8, 64)]),
           st.integers(0, 2**31 - 1))
    def inner(count, team, seed):
        _assert_team_sum_bitwise(count, *team, seed)
    inner()


@pytest.mark.parametrize("n_sms", [132, 114])
def test_fill_plan_from_sizes_alone(n_sms):
    """The host rule: powers of two, S * G within the SMs, G = 1 where a
    mean segment fits one CTA (the paper setting), a thread a camera up to
    one wave of the card (128 CTAs at N=100,000, S=1); the same plan for
    the same sizes."""
    for n, s in ((30, 3), (1, 1), (300, 5), (1001, 7), (10_000, 32),
                 (100_000, 32), (10_000, 1), (100_000, 1), (3000, 200),
                 (100_000, 7)):
        plan = t_ops.fill_plan(n, s, n_sms)
        assert plan == t_ops.fill_plan(n, s, n_sms)
        g, th = plan.group, plan.threads
        assert g & (g - 1) == 0 and th & (th - 1) == 0
        assert 32 <= th <= t_kernel.MAX_THREADS
        assert g == 1 or s * g <= n_sms
        assert plan.sync == ("none" if g == 1 else "cluster"
                             if g <= t_ops.CLUSTER_UP_TO else "grid")
        mean = -(-n // s)
        if mean <= t_kernel.MAX_THREADS:
            assert g == 1 and th >= mean
        elif g * t_kernel.MAX_THREADS < mean:
            assert 2 * s * g > n_sms          # as wide as one wave allows
        else:                                 # no wider than one a thread
            assert g == 1 or (g // 2) * t_kernel.MAX_THREADS < mean
    assert t_ops.fill_plan(30, 3, n_sms) == t_ops.FillPlan(1, 32, "none")
    assert t_ops.fill_plan(100_000, 1, n_sms).group == (
        128 if n_sms >= 128 else 64)
    assert t_ops.fill_plan(10_000, 1, n_sms) == t_ops.FillPlan(64, 256,
                                                               "grid")
    assert t_ops.fill_plan(10_000, 32, n_sms).group == 2
    # At the main path's shapes on an H100 SXM every camera has a register
    # slot (on fewer SMs the largest segments spill: slower, as exact).
    for n, s in ((100_000, 1), (10_000, 1), (10_000, 32), (100_000, 32)):
        plan = t_ops.fill_plan(n, s, n_sms)
        fits = plan.group * plan.threads * t_kernel.SLOTS >= n / s
        assert fits or n_sms < t_ops.H100_SMS
    # Pins: group beyond 8 is allowed, bad values raise.
    assert t_ops.fill_plan(30, 3, n_sms, group=16).sync == "cluster"
    assert t_ops.fill_plan(30, 3, n_sms, group=32).sync == "grid"
    assert t_ops.fill_plan(30, 3, n_sms, group=16,
                           sync="grid").sync == "grid"
    for kw in (dict(group=3), dict(group=256), dict(threads=48),
               dict(threads=512), dict(group=32, sync="cluster"),
               dict(group=1, sync="grid"), dict(group=2, sync="none")):
        with pytest.raises(ValueError):
            t_ops.fill_plan(100, 1, n_sms, **kw)


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
    # The interior method is ported (tests/test_torch_interior.py) on the
    # plain path only: "cuda" with it is refused, "auto" resolves to
    # "torch" for it on every device, and it takes no churn mask.
    with pytest.raises(ValueError, match="method='interior'"):
        t_bcd.solve_slot(*args, n_servers=3, method="interior",
                         solver_backend="cuda")
    assert t_bcd.resolve_spec("auto", torch.device("cuda"), 12,
                              method="interior").backend == "torch"
    with pytest.raises(ValueError, match="fleet-churn mask"):
        t_bcd.solve_slot(*args, n_servers=3, method="interior",
                         active=torch.ones(12))
    # The churn mask is ported (tests/test_torch_scenarios.py); no kernel
    # takes it, so an explicit "cuda" with a mask is refused.
    with pytest.raises(ValueError, match="mask"):
        t_bcd.solve_slot(*args, n_servers=3, active=torch.ones(12),
                         solver_backend="cuda")


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

# A cuobjdump -sass excerpt in the two branch-target spellings: an entry
# loop (0x0100-0x01c0) with a division whose slow-path call its branch
# skips, a loop that stores (a prologue's) and one without a MUFU.
SASS = """
\t\tFunction : _ZN4anon20config_argmin_kernelILi8EEvPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.RCP R2, R3 ;
        /*0020*/                   STS [R4], R2 ;
        /*0030*/              @!P0 BRA 0x10 ;
        /*0100*/                   LDS R5, [R6] ;
        /*0110*/                   MUFU.RCP R7, R5 ;
        /*0120*/                   FCHK P1, R8, R5 ;
        /*0130*/              @!P1 BRA 0x160 ;
        /*0140*/                   MOV R9, 0x160 ;
        /*0150*/                   CALL.REL.NOINC 0x300 ;
        /*0160*/                   BSYNC B3 ;
        /*0170*/                   FADD R10, R7, R7 ;
        /*0180*/              @!P2 BRA 0x100 ;
.L_x_1:
        /*0190*/                   IADD3 R11, R11, 0x1, RZ ;
        /*01a0*/              @!P3 BRA `(.L_x_1) ;
        /*01b0*/                   EXIT ;
\t\tFunction : _ZN4anon22baseline_argmax_kernelILi2EEvPKf
        /*0000*/                   EXIT ;
"""


def test_sass_entry_loops_count_the_fast_path():
    """chip_smoke's issue floor reads the scans' entry loops from the SASS:
    the loop holding a MUFU and no store, its slow-path call left out."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    assert chip_smoke.sass_loops(SASS, "config_argmin_kernelILi8E") == [
        dict(instructions=7, mufu=1, static=9)]
    assert chip_smoke.sass_loops(SASS, "config_argmin_kernelILi4E") == []
    assert chip_smoke.sass_loops(SASS, "baseline_argmax_kernelILi2E") == []


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
    # One entry an iteration: the issue floor reads the loops' SASS so.
    assert src.count("#pragma unroll 1\n") == 2
    assert f"kMaxGroup = {t_kernel.MAX_GROUP};" in src
    assert f"kMaxCluster = {t_kernel.MAX_CLUSTER};" in src
    assert f"kFillThreads = {t_kernel.MAX_THREADS};" in src
    assert f"kSlots = {t_kernel.SLOTS};" in src
    for name, value in t_kernel.SYNC.items():
        assert f"kSync{name.capitalize()} = {value};" in src
    assert f"kConfigThreads = {t_kernel.CONFIG_THREADS};" in src
    assert f"kBaselineThreads = {t_kernel.BASELINE_THREADS};" in src
    for name in ("MinLanes", "MaxLanes", "LanesPerSm"):
        value = getattr(t_kernel, "SCAN_" + re.sub(r"(?<!^)([A-Z])", r"_\1",
                                                   name).upper())
        assert f"kScan{name} = {value};" in src
    assert "int slot_scan_lanes(" in src
