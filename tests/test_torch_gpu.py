"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one. The file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.core import (allocate, baselines, bcd, energy, lbcd,
                               profiles, queues, threefry)
from repro_torch.kernels.dataplane import ops as dp_ops
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mlstm import kernel as ml_kernel
from repro_torch.kernels.mlstm import ops as ml_ops
from repro_torch.kernels.mlstm import ref as ml_ref
from repro_torch.kernels.selective_scan import kernel as ss_kernel
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan import ref as ss_ref
from repro_torch.kernels.slot_solver import ops, ref
from repro_torch.launch import serve
from repro_torch.serving import (AnalyticsService, Engine, Frame,
                                 engine_plane, tick_plane)
from repro_torch.training import failure

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _paper_config_inputs(n, s, seed, dev):
    """Paper pool (M=9, R=6) at the per-camera budget share of 30 cameras
    on 3 servers."""
    tab = profiles.EdgeSystem(n_cameras=n, n_servers=s, n_slots=2,
                              seed=seed).horizon(1, device=dev)
    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.uniform(0.3, 3.0, n) * 3e6, dtype=torch.float32)
    c = torch.as_tensor(rng.uniform(0.3, 3.0, n) * 5e12, dtype=torch.float32)
    return (b.to(dev), c.to(dev), tab.acc[0].contiguous(), tab.xi, tab.size,
            tab.eff)


def _fill_setup(dev, n, s, seed=0, lcfsp_frac=0.5, budget_lo=2e7,
                budget_hi=5e7, server_id=None):
    rng = np.random.default_rng(seed)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    sid = (rng.integers(0, s, n) if server_id is None else server_id)
    return dict(
        k=f32(rng.uniform(1e-6, 5e-6, n)), p=f32(rng.uniform(0.3, 0.95, n)),
        pol=torch.as_tensor((rng.random(n) < lcfsp_frac).astype(np.int32),
                            device=dev),
        mu=f32(rng.uniform(5.0, 40.0, n)),
        inv_xi=f32(rng.uniform(1e-12, 5e-12, n)),
        sid=torch.as_tensor(np.asarray(sid, np.int32), device=dev),
        bb=f32(rng.uniform(budget_lo, budget_hi, s)),
        bc=f32(rng.uniform(3e13, 8e13, s)), s=s)


FILL_CASES = {
    "mixed": dict(n=12, s=3, seed=7),
    "slack_budget": dict(n=8, s=2, seed=11, lcfsp_frac=0.0, budget_lo=5e9,
                         budget_hi=9e9),
    "single_camera_servers": dict(n=6, s=6, seed=3,
                                  server_id=np.arange(6)),
    "empty_server": dict(n=9, s=3, seed=4,
                         server_id=np.array([0, 0, 0, 2, 2, 0, 2, 0, 2])),
    "ragged": dict(n=1001, s=7, seed=5),
    "main_path": dict(n=10_000, s=32, seed=6, budget_lo=2e9, budget_hi=5e9),
}


# Cameras at which the scans launch each lane count on an H100
# (kernel.scan_lanes: 32 up to 2,000, 16, 8, 4, 2), ragged ones included.
SCAN_SIZES = [1, 30, 37, 1001, 5_000, 10_000, 20_001, 100_000]


@pytest.mark.parametrize("n", SCAN_SIZES)
def test_gpu_config_argmin_bitwise(cuda, n):
    args = _paper_config_inputs(n, 3, 0, cuda)
    q = torch.tensor(1.3, device=cuda)
    ops.reset_launches()
    out = ops.config_argmin(*args, q, 10.0, n)
    plain = ref.config_argmin_ref(*args, q, 10.0, n)
    torch.cuda.synchronize()
    assert ops.launches["config_argmin"] == 1
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


def test_gpu_scan_lanes_follow_the_host_rule(cuda):
    """The library picks the lanes kernel.scan_lanes gives for the card's
    SM count, for both scans."""
    from repro_torch.kernels.slot_solver import kernel
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n in SCAN_SIZES + [2_000, 2_200, 10 ** 6]:
        assert kernel.launched_lanes(n) == kernel.scan_lanes(n, sms), n


def _tied(n, seed, dev):
    return tuple(torch.as_tensor(x, device=dev)
                 for x in ref.tied_scan_inputs(n, seed))


@pytest.mark.parametrize("q,v", [(1.3, 10.0), (50.0, 10.0)])
@pytest.mark.parametrize("n,seed", [(40, 0), (37, 1)])
def test_gpu_config_argmin_planted_ties(cuda, n, seed, q, v):
    """Index-bitwise on exact ties (duplicated models and resolutions,
    b = 0 rows of +inf scores): the first flat index wins, as in the
    plain version's torch.argmin."""
    args = _tied(n, seed, cuda)
    q = torch.tensor(q, device=cuda)
    out = ops.config_argmin(*args, q, v, n)
    plain = ref.config_argmin_ref(*args, q, v, n)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


def test_gpu_config_argmin_nan_follows_the_lane_twin(cuda):
    """NaN scores (V = 0 times an unstable FCFS AoPI) are outside the
    kernels' contract: the kernel's total order never picks a NaN, as its
    lane twin does not, while torch.argmin does (ROADMAP.md section 3)."""
    b, c, eff = (torch.full((2,), x, device=cuda) for x in (1e7, 1e12, 5.0))
    size = torch.tensor([1e4, 1e6], device=cuda)
    xi = torch.tensor([[1e8, 1e8], [1e11, 1e11]], device=cuda)
    acc = torch.tensor([[[0.5, 0.6], [0.9, 0.8]], [[0.5, 0.6], [0.7, 0.8]]],
                       device=cuda)
    q = torch.tensor(1.3, device=cuda)
    args = (b, c, acc, xi, size, eff, q, 0.0, 2)
    out = ops.config_argmin(*args)
    twin = ref.config_argmin_lanes_ref(*args, lanes=8)
    plain = ref.config_argmin_ref(*args)
    torch.cuda.synchronize()
    flat = [int(m[0]) * 4 + int(r[0]) * 2 + int(p[0])
            for r, m, p in (out, twin, plain)]
    assert flat == [2, 2, 4]


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_gpu_waterfills_match_plain(cuda, case):
    t = _fill_setup(cuda, **FILL_CASES[case])
    s = t["s"]
    args_b = (t["k"], t["p"], t["pol"], t["mu"], t["sid"], t["bb"], s)
    ops.reset_launches()
    b_k = ops.waterfill_bandwidth(*args_b)
    b_p = allocate.waterfill_bandwidth(*args_b)
    args_c = (t["inv_xi"], t["p"], t["pol"], b_p * t["k"], t["sid"],
              t["bc"], s)
    c_k = ops.waterfill_compute(*args_c)
    c_p = allocate.waterfill_compute(*args_c)
    args_pair = (t["k"], t["p"], t["pol"], t["mu"], t["inv_xi"], t["sid"],
                 t["bb"], t["bc"], s)
    pb_k, pc_k = ops.waterfill_pair(*args_pair)
    pb_p, pc_p = allocate.waterfill_pair(*args_pair)
    torch.cuda.synchronize()
    assert ops.launches == {"config_argmin": 0, "waterfill": 2,
                            "waterfill_pair": 1, "waterfill_tiled": 0,
                            "baseline_argmax": 0}
    # The kernels add their fill sums in the plain version's tree order and
    # round every operation alike (-fmad=false), so they agree bitwise;
    # the bar the reference holds Pallas to is rtol=2e-4.
    for got, want in ((b_k, b_p), (c_k, c_p), (pb_k, pb_p), (pc_k, pc_p)):
        assert torch.equal(got, want)


def test_gpu_wrappers_refuse_bad_inputs(cuda):
    t = _fill_setup(cuda, n=12, s=3)
    with pytest.raises(TypeError, match="dtype"):
        ops.waterfill_bandwidth(t["k"].double(), t["p"], t["pol"], t["mu"],
                                t["sid"], t["bb"], 3)
    with pytest.raises(ValueError, match="on cpu"):
        ops.waterfill_bandwidth(t["k"], t["p"].cpu(), t["pol"], t["mu"],
                                t["sid"], t["bb"], 3)
    with pytest.raises(ValueError, match="contiguous"):
        k2 = torch.stack([t["k"], t["k"]], 1)[:, 0]
        ops.waterfill_bandwidth(k2, t["p"], t["pol"], t["mu"], t["sid"],
                                t["bb"], 3)


def test_gpu_solve_slot_cuda_matches_torch(cuda):
    tab = profiles.EdgeSystem(n_cameras=300, n_servers=8, n_slots=2,
                              seed=1).horizon(1, device=cuda)
    sid = torch.as_tensor(np.random.default_rng(1).integers(0, 8, 300)
                          .astype(np.int32), device=cuda)
    args = (tab.acc[0], tab.xi, tab.size, tab.eff, sid, tab.budgets_b[0],
            tab.budgets_c[0], torch.tensor(0.5, device=cuda), 10.0)
    d_p = bcd.solve_slot(*args, n_servers=8, solver_backend="torch")
    for spec in ("cuda", "cuda:nofuse"):
        d_k = bcd.solve_slot(*args, n_servers=8, solver_backend=spec)
        for f in ("r_idx", "m_idx", "pol", "b", "c", "aopi"):
            assert torch.equal(getattr(d_k, f), getattr(d_p, f)), (spec, f)


def test_gpu_rollout_cuda_matches_torch(cuda):
    tab = profiles.EdgeSystem(n_cameras=300, n_servers=8, n_slots=4,
                              mean_bandwidth_hz=30e6 * 10,
                              mean_compute_flops=50e12 * 10).horizon(4)
    ops.reset_launches()
    r_k = lbcd.rollout(tab, 10.0, 0.7)
    assert ops.launches["config_argmin"] > 0
    assert ops.launches["waterfill_pair"] > 0
    r_p = lbcd.rollout(tab, 10.0, 0.7, solver_backend="torch")
    assert torch.equal(r_k.assign, r_p.assign)
    assert torch.equal(r_k.aopi, r_p.aopi)
    assert torch.equal(r_k.q, r_p.q)


BASELINE_SCANS = [("dos", 1.0), ("dos", 0.3), ("jcab", 0.5), ("jcab", 1e-6)]


@pytest.mark.parametrize("mode,threshold", BASELINE_SCANS)
@pytest.mark.parametrize("n", [29] + SCAN_SIZES)
def test_gpu_baseline_argmax_bitwise(cuda, n, mode, threshold):
    """Index-bitwise against the plain version, including JCAB's
    all-infeasible fallback (cap 1e-6)."""
    args = _paper_config_inputs(n, 3, 1, cuda)
    ops.reset_launches()
    out = ops.baseline_argmax(*args, mode=mode, threshold=threshold)
    plain = ref.baseline_argmax_ref(*args, mode=mode, threshold=threshold)
    torch.cuda.synchronize()
    assert ops.launches["baseline_argmax"] == 1
    for a, b in zip(out, plain):
        assert a.dtype == torch.int32
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,threshold",
                         [("dos", 0.0), ("dos", 1.0), ("jcab", 1e-6),
                          ("jcab", "pair"), ("jcab", 0.5)])
@pytest.mark.parametrize("n,seed", [(40, 0), (37, 1)])
def test_gpu_baseline_argmax_planted_ties(cuda, n, seed, mode, threshold):
    """Index-bitwise on exact ties: DOS at weight 0 (duplicated maxima,
    +-0), b = 0 rows, JCAB's fallback and a cap that only the tied
    least-latency pair meets."""
    inputs = ref.tied_scan_inputs(n, seed)
    if threshold == "pair":
        threshold = ref.tied_jcab_cap(*(inputs[k] for k in (0, 1, 3, 4, 5)))
    args = _tied(n, seed, cuda)
    out = ops.baseline_argmax(*args, mode=mode, threshold=threshold)
    plain = ref.baseline_argmax_ref(*args, mode=mode, threshold=threshold)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


# (G, how the G CTAs of a server meet): every barrier kind built at G.
TEAMS = [(1, "none"), (2, "cluster"), (2, "grid"), (8, "cluster"),
         (8, "grid"), (16, "cluster"), (16, "grid"), (128, "grid")]


@pytest.mark.parametrize("group,sync", TEAMS)
@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_gpu_waterfill_tiled_matches_plain(cuda, case, group, sync):
    """The tiled kernel adds its fill sums by residue class in the plain
    version's tree order, so it agrees bitwise, whatever the team: empty
    servers, CTAs with no camera and segments shorter than G * T
    included."""
    t = _fill_setup(cuda, **FILL_CASES[case])
    s = t["s"]
    args_b = (t["k"], t["p"], t["pol"], t["mu"], t["sid"], t["bb"], s)
    ops.reset_launches()
    b_k = ops.waterfill_bandwidth(*args_b, group=group, sync=sync)
    b_p = allocate.waterfill_bandwidth(*args_b)
    args_c = (t["inv_xi"], t["p"], t["pol"], b_p * t["k"], t["sid"],
              t["bc"], s)
    c_k = ops.waterfill_compute(*args_c, group=group, sync=sync)
    c_p = allocate.waterfill_compute(*args_c)
    torch.cuda.synchronize()
    assert ops.launches["waterfill_tiled"] == 2
    assert torch.equal(b_k, b_p)
    assert torch.equal(c_k, c_p)


@pytest.mark.parametrize("group,sync", TEAMS)
@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_gpu_waterfill_pair_teams_match_plain(cuda, case, group, sync):
    """waterfill_pair on G CTAs a server: still one launch, bitwise."""
    t = _fill_setup(cuda, **FILL_CASES[case])
    args = (t["k"], t["p"], t["pol"], t["mu"], t["inv_xi"], t["sid"],
            t["bb"], t["bc"], t["s"])
    ops.reset_launches()
    b_k, c_k = ops.waterfill_pair(*args, group=group, sync=sync)
    b_p, c_p = allocate.waterfill_pair(*args)
    torch.cuda.synchronize()
    assert ops.launches == {"config_argmin": 0, "waterfill": 0,
                            "waterfill_pair": 1, "waterfill_tiled": 0,
                            "baseline_argmax": 0}
    assert torch.equal(b_k, b_p)
    assert torch.equal(c_k, c_p)


@pytest.mark.parametrize("n,s,pins", [
    (100_000, 1, {}),                    # MIN's virtual server: G = 128
    (10_000, 1, {}),                     # LBCD's virtual server
    (10_000, 32, {}),                    # LBCD's servers: G = 4
    (10_000, 32, dict(group=16, sync="cluster")),
    (10_000, 1, dict(group=2, threads=64)),      # 78 cameras a thread:
    (3_000, 200, {}),                            # spilled past the slots
])
def test_gpu_waterfills_at_scale_match_plain(cuda, n, s, pins):
    """The main path's shapes at the host rule's plan (and pinned ones),
    tiled and pair kernels, bitwise; the counters count one launch per
    call."""
    t = _fill_setup(cuda, n, s, seed=n + s, budget_lo=2e7 * n / s / 4,
                    budget_hi=5e7 * n / s / 4)
    plan = ops.fill_plan(n, s, torch.cuda.get_device_properties(
        cuda).multi_processor_count, **pins)
    args_b = (t["k"], t["p"], t["pol"], t["mu"], t["sid"], t["bb"], s)
    args_pair = (t["k"], t["p"], t["pol"], t["mu"], t["inv_xi"], t["sid"],
                 t["bb"], t["bc"], s)
    ops.reset_launches()
    b_k = ops.waterfill_bandwidth(*args_b, group=plan.group,
                                  threads=plan.threads, sync=plan.sync)
    pb_k, pc_k = ops.waterfill_pair(*args_pair, **pins)
    torch.cuda.synchronize()
    assert ops.launches["waterfill_tiled"] == 1
    assert ops.launches["waterfill_pair"] == 1
    assert torch.equal(b_k, allocate.waterfill_bandwidth(*args_b))
    pb_p, pc_p = allocate.waterfill_pair(*args_pair)
    assert torch.equal(pb_k, pb_p)
    assert torch.equal(pc_k, pc_p)


def test_gpu_tile_n_selects_the_tiled_kernel(cuda):
    t = _fill_setup(cuda, **FILL_CASES["ragged"])
    args_b = (t["k"], t["p"], t["pol"], t["mu"], t["sid"], t["bb"], 7)
    ops.reset_launches()
    tiled = ops.waterfill_bandwidth(*args_b, tile_n=128)
    assert ops.launches["waterfill_tiled"] == 1
    untiled = ops.waterfill_bandwidth(*args_b, tile_n=4096)
    assert ops.launches["waterfill"] == 1
    assert torch.equal(tiled, untiled)


def test_gpu_new_wrappers_refuse_bad_inputs(cuda):
    args = list(_paper_config_inputs(29, 3, 0, cuda))
    with pytest.raises(TypeError, match="dtype"):
        ops.baseline_argmax(*args[:2], args[2].double(), *args[3:],
                            mode="dos", threshold=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.baseline_argmax(*args[:2], args[2].transpose(1, 2).contiguous()
                            .transpose(1, 2), *args[3:], mode="dos",
                            threshold=1.0)
    with pytest.raises(ValueError, match="on cpu"):
        ops.baseline_argmax(args[0], args[1].cpu(), *args[2:], mode="jcab",
                            threshold=0.5)
    t = _fill_setup(cuda, n=12, s=3)
    args_b = (t["k"], t["p"], t["pol"], t["mu"], t["sid"], t["bb"], 3)
    for group in (0, 3, 256):
        with pytest.raises(ValueError, match="power of two"):
            ops.waterfill_bandwidth(*args_b, group=group)
    with pytest.raises(ValueError, match="does not fit"):
        ops.waterfill_pair(t["k"], t["p"], t["pol"], t["mu"], t["inv_xi"],
                           t["sid"], t["bb"], t["bc"], 3, group=32,
                           sync="cluster")
    with pytest.raises(TypeError, match="dtype"):
        ops.waterfill_bandwidth(t["k"], t["p"], t["pol"].float(),
                                *args_b[3:], group=2)


def test_gpu_baseline_rollouts_cuda_match_torch(cuda):
    """DOS and JCAB through baseline_argmax, MIN through the tiled
    water-fill (tile=128 on the 300-camera virtual server): identical to
    the plain rollouts on the card."""
    tab = profiles.EdgeSystem(n_cameras=300, n_servers=8, n_slots=3,
                              mean_bandwidth_hz=30e6 * 10,
                              mean_compute_flops=50e12 * 10).horizon(3)
    runs = {"dos": (baselines.rollout_dos, {}),
            "jcab": (baselines.rollout_jcab, {}),
            "min": (baselines.rollout_min, {"v": 10.0})}
    for name, (fn, kw) in runs.items():
        ops.reset_launches()
        spec = "auto:tile=128" if name == "min" else "auto"
        r_k = fn(tab, solver_backend=spec, **kw)
        kernel = "waterfill_tiled" if name == "min" else "baseline_argmax"
        assert ops.launches[kernel] > 0, name
        r_p = fn(tab, solver_backend="torch", **kw)
        for f in ("m_idx", "r_idx", "pol", "b", "c"):
            assert torch.equal(getattr(r_k.decision, f),
                               getattr(r_p.decision, f)), (name, f)
        assert torch.equal(r_k.assign, r_p.assign), name
        assert torch.equal(r_k.aopi, r_p.aopi), name


def test_gpu_controller_step_runs_on_the_card(cuda):
    """A controller's ``step`` rolls a one-slot horizon on its device:
    DOS and JCAB launch baseline_argmax there, and equal the plain step."""
    kw = dict(n_cameras=300, n_servers=8, n_slots=3,
              mean_bandwidth_hz=30e6 * 10, mean_compute_flops=50e12 * 10)
    for name in ("DOS", "JCAB"):
        ops.reset_launches()
        rec_k = baselines.make(name, profiles.EdgeSystem(**kw)).step(1)
        assert ops.launches["baseline_argmax"] > 0, name
        rec_p = baselines.make(name, profiles.EdgeSystem(**kw),
                               solver_backend="torch").step(1)
        assert rec_k.t == 1
        np.testing.assert_array_equal(rec_k.assign, rec_p.assign)
        np.testing.assert_array_equal(rec_k.aopi, rec_p.aopi)


def test_gpu_energy_rollout_cuda_matches_torch(cuda):
    tab = profiles.EdgeSystem(n_cameras=30, n_servers=3, n_slots=3,
                              seed=0).horizon(3)
    args = (10.0, 0.7, 2e-8, 2e-12, 0.1)
    res_k, pw_k, z_k = energy.rollout_energy(tab, *args)
    res_p, pw_p, z_p = energy.rollout_energy(tab, *args,
                                             solver_backend="torch")
    assert (z_k[:-1] > 0).all()
    assert torch.equal(res_k.assign, res_p.assign)
    assert torch.equal(res_k.aopi, res_p.aopi)
    assert torch.equal(pw_k, pw_p) and torch.equal(z_k, z_p)


# ---------------------------------------------------------------------------
# Attention kernels (flash_attention, flash_decode)
# ---------------------------------------------------------------------------

# tests/test_kernels.py's bars: 2e-5 in f32, 5e-2 in bf16 (a bf16 output
# rounds at 2^-8 relative; both sides accumulate in f32).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}

# (b, s, t, h, kvh, d): tests/test_kernels.py's sweep, then qwen2.5-3b's
# prefill widths (h=16, kvh=2, d=128) at a frame (s=6), a non-multiple of
# the tile, and a long prompt, then jamba's (h=64, kvh=8).
PREFILL_SHAPES = [(2, 256, 256, 4, 2, 64), (1, 128, 384, 8, 8, 128),
                  (2, 256, 256, 4, 1, 128), (1, 192, 192, 6, 2, 64),
                  (1, 6, 6, 16, 2, 128), (1, 192, 192, 16, 2, 128),
                  (1, 2048, 2048, 16, 2, 128), (1, 300, 300, 64, 8, 128)]
# (b, t, h, kvh, d): tests/test_kernels.py's sweep, then qwen2.5-3b's
# and jamba's decode widths over 8 lanes of a 4096-row cache.
DECODE_SHAPES = [(2, 512, 8, 2, 64), (4, 1024, 4, 4, 128),
                 (1, 384, 8, 1, 128), (3, 640, 16, 8, 64),
                 (8, 4096, 16, 2, 128), (8, 4096, 64, 8, 128)]


def _normal(shape, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(dtype)


def _close(got, want, dtype):
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_gpu_flash_attention_matches_plain(cuda, shape, dtype):
    b, s, t, h, kvh, d = shape
    q = _normal((b, s, h, d), dtype, cuda, 0)
    k = _normal((b, t, kvh, d), dtype, cuda, 1)
    v = _normal((b, t, kvh, d), dtype, cuda, 2)
    fa_ops.reset_launches()
    out = fa_ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.launches["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, fa_ref.mha_ref(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("d", [16, 64, 128, 144, 256])
@pytest.mark.parametrize("causal,q_offset", [(False, None), (True, 5),
                                             (True, -3)])
def test_gpu_flash_attention_options(cuda, d, causal, q_offset):
    """Head dims of both tilings, full attention, an explicit scale and
    q_offset (rows above the diagonal see no key: both sides then average
    the tile's V as the TPU kernel does), s and t off the tile."""
    q = _normal((2, 70, 4, d), torch.float32, cuda, 3)
    k = _normal((2, 90, 2, d), torch.float32, cuda, 4)
    v = _normal((2, 90, 2, d), torch.float32, cuda, 5)
    kw = dict(causal=causal, scale=0.3, q_offset=q_offset)
    out = fa_ops.attention(q, k, v, **kw)
    want = fa_ref.mha_ref(q, k, v, **kw)
    if q_offset is not None and q_offset < 0:
        # Rows with no visible key: kernel and plain version both average
        # over masked keys but over different key sets; compare the rest.
        rows = torch.arange(70, device=cuda) + q_offset >= 0
        out, want = out[:, rows], want[:, rows]
    _close(out, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,q_offset", [(True, None), (False, None),
                                             (True, -3)])
@pytest.mark.parametrize("d", [128, 256])
def test_gpu_flash_attention_tilings(cuda, d, causal, q_offset, dtype):
    """Each tiling as the library reports it (kernel.TILINGS), with s < t
    and t not a multiple of BK: against mha_ref on the rows that see a key,
    and against the plain version of the kernel's schedule
    (flash_tiled_ref) on every row, those that see none included."""
    bq, bk = fa_kernel.tiles(d)
    got = fa_kernel.tiling(d)
    assert (got["bq"], got["bk"], 16 * got["warps"]) == (bq, bk, bq)
    assert got["slots"] >= 2
    s = bq + 5
    t = s + bk + 7                  # s < t, t not a multiple of BK
    assert t % bk
    q = _normal((2, s, 4, d), dtype, cuda, 30)
    k = _normal((2, t, 2, d), dtype, cuda, 31)
    v = _normal((2, t, 2, d), dtype, cuda, 32)
    kw = dict(causal=causal, q_offset=q_offset)
    fa_ops.reset_launches()
    out = fa_ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launches["flash_attention"] == 1
    _close(out, fa_ref.flash_tiled_ref(q, k, v, block_q=bq, block_k=bk,
                                       **kw), dtype)
    off = (t - s) if q_offset is None else q_offset
    rows = torch.arange(s, device=cuda) + off >= 0 if causal else slice(None)
    _close(out[:, rows], fa_ref.mha_ref(q, k, v, **kw)[:, rows], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_gpu_flash_decode_matches_plain(cuda, shape, dtype):
    b, t, h, kvh, d = shape
    q = _normal((b, h, d), dtype, cuda, 6)
    kc = _normal((b, t, kvh, d), dtype, cuda, 7)
    vc = _normal((b, t, kvh, d), dtype, cuda, 8)
    lens = [t // 2 + 37 * i for i in range(b)]
    if b == 8:                      # ragged lanes, a fresh and a full one
        lens = [1, t, 37, 511, 512, 513, 2048, t - 1]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    dec_ops.reset_launches()
    out = dec_ops.decode_attention(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert dec_ops.launches["flash_decode"] == 1
    _close(out, dec_ref.decode_ref(q, kc, vc, kv_len), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096, 16, 2, 128),
                                   (8, 4096, 64, 8, 128),
                                   (3, 640, 16, 8, 64)])
def test_gpu_flash_decode_split_boundaries(cuda, shape, dtype):
    """Lanes whose kv_len falls on, just below and just above a boundary of
    the split the host plans for this cache, one row, the whole cache and
    an empty lane; held against decode_ref and against the plain version
    of the same split (decode_split_ref)."""
    b, t, h, kvh, d = shape
    n_split, chunk = dec_kernel.split_plan(b, t, kvh,
                                           dec_kernel.sm_count(cuda))
    assert n_split > 1 and chunk % dec_kernel.TILE == 0
    lens = [chunk, chunk - 1, chunk + 1, 2 * chunk, 1, t, t - 1, 0][:b]
    q = _normal((b, h, d), dtype, cuda, 20)
    kc = _normal((b, t, kvh, d), dtype, cuda, 21)
    vc = _normal((b, t, kvh, d), dtype, cuda, 22)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    dec_ops.reset_launches()
    out = dec_ops.decode_attention(q, kc, vc, kv_len)
    torch.cuda.synchronize()
    assert dec_ops.launches["flash_decode"] == 1
    _close(out, dec_ref.decode_ref(q, kc, vc, kv_len), dtype)
    _close(out, dec_ref.decode_split_ref(q, kc, vc, kv_len, n_split, chunk),
           dtype)
    if 0 in lens:
        assert torch.count_nonzero(out[lens.index(0)]) == 0


def test_gpu_flash_decode_empty_cache_gives_zeros(cuda):
    q = _normal((3, 16, 128), torch.float32, cuda, 9)
    kc = _normal((3, 64, 2, 128), torch.float32, cuda, 10)
    kv_len = torch.tensor([0, 5, 0], dtype=torch.int32, device=cuda)
    out = dec_ops.decode_attention(q, kc, kc.clone(), kv_len)
    assert torch.count_nonzero(out[0]) == 0
    assert torch.count_nonzero(out[2]) == 0
    _close(out, dec_ref.decode_ref(q, kc, kc.clone(), kv_len),
           torch.float32)


def test_gpu_attention_wrappers_refuse_bad_inputs(cuda, monkeypatch):
    q = _normal((1, 8, 4, 64), torch.float32, cuda, 11)
    k = _normal((1, 8, 2, 64), torch.float32, cuda, 12)
    with pytest.raises(TypeError, match="dtype"):
        fa_ops.attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError, match="dtype"):
        fa_ops.attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="several devices"):
        fa_ops.attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                         k)
    for d in (8, 24, 272):
        qd = _normal((1, 8, 4, d), torch.float32, cuda, 13)
        kd = _normal((1, 8, 2, d), torch.float32, cuda, 14)
        with pytest.raises(ValueError, match="head dim"):
            fa_ops.attention(qd, kd, kd)
    with pytest.raises(ValueError, match="impl"):
        fa_ops.attention(q, k, k, impl="cuda")
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.attention(shifted, k, k)
    qd = _normal((2, 4, 64), torch.float32, cuda, 15)
    kc = _normal((2, 16, 2, 64), torch.float32, cuda, 16)
    with pytest.raises(TypeError, match="int32"):
        dec_ops.decode_attention(qd, kc, kc, torch.tensor([3, 4],
                                                          device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        dec_ops.decode_attention(qd.bfloat16(), kc, kc, torch.tensor(
            [3, 4], dtype=torch.int32, device=cuda))
    # No fallback: a kernel that cannot be built or launched raises.
    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(fa_kernel._Library, "get", broken)
    monkeypatch.setattr(dec_kernel._Library, "get", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa_ops.attention(q, k, k)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dec_ops.decode_attention(qd, kc, kc, torch.tensor(
            [3, 4], dtype=torch.int32, device=cuda))


def _reduced_engine(impl, dev, params=None):
    cfg = configs.get("qwen2.5-3b").reduced()
    model = models.build(cfg, impl=impl)
    if params is None:
        params = models.common.init_params(
            model.template(), torch.Generator(device=dev).manual_seed(0),
            device=dev)
    return Engine(model, params, n_lanes=3, max_len=64, decode_tokens=8,
                  device=dev), params


def test_gpu_reduced_model_kernels_match_torch(cuda):
    """A two-layer reduced qwen2.5-3b on the card: the kernel run (prefill
    through flash_attention, decode through flash_decode) against the
    impl="torch" run of the same engine, teacher-forced on the kernel
    run's tokens."""
    eng_k, params = _reduced_engine("auto", cuda)
    eng_p, _ = _reduced_engine("torch", cuda, params)
    fa_ops.reset_launches()
    dec_ops.reset_launches()
    prompts = [np.arange(2, 9), np.arange(40, 61), np.arange(100, 106)]
    for lane, toks in enumerate(prompts):
        lk = eng_k.prefill_lane(toks, lane)
        lp = eng_p.prefill_lane(toks, lane)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
    last = np.array([int(torch.argmax(eng_k.prefill_lane(t, i)))
                     for i, t in enumerate(prompts)], np.int32)
    for _ in range(8):
        lk = eng_k.decode_logits(last)
        lp = eng_p.decode_logits(last)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        last = torch.argmax(lk, -1).cpu().numpy().astype(np.int32)
    assert fa_ops.launches["flash_attention"] == 2 * 2 * len(prompts)
    assert dec_ops.launches["flash_decode"] == 8 * 2
    assert eng_k.admit(Frame(0, 0.0, 0.0), np.arange(5, dtype=np.int32))


# ---------------------------------------------------------------------------
# mlstm_chunkwise
# ---------------------------------------------------------------------------

# tests/test_kernels.py's bar (atol 2e-3, rtol 1e-3) in f32; bf16 outputs
# round at 2^-8 relative, held at 5e-2 as the attention kernels are.
MLSTM_TOL = {torch.float32: (2e-3, 1e-3), torch.bfloat16: (5e-2, 5e-2)}
# (b, s, h, d): tests/test_kernels.py's sweep, the reduced model's d = 32
# off the tile, then xlstm-1.3b's widths (h = 4, d = 1024) at a frame, off
# the tile and a long prompt.
MLSTM_SHAPES = [(2, 128, 2, 64), (1, 256, 4, 128), (2, 192, 2, 64),
                (3, 70, 4, 32), (1, 6, 4, 1024), (1, 200, 4, 1024),
                (1, 2048, 4, 1024)]


def _mlstm_inputs(b, s, h, d, dtype, dev, seed):
    """The reference tests' distributions: q, k, v ~ N(0, 1), i ~ N(0,
    0.25), f ~ N(2, 1)."""
    rng = np.random.default_rng(seed)
    q, k, v = (_normal((b, s, h, d), dtype, dev, seed + i) for i in range(3))
    ig = torch.as_tensor((rng.standard_normal((b, s, h)) * 0.5)
                         .astype(np.float32), device=dev).to(dtype)
    fg = torch.as_tensor((rng.standard_normal((b, s, h)) + 2.0)
                         .astype(np.float32), device=dev).to(dtype)
    return q, k, v, ig, fg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MLSTM_SHAPES)
def test_gpu_mlstm_chunkwise_matches_plain(cuda, shape, dtype):
    args = _mlstm_inputs(*shape, dtype, cuda, 17)
    ml_ops.reset_launches()
    out = ml_ops.mlstm(*args)
    torch.cuda.synchronize()
    assert ml_ops.launches["mlstm_chunkwise"] == 1
    assert out.dtype == dtype and out.shape == args[0].shape
    atol, rtol = MLSTM_TOL[dtype]
    torch.testing.assert_close(out.float(),
                               ml_ref.mlstm_parallel_ref(*args).float(),
                               atol=atol, rtol=rtol)


# (d, cluster size) as kernel.cluster_plan gives them: 1 (d = 32, 256), 2
# (512), 4 (1024) and 8 (2048; 4096, the widest slice).
MLSTM_CLUSTERS = [(32, 1), (256, 1), (512, 2), (1024, 4), (2048, 8),
                  (4096, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,n_ranks", MLSTM_CLUSTERS)
def test_gpu_mlstm_cluster_sizes(cuda, d, n_ranks, dtype):
    args = _mlstm_inputs(1, 200, 2, d, dtype, cuda, 23)
    assert ml_kernel.cluster_plan(d)[0] == n_ranks
    out = ml_ops.mlstm(*args)
    torch.cuda.synchronize()
    atol, rtol = MLSTM_TOL[dtype]
    for want in (ml_ref.mlstm_cluster_ref(*args, n_ranks),
                 ml_ref.mlstm_parallel_ref(*args)):
        torch.testing.assert_close(out.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1024, 2048, 4096])
def test_gpu_mlstm_cluster_shares_one_denominator(cuda, d, dtype):
    """With v = 1 every column of an output row is sum S / den: bitwise one
    value across all the slices of a cluster only if every CTA holds the
    same scores, max and denominator."""
    assert ml_kernel.cluster_plan(d)[0] > 1
    q, k, _, ig, fg = _mlstm_inputs(1, 130, 2, d, dtype, cuda, 24)
    out = ml_ops.mlstm(q, k, torch.ones_like(q), ig, fg)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, out[..., :1].expand_as(out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 1024])
def test_gpu_mlstm_clamped_rows_within_the_bar(cuda, d, dtype):
    """Tiny q makes |sum S| fall below exp(-m) on most rows, where the
    denominator is clamped: the output stays finite and inside the bar.
    v is scaled up by as much as q is scaled down, so the outputs are O(1)
    (mean |want| ~1.8) and an output of zeros would fall outside the bar."""
    q, k, v, ig, fg = _mlstm_inputs(2, 150, 2, d, torch.float32, cuda, 25)
    q, v = q * 1e-3, v * 1e3
    logf = torch.nn.functional.logsigmoid(fg)
    cum = torch.cumsum(logf, dim=1)
    dtil = cum[:, :, None] - cum[:, None] + ig[:, None]
    causal = torch.ones(150, 150, dtype=torch.bool, device=cuda).tril()
    dtil = torch.where(causal[None, :, :, None], dtil,
                       torch.tensor(-1e30, device=cuda))
    m = dtil.amax(2)
    S = (torch.einsum("bthd,bshd->btsh", q, k) * d ** -0.5
         * torch.exp(dtil - m[:, :, None]))
    clamped = S.sum(2).abs() < torch.exp(-m)
    assert clamped.float().mean() > 0.5
    args = [x.to(dtype) for x in (q, k, v, ig, fg)]
    out = ml_ops.mlstm(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    atol, rtol = MLSTM_TOL[dtype]
    want = ml_ref.mlstm_parallel_ref(*args).float()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(torch.zeros_like(want), want, atol=atol,
                                   rtol=rtol)
    torch.testing.assert_close(out.float(), want, atol=atol, rtol=rtol)


def test_gpu_mlstm_wrapper_refuses_bad_inputs(cuda, monkeypatch):
    q, k, v, ig, fg = _mlstm_inputs(1, 8, 2, 64, torch.float32, cuda, 18)
    with pytest.raises(TypeError, match="dtype"):
        ml_ops.mlstm(q.half(), k.half(), v.half(), ig.half(), fg.half())
    with pytest.raises(TypeError, match="dtype"):
        ml_ops.mlstm(q, k, v, ig.bfloat16(), fg)
    with pytest.raises(ValueError, match="several devices"):
        ml_ops.mlstm(q, k.cpu(), v, ig, fg)
    with pytest.raises(ValueError, match="contiguous"):
        ml_ops.mlstm(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     ig, fg)
    with pytest.raises(ValueError, match="shapes"):
        ml_ops.mlstm(q, k, v[:, :4].contiguous(), ig, fg)
    qd, kd, vd, igd, fgd = _mlstm_inputs(1, 8, 2, 24, torch.float32, cuda, 19)
    with pytest.raises(ValueError, match="head dim"):
        ml_ops.mlstm(qd, kd, vd, igd, fgd)
    with pytest.raises(ValueError, match="impl"):
        ml_ops.mlstm(q, k, v, ig, fg, impl="cuda")

    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(ml_kernel._Library, "get", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ml_ops.mlstm(q, k, v, ig, fg)


def _reduced_xlstm_engine(impl, dev, params=None):
    model = models.build(configs.get("xlstm-1.3b").reduced(), impl=impl)
    if params is None:
        params = models.common.init_params(
            model.template(), torch.Generator(device=dev).manual_seed(0),
            device=dev)
    return Engine(model, params, n_lanes=3, max_len=64, decode_tokens=8,
                  device=dev), params


def test_gpu_reduced_xlstm_kernel_matches_torch(cuda):
    """The reduced xlstm-1.3b (2 periods of [mlstm, slstm]) on the card:
    the kernel run (each prefill through mlstm_chunkwise, once per mLSTM
    layer; decode without it) against the impl="torch" run of the same
    engine, teacher-forced on the kernel run's tokens."""
    eng_k, params = _reduced_xlstm_engine("auto", cuda)
    eng_p, _ = _reduced_xlstm_engine("torch", cuda, params)
    ml_ops.reset_launches()
    prompts = [np.arange(2, 9), np.arange(40, 61), np.arange(100, 106)]
    last = np.zeros(3, np.int32)
    for lane, toks in enumerate(prompts):
        lk = eng_k.prefill_lane(toks, lane)
        lp = eng_p.prefill_lane(toks, lane)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        last[lane] = int(torch.argmax(lk))
    assert ml_ops.launches["mlstm_chunkwise"] == 2 * len(prompts)
    for _ in range(8):
        lk = eng_k.decode_logits(last)
        lp = eng_p.decode_logits(last)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        last = torch.argmax(lk, -1).cpu().numpy().astype(np.int32)
    assert ml_ops.launches["mlstm_chunkwise"] == 2 * len(prompts)
    assert eng_k.admit(Frame(0, 0.0, 0.0), np.arange(5, dtype=np.int32))
    assert ml_ops.launches["mlstm_chunkwise"] == 2 * len(prompts) + 2


# ---------------------------------------------------------------------------
# selective_scan
# ---------------------------------------------------------------------------

# f32: the reference's bar (atol 1e-4) with a relative term for jamba's
# long sequences; the kernel rounds as the plain version does but sums the
# n states in another order. bf16: the kernel computes in f32 as it does
# for f32 inputs and rounds y once, so its bf16 y is the bf16 rounding of
# its f32 y on the same (bf16-valued) inputs, bitwise, and h_last equals
# that run's; against the plain version y is then within one bf16 rounding
# (2^-8 * |want|) plus the f32 bar's atol (near y = 0 the sum over n in
# another order moves y by more than 1e-6).
SCAN_TOL = (1e-4, 1e-4)
# (b, s, inner, n): tests/test_kernels.py's sweep, a ragged channel block
# and a ragged chunk, rows of x that are no whole number of 16-byte units
# (the kernel's element loads), then jamba's widths (inner 16384, n 16).
SCAN_SHAPES = [(2, 128, 64, 16), (1, 256, 128, 16), (2, 96, 32, 8),
               (3, 37, 200, 5), (2, 45, 37, 16), (1, 6, 16384, 16),
               (1, 300, 16384, 16)]


def _scan_inputs(b, s, inner, n, dtype, dev, seed, h0=False):
    """The reference tests' distributions (see test_torch_selective_scan);
    x, dt, B and C in ``dtype``, A, D and h0 in f32."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.as_tensor(a.astype(np.float32), device=dev).to(dt)
    out = [t(rng.standard_normal((b, s, inner)), dtype),
           t(np.logaddexp(rng.standard_normal((b, s, inner)) - 1.0, 0),
             dtype),
           t(-np.exp(rng.standard_normal((inner, n)) * 0.5)),
           t(rng.standard_normal((b, s, n)), dtype),
           t(rng.standard_normal((b, s, n)), dtype),
           t(rng.standard_normal(inner))]
    out.append(t(rng.standard_normal((b, inner, n)) * 0.5) if h0 else None)
    return out


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_gpu_selective_scan_matches_plain(cuda, shape, dtype, h0):
    args = _scan_inputs(*shape, dtype, cuda, 20, h0)
    ss_ops.reset_launches()
    y, h = ss_ops.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss_ops.launches["selective_scan"] == 1
    assert y.dtype == dtype and y.shape == args[0].shape
    assert h.dtype == torch.float32 and h.shape == (shape[0], shape[2],
                                                    shape[3])
    f32 = [a if a is None else a.float() for a in args]
    y_want, h_want = ss_ref.selective_scan_ref(*f32)
    atol, rtol = SCAN_TOL
    if dtype == torch.float32:
        # Each state is updated as the plain version updates it: bitwise.
        assert torch.equal(h, h_want)
        torch.testing.assert_close(y, y_want, atol=atol, rtol=rtol)
    else:
        torch.testing.assert_close(h, h_want, atol=atol, rtol=rtol)
        y32, h32 = ss_ops.selective_scan(*f32)
        assert torch.equal(y, y32.to(dtype)) and torch.equal(h, h32)
        err = (y.float() - y_want).abs()
        assert bool((err <= 2.0 ** -8 * y_want.abs() + atol).all()), \
            float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_gpu_selective_scan_matches_lanes_ref(cuda, shape, dtype):
    """y is the plain version of the kernel's order (states split over the
    launched lanes, a butterfly over them) bitwise, h_last too; bf16 is
    the rounding of that f32 y."""
    lanes = ss_kernel.plan()["lanes"]
    assert lanes == ss_kernel.LANES
    args = _scan_inputs(*shape, dtype, cuda, 23, h0=True)
    y, h = ss_ops.selective_scan(*args)
    y_want, h_want = ss_ref.selective_scan_lanes_ref(*args, lanes=lanes)
    torch.cuda.synchronize()
    assert y.dtype == y_want.dtype == dtype
    assert torch.equal(y, y_want) and torch.equal(h, h_want)


def test_gpu_selective_scan_wrapper_refuses_bad_inputs(cuda, monkeypatch):
    x, dt, A, B, C, D, _ = _scan_inputs(1, 8, 64, 16, torch.float32, cuda,
                                        21)
    ss_ops.reset_launches()
    with pytest.raises(TypeError, match="dtype"):
        ss_ops.selective_scan(x.half(), dt.half(), A, B, C, D)
    with pytest.raises(TypeError, match="dtype"):
        ss_ops.selective_scan(x, dt.bfloat16(), A, B, C, D)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ss_ops.selective_scan(x, dt, A, B.half(), C, D)
    with pytest.raises(TypeError, match="h0"):
        ss_ops.selective_scan(x, dt, A, B, C, D,
                              torch.zeros((1, 64, 16), device=cuda,
                                          dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="several devices"):
        ss_ops.selective_scan(x, dt.cpu(), A, B, C, D)
    with pytest.raises(ValueError, match="contiguous"):
        ss_ops.selective_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                              dt, A, B, C, D)
    with pytest.raises(ValueError, match="contiguous"):
        ss_ops.selective_scan(x, dt, A.t().contiguous().t(), B, C, D)
    with pytest.raises(ValueError, match="shapes"):
        ss_ops.selective_scan(x, dt[:, :4].contiguous(), A, B, C, D)
    with pytest.raises(ValueError, match="shapes"):
        ss_ops.selective_scan(x, dt, A, B, C, D[:32].contiguous())
    xs, dts, As, Bs, Cs, Ds, _ = _scan_inputs(1, 8, 64, 17, torch.float32,
                                              cuda, 22)
    with pytest.raises(ValueError, match="state size"):
        ss_ops.selective_scan(xs, dts, As, Bs, Cs, Ds)
    with pytest.raises(ValueError, match="impl"):
        ss_ops.selective_scan(x, dt, A, B, C, D, impl="cuda")
    assert ss_ops.launches["selective_scan"] == 0

    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(ss_kernel._Library, "get", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ss_ops.selective_scan(x, dt, A, B, C, D)


def _reduced_jamba_engine(impl, dev, params=None):
    model = models.build(configs.get("jamba-1.5-large-398b").reduced(),
                         impl=impl)
    if params is None:
        params = models.common.init_params(
            model.template(), torch.Generator(device=dev).manual_seed(0),
            device=dev)
    return Engine(model, params, n_lanes=3, max_len=64, decode_tokens=8,
                  device=dev), params


def test_gpu_reduced_jamba_kernels_match_torch(cuda):
    """The reduced jamba (2 periods of [attn, mamba x3], MoE on the odd
    layers) on the card: the kernel run (each prefill through
    flash_attention once and selective_scan three times per period, each
    tick through flash_decode once per period and no scan) against the
    impl="torch" run of the same engine, teacher-forced on the kernel
    run's tokens."""
    eng_k, params = _reduced_jamba_engine("auto", cuda)
    eng_p, _ = _reduced_jamba_engine("torch", cuda, params)
    for mod in (fa_ops, dec_ops, ss_ops):
        mod.reset_launches()
    prompts = [np.arange(2, 9), np.arange(40, 61), np.arange(100, 106)]
    last = np.zeros(3, np.int32)
    for lane, toks in enumerate(prompts):
        lk = eng_k.prefill_lane(toks, lane)
        lp = eng_p.prefill_lane(toks, lane)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        last[lane] = int(torch.argmax(lk))
    assert ss_ops.launches["selective_scan"] == 6 * len(prompts)
    assert fa_ops.launches["flash_attention"] == 2 * len(prompts)
    for _ in range(8):
        lk = eng_k.decode_logits(last)
        lp = eng_p.decode_logits(last)
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        last = torch.argmax(lk, -1).cpu().numpy().astype(np.int32)
    assert ss_ops.launches["selective_scan"] == 6 * len(prompts)
    assert dec_ops.launches["flash_decode"] == 2 * 8
    for key, leaf in eng_k.cache["blocks"]["p1"]["state"].items():
        torch.testing.assert_close(leaf, eng_p.cache["blocks"]["p1"]
                                   ["state"][key], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The scenario sweep: kernels against the plain path, obs on the card
# ---------------------------------------------------------------------------

SWEEP_MIX = ["steady_ar1", "camera_churn", "gilbert_elliott"]
SWEEP_DIMS = dict(n_cameras=30, n_servers=3, n_slots=3, seed=0, churn_t0=1)


def test_gpu_kernel_sweep_equals_plain_sweep(cuda):
    """A small mixed suite: the kernel sweep ("auto") equals the plain one
    ("torch") exactly, every policy; the churned scenario takes the masked
    path; obs.dispatch.count equals the launch counters per kernel."""
    from repro_torch import obs, scenarios
    suite = scenarios.suite(SWEEP_MIX, SWEEP_DIMS, device=cuda)
    obs.reset()
    ops.reset_launches()
    res_k = scenarios.sweep(suite, device=cuda)
    launched = dict(ops.launches)
    res_p = scenarios.sweep(suite, solver_backend="torch", device=cuda)
    assert res_k.errors == {} and res_p.errors == {}
    assert res_k.masked == ["camera_churn"]
    for policy in scenarios.POLICIES:
        for f in ("aopi", "acc", "q"):
            got = getattr(res_k, f)[policy]
            assert np.isfinite(got).all(), (policy, f)
            np.testing.assert_array_equal(got, getattr(res_p, f)[policy],
                                          err_msg=f"{policy} {f}")
    for name in ("config_argmin", "waterfill_pair", "baseline_argmax"):
        assert launched[name] > 0, name
    assert ops.launches == launched          # the plain sweep launched none
    for name, count in launched.items():
        series = [m for m in obs.registry().collect("obs.dispatch.count")
                  if m.labels["entry"] == name]
        assert sum(m.value for m in series) == count, name


@pytest.mark.parametrize("masked", [True, False])
def test_gpu_plain_solve_graph_equals_eager(cuda, masked):
    """A plain solve on the card (masked, or "torch") replays a CUDA graph
    of the plain version: bitwise the eager plain solve, given q as a
    Python number, on a second call with other inputs too (the graph's
    inputs are refreshed)."""
    bcd.release_graphs()
    tab = profiles.EdgeSystem(n_cameras=30, n_servers=3, n_slots=3,
                              seed=4).horizon(2, device=cuda)
    sid = (torch.arange(30, device=cuda) % 3).to(torch.int32)
    rng = np.random.default_rng(0)
    for t in range(2):
        act = torch.as_tensor((rng.uniform(size=30) > 0.4).astype(
            np.float32), device=cuda) if masked else None
        q = 0.3 * t + 0.1
        args = (tab.acc[t], tab.xi, tab.size, tab.eff, sid,
                tab.budgets_b[t], tab.budgets_c[t])
        got = bcd.solve_slot(*args, torch.tensor(q, device=cuda), 10.0,
                             n_servers=3, active=act,
                             solver_backend="auto" if masked else "torch")
        want = bcd._solve(*args, q, act, V=10.0, n_servers=3, n_iters=4,
                          solver_effort="fast",
                          spec=bcd.resolve_spec("torch", cuda, 30))
        for f in ("r_idx", "m_idx", "pol", "b", "c", "aopi", "score"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (t, f)
        if masked:
            assert (got.b[act == 0] == 0).all()
    assert len(bcd._GRAPHS) == 1
    if masked:
        with pytest.raises(ValueError, match="mask"):
            bcd.solve_slot(*args, 0.0, 10.0, n_servers=3, active=act,
                           solver_backend="cuda")


def test_gpu_span_does_not_synchronise(cuda):
    """A span around queued work returns with the work still queued: it
    neither synchronises the device nor waits on the stream."""
    from repro_torch import obs
    obs.reset()
    stream = torch.cuda.current_stream()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # ~0.1 s of device time queued
    with obs.span("obs.gpu_test"):
        torch.ones(4, device=cuda).add_(1.0)
    assert not stream.query(), "the span waited for the device"
    torch.cuda.synchronize()
    assert [e["name"] for e in obs.events()] == ["obs.gpu_test"]


# ---------------------------------------------------------------------------
# The data plane: gi_g1_window and tick_scan against their plain versions
# ---------------------------------------------------------------------------

#: Bitwise on the card: every family but lognormal, whose inverse normal
#: CDF is the kernel's copy of PyTorch's polynomial (csrc/dataplane.cu).
DATAPLANE_RTOL = {"lognormal": 1e-12}


def _window_inputs(e, n, dtype, dev, seed=0):
    """Rates of the paper's scale with a dead lane, mixed policies and the
    epoch keys of seed 7 from epoch 3."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(2.0, 9.0, (e, n))
    mu = rng.uniform(6.0, 20.0, (e, n))
    lam[0, 1] = 1e-6                       # a dead lane's clamped stand-in
    p = rng.uniform(0.4, 0.95, (e, n))
    pol = rng.integers(0, 2, (e, n)).astype(np.int32)
    keys = threefry.fold_in(threefry.key(7, dev),
                            torch.arange(3, 3 + e, device=dev))

    def put(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    return put(lam), put(mu), put(p), put(pol, torch.int32), keys


def _assert_window_equal(got, want, rtol, label):
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, (label, name)
        if rtol is None or name.startswith("n_"):
            assert torch.equal(g, w), (label, name,
                                       float((g - w).abs().max()))
        else:
            torch.testing.assert_close(g, w, rtol=rtol, atol=0.0,
                                       msg=f"{label} {name}")


@pytest.mark.parametrize("frames", [640, 1280])
@pytest.mark.parametrize("model", ["mm1", "uniform", "gamma", "lognormal",
                                   "weibull"])
def test_gpu_window_kernel_matches_plain(cuda, model, frames):
    """One window of 4 epochs x 12 streams, FCFS and LCFSP lanes, a dead
    lane and delay samples, float32 (640 frames, light tails) or float64:
    the kernel equals the plain loop on the card bitwise (lognormal within
    1e-12), its delay samples (the threefry draws) included."""
    heavy = model in ("lognormal", "weibull")
    dtype = torch.float64 if frames > 1024 or heavy else torch.float32
    lam, mu, p, pol, keys = _window_inputs(4, 12, dtype, cuda)
    args = (lam, mu, p, pol, keys, 90.0, frames, model, 48)
    dp_ops.reset_launches()
    got = dp_ops.gi_g1_window(*args)
    assert dp_ops.launches["gi_g1_window"] == 1
    want = queues._window_sim(*args)
    assert dp_ops.launches["gi_g1_window"] == 1
    assert got["delay_samples"].shape == (4, 12, 48)
    _assert_window_equal(got, want, DATAPLANE_RTOL.get(model), model)
    done = got["n_completed"].clone()
    done[0, 1] = 1.0                       # the dead lane completes nothing
    assert (done > 0).all()


@pytest.mark.parametrize("model", ["uniform", "gamma", "lognormal",
                                   "weibull"])
def test_gpu_window_kernel_follows_family_constants(cuda, monkeypatch,
                                                    model):
    """Every family constant reaches the kernel from ``queues`` at run
    time: with other values there (an Erlang-4 gamma, nine uniform rows a
    frame), the kernel still equals the plain loop on the card. (Weibull
    shapes whose 1/k PyTorch's pow turns into a product or a root, 1/k in
    {0.5, 2, 3, -0.5, -1, -2}, would differ by ulps: 0.6 is none.)"""
    for name, value in (("UNIFORM_SPREAD", 0.3), ("GAMMA_SHAPE", 4.0),
                        ("LOGNORMAL_SIGMA", 0.75), ("WEIBULL_SHAPE", 0.6)):
        monkeypatch.setattr(queues, name, value)
    assert queues._n_uniforms("gamma") == 9
    heavy = model in ("lognormal", "weibull")
    dtype = torch.float64 if heavy else torch.float32
    lam, mu, p, pol, keys = _window_inputs(3, 10, dtype, cuda, seed=5)
    args = (lam, mu, p, pol, keys, 90.0, 640, model, 32)
    got = dp_ops.gi_g1_window(*args)
    want = queues._window_sim(*args)
    _assert_window_equal(got, want, DATAPLANE_RTOL.get(model), model)


def test_gpu_window_kernel_full_epoch(cuda):
    """The service's window at the paper's size: 8 epochs x 30 streams,
    49,152 frames (a 300 s epoch), float64, against the plain loop."""
    lam, mu, p, pol, keys = _window_inputs(8, 30, torch.float64, cuda,
                                           seed=1)
    lam, mu = lam * 14.0, mu * 14.0      # ~30-130 frames/s, as LBCD plans
    args = (lam.contiguous(), mu.contiguous(), p, pol, keys, 300.0, 49_152,
            "mm1")
    got = dp_ops.gi_g1_window(*args)
    want = queues._window_sim(*args)
    _assert_window_equal(got, want, None, "full")
    assert bool((got["horizon"] == 300.0).all())


@pytest.mark.parametrize("model", ["mm1", "uniform", "gamma", "lognormal",
                                   "weibull"])
def test_gpu_tick_scan_matches_plain_and_des(cuda, model):
    """The engine rung's scan: the kernel on the card equals the plain scan
    on the CPU bitwise (which equals the DES), trace included."""
    rng = np.random.default_rng(2)
    lam = rng.uniform(2.0, 9.0, (3, 10))
    mu = rng.uniform(4.0, 12.0, (3, 10))
    p = rng.uniform(0.4, 0.95, (3, 10))
    pol = rng.integers(0, 2, (3, 10))
    active = np.ones((3, 10))
    active[1, 4] = 0.0
    kw = dict(epoch_duration=60.0, seed=4, t0=2, delay_model=model,
              active=active, frames_cap=512, collect_samples=16,
              collect_trace=True)
    dp_ops.reset_launches()
    got = tick_plane.measure_engine_window_scan(lam, mu, p, pol,
                                                device=cuda, **kw)
    assert dp_ops.launches["tick_scan"] == 1
    want = tick_plane.measure_engine_window_scan(lam, mu, p, pol,
                                                 device="cpu", **kw)
    assert got["trace"] == want["trace"] and len(got["trace"]) > 0
    for name, w in want.items():
        if name != "trace":
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_gpu_tick_scan_kernel_matches_plain_on_card(cuda):
    """The kernel against the plain scan on the card, at the service's
    engine epoch (30 streams, 49,152 ticks)."""
    rng = np.random.default_rng(3)
    lam = rng.uniform(30.0, 130.0, 30)
    mu = lam * rng.uniform(1.3, 3.0, 30)
    T, O, coin = engine_plane.draw_streams(
        lam, mu, np.ones(30, bool), delay_model="mm1", seed=0, t=0,
        frames_cap=49_152)

    def put(x):
        return torch.as_tensor(x, device=cuda)

    args = (put(T), put(O), put(coin), put(rng.uniform(0.4, 0.9, 30)),
            put(rng.integers(0, 2, 30) == 1), put(np.ones(30, bool)), 300.0)
    got = dp_ops.tick_scan(*args)
    want = tick_plane._tick_scan(*args)
    for name, w in want.items():
        assert torch.equal(got[name], w), name


def test_gpu_dataplane_wrappers_refuse_bad_inputs(cuda):
    lam, mu, p, pol, keys = _window_inputs(2, 4, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        dp_ops.gi_g1_window(lam, mu.double(), p, pol, keys, 10.0, 64, "mm1")
    with pytest.raises(TypeError, match="int32"):
        dp_ops.gi_g1_window(lam, mu, p, pol.long(), keys, 10.0, 64, "mm1")
    with pytest.raises(ValueError, match="delay_model"):
        dp_ops.gi_g1_window(lam, mu, p, pol, keys, 10.0, 64, "pareto")
    with pytest.raises(ValueError, match="shape"):
        dp_ops.gi_g1_window(lam, mu, p, pol, keys[:1], 10.0, 64, "mm1")
    t = torch.zeros((3, 8), dtype=torch.float64, device=cuda)
    flag = torch.zeros(3, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        dp_ops.tick_scan(t, t, t.float(), t[:, 0], flag, flag, 1.0)
    with pytest.raises(ValueError, match="shape"):
        dp_ops.tick_scan(t, t, t, t[:2, 0], flag, flag, 1.0)


def test_gpu_service_runs_the_kernels(cuda):
    """AnalyticsService on the card: the planner's kernels and one
    gi_g1_window launch per plan window (mm1), one tick_scan launch per
    engine epoch (engine mode, scan backend); measured AoPI finite and
    within 25% of the closed form on average; no planning failure and no
    rung of the degradation ladder engaged."""
    system = profiles.EdgeSystem(n_cameras=8, n_servers=2, n_slots=8, seed=3)
    ctrl = lbcd.LBCDController(system, v=10.0, p_min=0.6, device=cuda)
    ops.reset_launches()
    dp_ops.reset_launches()
    svc = AnalyticsService(ctrl, epoch_duration=300.0, plan_window=4)
    reps = svc.run(8)
    assert dp_ops.launches == {"gi_g1_window": 2, "tick_scan": 0}
    assert ops.launches["config_argmin"] > 0
    meas = np.array([r.measured_aopi for r in reps])
    pred = np.array([r.predicted_aopi for r in reps])
    assert np.isfinite(meas).all()
    assert meas.mean() == pytest.approx(pred.mean(), rel=0.25)
    assert svc.plan_failures == [] and svc.fallbacks == []
    assert svc.degraded_epochs == []
    ctrl = lbcd.LBCDController(system, v=10.0, p_min=0.6, device=cuda)
    svc = AnalyticsService(ctrl, mode="engine", engine_backend="scan",
                           epoch_duration=60.0, plan_window=4)
    svc.run(2)
    assert dp_ops.launches["tick_scan"] == 2
    assert svc.plan_failures == [] and svc.fallbacks == []
    assert svc.degraded_epochs == []


def test_gpu_interior_graph_is_keyed_by_method(cuda):
    """The interior solve replays its own CUDA graph, bitwise its eager
    solve; a water-fill solve of the same shapes, V, effort and servers,
    replayed right after it, still equals its own eager solve (one graph
    per method: a graph keyed without the method would hand one method's
    answer to the other)."""
    bcd.release_graphs()
    tab = profiles.EdgeSystem(n_cameras=30, n_servers=3, n_slots=3,
                              seed=4).horizon(2, device=cuda)
    sid = (torch.arange(30, device=cuda) % 3).to(torch.int32)
    for t in range(2):
        args = (tab.acc[t], tab.xi, tab.size, tab.eff, sid,
                tab.budgets_b[t], tab.budgets_c[t])
        q = 0.3 * t + 0.1
        solved = {}
        for method in ("interior", "waterfill"):
            got = bcd.solve_slot(*args, torch.tensor(q, device=cuda), 10.0,
                                 n_servers=3, method=method,
                                 solver_backend="torch")
            want = bcd._solve(*args, q, None, V=10.0, n_servers=3,
                              n_iters=4, method=method, solver_effort="fast",
                              spec=bcd.resolve_spec("torch", cuda, 30,
                                                    method=method))
            for f in ("r_idx", "m_idx", "pol", "b", "c", "aopi", "score"):
                assert torch.equal(getattr(got, f), getattr(want, f)), (
                    t, method, f)
            solved[method] = got
        assert not torch.equal(solved["interior"].c, solved["waterfill"].c)
    assert len(bcd._GRAPHS) == 2
    assert {key[-2] for key in bcd._GRAPHS} == {"interior", "waterfill"}
    with pytest.raises(ValueError, match="method='interior'"):
        bcd.solve_slot(*args, 0.0, 10.0, n_servers=3, method="interior",
                       solver_backend="cuda")
    bcd.release_graphs()


def test_gpu_failover_kernels_equal_plain(cuda):
    """Failover on an ``auto`` controller (the slot-solver kernels) equals
    the same call on a ``torch`` controller bitwise; no stream on the dead
    island; the capacities restored."""
    dead = np.array([False, True, False])
    recs = []
    for backend in ("auto", "torch"):
        ctrl = lbcd.LBCDController(profiles.EdgeSystem(n_cameras=30,
                                                       n_servers=3, seed=0),
                                   solver_backend=backend, device=cuda)
        healthy = ctrl.system.capacities(3)
        ops.reset_launches()
        recs.append(failure.failover_assignment(ctrl, 3, dead))
        if backend == "auto":
            assert ops.launches["config_argmin"] > 0
            assert ops.launches["waterfill_pair"] > 0
        for x, y in zip(ctrl.system.capacities(3), healthy):
            np.testing.assert_array_equal(x, y)
    a, b = recs
    assert not dead[a.assign].any()
    np.testing.assert_array_equal(a.assign, b.assign)
    for f in ("r_idx", "m_idx", "pol", "b", "c", "aopi", "acc"):
        np.testing.assert_array_equal(getattr(a.decision, f),
                                      getattr(b.decision, f))
    assert a.q == b.q
    bcd.release_graphs()


def test_gpu_launcher_mm1(cuda, capsys):
    """``launch.serve.main`` on the card at small flags: the planner's
    kernels and one gi_g1_window launch a plan window."""
    ops.reset_launches()
    dp_ops.reset_launches()
    svc = serve.main(["--streams", "8", "--islands", "2", "--epochs", "2"])
    out = capsys.readouterr().out
    assert svc.device.type == "cuda" and svc.mode == "mm1"
    assert out.startswith("epoch  pred-AoPI")
    assert ops.launches["config_argmin"] > 0
    assert dp_ops.launches["gi_g1_window"] >= 1
    meas = np.array([r.measured_aopi for r in svc.reports])
    pred = np.array([r.predicted_aopi for r in svc.reports])
    assert np.isfinite(meas).all()
    assert meas.mean() == pytest.approx(pred.mean(), rel=0.15)
    assert svc.plan_failures == [] and svc.fallbacks == []
