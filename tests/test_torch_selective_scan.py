"""The port's selective scan (plain version and wrapper on the CPU) held
against the JAX package's ``selective_scan_ref`` (associative scan),
``selective_scan_chunked`` and its Pallas kernel in interpret mode, on the
same numpy-seeded inputs."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels.selective_scan import ref as j_ref  # noqa: E402
from repro.kernels.selective_scan.kernel import \
    selective_scan as j_pallas  # noqa: E402
from repro_torch.kernels.selective_scan import ops, ref  # noqa: E402

# tests/test_kernels.py's bar for the reference's own scans (atol 1e-4):
# f32 sums in another order over O(1) outputs.
ATOL = 1e-4
# (b, s, inner, n, chunk, block_i): tests/test_kernels.py's sweep.
SWEEP = [(2, 128, 64, 16, 64, 32), (1, 256, 128, 16, 128, 128),
         (2, 96, 32, 8, 32, 32)]


def _inputs(b, s, inner, n, seed=0, h0=False):
    """The reference tests' distributions: x, B, C, D ~ N(0, 1), dt =
    softplus(N(0, 1) - 1), A = -exp(N(0, 0.25)); h0 ~ N(0, 0.25)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, inner)).astype(f)
    dt = np.logaddexp(rng.standard_normal((b, s, inner)) - 1.0, 0).astype(f)
    A = -np.exp(rng.standard_normal((inner, n)) * 0.5).astype(f)
    B = rng.standard_normal((b, s, n)).astype(f)
    C = rng.standard_normal((b, s, n)).astype(f)
    D = rng.standard_normal(inner).astype(f)
    out = [x, dt, A, B, C, D]
    if h0:
        out.append((rng.standard_normal((b, inner, n)) * 0.5).astype(f))
    return out


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,s,inner,n,chunk,bi", SWEEP)
def test_plain_scan_matches_reference_scans(b, s, inner, n, chunk, bi):
    arrays = _inputs(b, s, inner, n)
    y, h = ref.selective_scan_ref(*_torch(arrays))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert y.shape == (b, s, inner) and h.shape == (b, inner, n)
    wants = {
        "ref": j_ref.selective_scan_ref(*_jax(arrays)),
        "chunked": j_ref.selective_scan_chunked(*_jax(arrays), chunk=chunk),
        "pallas interpret": j_pallas(*_jax(arrays), chunk=chunk, block_i=bi,
                                     interpret=True),
    }
    for name, (yj, hj) in wants.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL,
                                   err_msg=name)


def test_plain_scan_with_h0_matches_reference():
    arrays = _inputs(2, 64, 48, 16, seed=1, h0=True)
    y, h = ref.selective_scan_ref(*_torch(arrays))
    for name, fn in (("ref", j_ref.selective_scan_ref),
                     ("pallas interpret", lambda *a: j_pallas(
                         *a, chunk=32, block_i=16, interpret=True))):
        yj, hj = fn(*_jax(arrays))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL,
                                   err_msg=name)


def test_plain_scan_carries_state_over_two_halves():
    """Scanning two halves with the first's h_last as the second's h0
    computes the same steps as one scan: equal bitwise."""
    x, dt, A, B, C, D = _torch(_inputs(1, 128, 32, 8, seed=3))
    y_full, h_full = ref.selective_scan_ref(x, dt, A, B, C, D)
    y1, h1 = ref.selective_scan_ref(x[:, :64], dt[:, :64], A, B[:, :64],
                                    C[:, :64], D)
    y2, h2 = ref.selective_scan_ref(x[:, 64:], dt[:, 64:], A, B[:, 64:],
                                    C[:, 64:], D, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(h2, h_full)


def test_plain_scan_bf16_inputs():
    """bf16 x, dt, B, C: y comes back in bf16, within one bf16 rounding of
    the reference's f32 scan on the same (bf16-valued) inputs; h_last in
    f32 within the f32 bar."""
    x, dt, A, B, C, D = _inputs(2, 96, 32, 8, seed=4)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, dt, B, C)]
    y, h = ref.selective_scan_ref(bf[0], bf[1], torch.from_numpy(A), bf[2],
                                  bf[3], torch.from_numpy(D))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    xs, dts, Bs, Cs = (jnp.asarray(t.float().numpy()) for t in bf)
    yj, hj = j_ref.selective_scan_ref(xs, dts, jnp.asarray(A), Bs, Cs,
                                      jnp.asarray(D))
    want = np.asarray(yj)
    np.testing.assert_array_less(np.abs(y.float().numpy() - want),
                                 2.0 ** -8 * np.abs(want) + ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL)
    # The reference's own bf16 path (its inputs in bf16) agrees as well.
    yjb, _ = j_ref.selective_scan_ref(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf[:2]),
        jnp.asarray(A), *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                          for t in bf[2:]), jnp.asarray(D))
    assert yjb.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yjb, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_selective_step_matches_reference_and_a_one_token_scan():
    x, dt, A, B, C, D, h0 = _inputs(3, 1, 40, 16, seed=5, h0=True)
    step_args = [x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, h0]
    y, h = ref.selective_step(*_torch(step_args))
    yj, hj = j_ref.selective_step(*_jax(step_args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-6,
                               rtol=1e-6)
    # The step's (dt * B) * x and the scan's (dt * x) * B differ by one
    # rounding at most.
    ys, hs = ref.selective_scan_ref(*_torch([x, dt, A, B, C, D, h0]))
    np.testing.assert_allclose(ys[:, 0].numpy(), y.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(hs.numpy(), h.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_wrapper_on_the_cpu_takes_the_plain_version(impl):
    """CPU tensors go to the plain version under either impl and count no
    launch; a bad impl raises."""
    args = _torch(_inputs(2, 20, 16, 4, seed=6, h0=True))
    ops.reset_launches()
    y, h = ops.selective_scan(*args, impl=impl)
    yr, hr = ref.selective_scan_ref(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    assert ops.launches["selective_scan"] == 0
    with pytest.raises(ValueError, match="impl"):
        ops.selective_scan(*args, impl="cuda")


# ---------------------------------------------------------------------------
# The CUDA kernel's order of the sum over states (its plain version)
# ---------------------------------------------------------------------------

from repro_torch.kernels.selective_scan import kernel as ss_kernel  # noqa: E402,E501

_JAX_SCANS = {}


def _jax_scans(b, s, inner, n, chunk, bi):
    """The reference's scan and its Pallas kernel in interpret mode on
    ``_inputs(..., seed=7)``, computed once per shape."""
    key = (b, s, inner, n, chunk, bi)
    if key not in _JAX_SCANS:
        arrays = _jax(_inputs(b, s, inner, n, seed=7))
        _JAX_SCANS[key] = {
            "ref": j_ref.selective_scan_ref(*arrays),
            "pallas interpret": j_pallas(*arrays, chunk=chunk, block_i=bi,
                                         interpret=True)}
    return _JAX_SCANS[key]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("b,s,inner,n,chunk,bi", SWEEP)
def test_lanes_ref_matches_reference_and_pallas(b, s, inner, n, chunk, bi,
                                                lanes):
    """y summed over the states in the kernel's lane order agrees with the
    reference's scans; h_last is selective_scan_ref's bitwise (the states
    are updated in the same operations)."""
    args = _torch(_inputs(b, s, inner, n, seed=7))
    y, h = ref.selective_scan_lanes_ref(*args, lanes=lanes)
    y0, h0 = ref.selective_scan_ref(*args)
    assert torch.equal(h, h0)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=ATOL)
    for name, (yj, hj) in _jax_scans(b, s, inner, n, chunk, bi).items():
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("lanes", [4, 16])
def test_lanes_ref_short_states_h0_and_bf16(lanes):
    """n = 5 (lanes left short or empty), an initial state, and bf16 x, dt,
    B, C: y within the bar of the reference on the same values, bf16 y the
    rounding of the f32 y, h_last selective_scan_ref's bitwise."""
    x, dt, A, B, C, D, h0 = _inputs(2, 40, 24, 5, seed=8, h0=True)
    args = _torch([x, dt, A, B, C, D, h0])
    y, h = ref.selective_scan_lanes_ref(*args, lanes=lanes)
    assert torch.equal(h, ref.selective_scan_ref(*args)[1])
    yj, hj = j_ref.selective_scan_ref(*_jax([x, dt, A, B, C, D, h0]))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL)
    bf = [t.bfloat16() for t in (args[0], args[1], args[3], args[4])]
    bf_args = [bf[0], bf[1], args[2], bf[2], bf[3], args[5], args[6]]
    yb, hb = ref.selective_scan_lanes_ref(*bf_args, lanes=lanes)
    y32, h32 = ref.selective_scan_lanes_ref(
        *[t.float() for t in bf_args], lanes=lanes)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, y32.bfloat16()) and torch.equal(hb, h32)


def test_lanes_ref_refuses_what_the_kernel_cannot_split():
    args = _torch(_inputs(1, 4, 8, 4, seed=9))
    for lanes in (0, 3, 32):
        with pytest.raises(ValueError, match="lanes"):
            ref.selective_scan_lanes_ref(*args, lanes=lanes)


def test_kernel_lanes_match_the_cuda_source():
    """kernel.LANES (what the plain order and the tests use) and MAX_STATE
    are the source's LANES and kMaxN."""
    src = ss_kernel.SOURCES[0].read_text()
    assert f"constexpr int LANES = {ss_kernel.LANES};" in src
    assert f"constexpr int kMaxN = {ss_kernel.MAX_STATE};" in src
    assert 32 % ss_kernel.LANES == 0
