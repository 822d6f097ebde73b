"""The port's mLSTM plain versions (``kernels/mlstm``) held against the JAX
package on the CPU: the parallel form against ``mlstm_parallel_ref`` and
the Pallas kernel in interpret mode, the decode step against
``mlstm_step``, and the closed-form prefill state against the reference's
token-by-token scan. Inputs come from numpy seeds."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.kernels.mlstm import kernel as j_kernel  # noqa: E402
from repro.kernels.mlstm import ref as j_ref  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.kernels.mlstm import ops, ref  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

# The kernel's bar in tests/test_kernels.py (Pallas against the jnp
# version): atol 2e-3, rtol 1e-3. Two f32 plain versions with one
# operation order agree closer, but their einsums sum in different orders
# and a row whose signed denominator is small divides that difference up
# (1.5e-5 measured on O(1) outputs): the bar of the reference's
# parallel-vs-recurrent test, 1e-4.
KERNEL_TOL = dict(atol=2e-3, rtol=1e-3)
PLAIN_TOL = dict(atol=1e-4, rtol=0)
# tests/test_kernels.py's sweep: (b, s, h, d, block_q, block_k).
SWEEP = [(2, 128, 2, 64, 64, 64), (1, 256, 4, 128, 128, 128),
         (2, 192, 2, 64, 64, 64)]


def _inputs(b, s, h, d, seed):
    """q, k, v ~ N(0, 1); i ~ N(0, 0.25); f ~ N(2, 1): the reference
    tests' distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    ig = (rng.standard_normal((b, s, h)) * 0.5).astype(np.float32)
    fg = (rng.standard_normal((b, s, h)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _t(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("b,s,h,d,bq,bk", SWEEP)
def test_parallel_matches_reference_and_interpret_kernel(b, s, h, d, bq, bk):
    xs = _inputs(b, s, h, d, seed=s)
    got = ops.mlstm(*_t(xs)).numpy()            # CPU tensors: plain version
    np.testing.assert_array_equal(got, ref.mlstm_parallel_ref(*_t(xs)))
    np.testing.assert_allclose(got, np.asarray(j_ref.mlstm_parallel_ref(
        *_j(xs))), **PLAIN_TOL)
    pallas = j_kernel.mlstm_chunkwise(*_j(xs), block_q=bq, block_k=bk,
                                      interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **KERNEL_TOL)


def test_parallel_bf16_matches_reference():
    """bf16 inputs: computed in f32, written in q's dtype, as the
    reference does; the bar is one bf16 rounding (2^-8 relative) on O(1)
    outputs."""
    xs = _inputs(2, 64, 2, 32, seed=5)
    got = ref.mlstm_parallel_ref(*[t.bfloat16() for t in _t(xs)])
    want = j_ref.mlstm_parallel_ref(*[x.astype(jnp.bfloat16)
                                      for x in _j(xs)])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=1e-2)


def _state(b, h, d, rng):
    C = rng.standard_normal((b, h, d, d)).astype(np.float32) * 0.1
    n = rng.standard_normal((b, h, d)).astype(np.float32) * 0.1
    m = rng.standard_normal((b, h)).astype(np.float32)
    return C, n, m


def test_step_matches_reference_and_updates_in_place():
    rng = np.random.default_rng(3)
    b, h, d = 3, 2, 32
    q, k, v = (rng.standard_normal((b, h, d)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((b, h)).astype(np.float32)
    fg = (rng.standard_normal((b, h)) + 2.0).astype(np.float32)
    C, n, m = _state(b, h, d, rng)
    hj, (Cj, nj, mj) = j_ref.mlstm_step(*_j((q, k, v, ig, fg, C, n, m)))
    Ct, nt, mt = _t((C, n, m))
    ht, (Co, no, mo) = ref.mlstm_step(*_t((q, k, v, ig, fg)), Ct, nt, mt)
    assert Co is Ct and no is nt and mo is mt          # in place
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5,
                               rtol=1e-5)
    for got, want in ((Ct, Cj), (nt, nj), (mt, mj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def test_parallel_equals_recurrent():
    """The port's step loop from the zero state with m = -1e30 against
    its parallel form: test_mlstm_parallel_equals_recurrent's bar."""
    b, s, h, d = 2, 64, 2, 32
    q, k, v, ig, fg = _t(_inputs(b, s, h, d, seed=9))
    want = ref.mlstm_parallel_ref(q, k, v, ig, fg)
    C = torch.zeros((b, h, d, d))
    n = torch.zeros((b, h, d))
    m = torch.full((b, h), -1e30)
    outs = [ref.mlstm_step(q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t],
                           C, n, m)[0] for t in range(s)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want.numpy(),
                               atol=1e-4)
    # The closed-form state equals the state the loop reached.
    for got, loop in zip(ref.mlstm_final_state(k, v, ig, fg), (C, n, m)):
        np.testing.assert_allclose(got.numpy(), loop.numpy(), atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("s", [37, 300])
@pytest.mark.parametrize("hd", [32, 64])
def test_prefill_state_matches_reference_scan(s, hd):
    """mlstm_apply(state=...) writes the closed-form state; the reference
    rebuilds it with a token-by-token lax.scan of mlstm_step
    (_mlstm_state_from_seq) from a cache whose C and n are not zero (its
    start m = -1e30 multiplies them by 0). Bars: m to 1e-6 absolute (the
    two sum the forget gates in different orders, m is O(1); 4.5e-7
    measured at s = 300); C and n to 2e-6 of their largest element (6.8e-7
    measured)."""
    cfg = dataclasses.replace(j_configs.get("xlstm-1.3b").reduced(),
                              d_model=hd, n_heads=2)      # inner/h = hd
    pj = j_init(j_xlstm.mlstm_template(cfg), jax.random.PRNGKey(s))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    rng = np.random.default_rng(s + hd)
    x = rng.standard_normal((2, s, hd)).astype(np.float32)
    C, n, m = _state(2, 2, hd, rng)
    want = j_tr._mlstm_state_from_seq(
        pj, jnp.asarray(x), cfg, {"C": jnp.asarray(C), "n": jnp.asarray(n),
                                  "m": jnp.asarray(m)})
    state = {key: torch.full_like(val, float("nan"))
             for key, val in zip("Cnm", _t((C, n, m)))}
    with torch.no_grad():
        y, got = t_xlstm.mlstm_apply(pt, torch.from_numpy(x), cfg,
                                     state=state)
        y_only = t_xlstm.mlstm_apply(pt, torch.from_numpy(x), cfg)
    assert got is state
    assert torch.equal(y, y_only)
    np.testing.assert_allclose(got["m"].numpy(), np.asarray(want["m"]),
                               atol=1e-6, rtol=0)
    for key in ("C", "n"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w,
                                   atol=2e-6 * np.abs(w).max(), rtol=0)


def test_wrapper_policy_on_the_cpu():
    """CPU tensors take the plain version under both impls and never count
    a launch; an unknown impl and mixed devices raise."""
    xs = _t(_inputs(1, 16, 2, 32, seed=1))
    ops.reset_launches()
    a = ops.mlstm(*xs)
    b = ops.mlstm(*xs, impl="torch")
    assert torch.equal(a, b) and ops.launches["mlstm_chunkwise"] == 0
    with pytest.raises(ValueError, match="impl"):
        ops.mlstm(*xs, impl="cuda")
    for d in (8, 24, 4112):
        with pytest.raises(ValueError, match="head dim"):
            ops.check_head_dim(d)
    ops.check_head_dim(1024)


# ---------------------------------------------------------------------------
# the CUDA kernel's cluster schedule (scores summed over R slices of d)
# ---------------------------------------------------------------------------

from repro_torch.kernels.mlstm import kernel as t_kernel  # noqa: E402


@pytest.mark.parametrize("n_ranks", [1, 2, 4, 8])
def test_cluster_scores_match_reference_and_interpret_kernel(n_ranks):
    """The q.k products summed over R column slices in rank order (what
    every CTA of a cluster adds) against the one-slice plain version, the
    JAX package's mlstm_parallel_ref and its Pallas kernel in interpret
    mode; R = 1 is the plain version bitwise."""
    b, s, h, d = 1, 96, 2, 128
    xs = _inputs(b, s, h, d, seed=31 + n_ranks)
    got = ref.mlstm_cluster_ref(*_t(xs), n_ranks).numpy()
    plain = ref.mlstm_parallel_ref(*_t(xs)).numpy()
    if n_ranks == 1:
        np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, plain, **PLAIN_TOL)
    np.testing.assert_allclose(got, np.asarray(j_ref.mlstm_parallel_ref(
        *_j(xs))), **PLAIN_TOL)
    pallas = j_kernel.mlstm_chunkwise(*_j(xs), block_q=32, block_k=32,
                                      interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **KERNEL_TOL)


def test_cluster_plan_covers_every_head_dim():
    """For every head dim the wrapper takes: R <= 8 slices of DV columns
    (a multiple of 16, at most 512) cover d with no empty slice; one CTA up
    to d = 256, 4 x 256 at xlstm-1.3b's d = 1024, 8 x 512 at d = 4096."""
    for d in range(16, 4097, 16):
        n_ranks, dv = t_kernel.cluster_plan(d)
        assert 1 <= n_ranks <= t_kernel.MAX_CLUSTER
        assert dv % 16 == 0 and dv <= t_kernel.MAX_DV
        assert n_ranks * dv >= d > (n_ranks - 1) * dv
        assert n_ranks == 1 or d > t_kernel.SLICE
    assert t_kernel.cluster_plan(256) == (1, 256)
    assert t_kernel.cluster_plan(1024) == (4, 256)
    assert t_kernel.cluster_plan(2048) == (8, 256)
    assert t_kernel.cluster_plan(4096) == (8, 512)
    assert [t_kernel.slice_width(256, r) for r in (1, 2, 4, 8)] == [
        256, 128, 64, 32]


# ---------------------------------------------------------------------------
# mlstm_chunkwise_xla: the reference's mlstm_impl="chunkwise"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(256, 64), (256, 128), (384, 64),
                                     (200, 64), (64, 64), (32, 64)])
def test_chunkwise_xla_matches_reference(s, chunk):
    """Two chunk sizes; a sequence that is no multiple of the chunk (a
    ragged last chunk), or no longer than one chunk, takes the parallel
    form in both packages."""
    xs = _inputs(2, s, 2, 32, seed=s + chunk)
    got = ref.mlstm_chunkwise_xla(*_t(xs), chunk=chunk)
    want = np.asarray(j_ref.mlstm_chunkwise_xla(*_j(xs), chunk=chunk))
    np.testing.assert_allclose(got.numpy(), want, **PLAIN_TOL)
    # Chunked or not, the function is the parallel form's.
    np.testing.assert_allclose(got, ref.mlstm_parallel_ref(*_t(xs)),
                               **PLAIN_TOL)
    if s % chunk or s <= chunk:
        assert torch.equal(got, ref.mlstm_parallel_ref(*_t(xs)))


def test_chunkwise_xla_bf16_and_gradients():
    """bf16 inputs come back in bf16; the function is differentiable and
    its gradients are the parallel form's, each leaf within 1e-4 x its max
    |g| + 1e-6 (test_torch_train_grads.py's bar: the gates' gradients
    pass through the clamped denominator, summed in another order)."""
    xs = _inputs(1, 128, 2, 32, seed=3)
    out = ref.mlstm_chunkwise_xla(*[t.bfloat16() for t in _t(xs)], chunk=32)
    assert out.dtype == torch.bfloat16
    grads = []
    for fn in (lambda *a: ref.mlstm_chunkwise_xla(*a, chunk=32),
               ref.mlstm_parallel_ref):
        ts = [t.requires_grad_(True) for t in _t(xs)]
        fn(*ts).square().sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        bar = 1e-4 * float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= bar


def test_model_chunkwise_matches_reference():
    """xlstm-1.3b at reduced() with mlstm_impl="chunkwise" (chunks of
    512, two of them at s = 1,024) against the JAX package's model with
    the same argument."""
    cj = dataclasses.replace(j_configs.get("xlstm-1.3b").reduced(),
                             n_layers=2, slstm_period=2)
    ct = dataclasses.replace(t_configs.get("xlstm-1.3b").reduced(),
                             n_layers=2, slstm_period=2)
    mj = j_build(cj, mlstm_impl="chunkwise")
    mt = t_models.build(ct, mlstm_impl="chunkwise")
    pj = jax.jit(lambda k: j_init(mj.template(), k))(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cj.vocab, (1, 1024),
                                             dtype=np.int32)
    want, _ = jax.jit(mj.forward)(pj, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = mt.forward(params_from_numpy(jax.tree.map(np.asarray, pj),
                                              "cpu"),
                            {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PLAIN_TOL)
    with pytest.raises(ValueError, match="mlstm_impl"):
        t_models.build(ct, mlstm_impl="interpret")
