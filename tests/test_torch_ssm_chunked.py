"""The port's chunked Mamba scan (``selective_scan_chunked``) and its
``ssm_impl`` argument, held against the JAX package on the CPU.

The scan against the JAX package's ``selective_scan_chunked`` at
tests/test_kernels.py's sweep shapes and chunks, with h0, with bf16
inputs and where the chunk does not divide the sequence (both fall back
to one associative form over the whole sequence), and against the port's
own per-token loop; its gradients against ``jax.grad`` of the JAX
package's; ``ssm_impl``'s refusals; ``plan_cell``'s default per kind;
and one reduced jamba ``launch.train.run`` of two steps against the JAX
package's trainer from the same parameters.
"""
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
from repro.kernels.selective_scan import ref as j_ref  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch import token_loop  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels.selective_scan import ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch.specs import plan_cell  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

# tests/test_kernels.py's bar for the reference's own scans (atol 1e-4):
# f32 sums in another order over O(1) outputs. Measured over the sweep:
# y 5.7e-6, h_last 4.8e-7 against the JAX package's chunked scan (the
# same pairs combined in the same order; XLA's and PyTorch's exp and
# einsum round apart), y 7.6e-6 and h_last 7.2e-7 against the port's
# per-token loop.
ATOL = 1e-4
# (b, s, inner, n, chunk): tests/test_kernels.py's sweep.
SWEEP = [(2, 128, 64, 16, 64), (1, 256, 128, 16, 128), (2, 96, 32, 8, 32)]
# Gradients of sum(y * wy) + sum(h_last * wh) at (2, 64, 16, 4), chunk 16,
# against jax.grad: each leaf within 1e-5 x its largest |g| (measured
# 2.7e-7 of it at most, A's: the backward passes sum the chunks' and the
# channels' contributions in other orders).
GRAD_RTOL = 1e-5
NAME = "jamba-1.5-large-398b"


@pytest.fixture(scope="module", autouse=True)
def _exp_warmed():
    """PyTorch 2.13's CPU build returns, in some processes, one thread's
    block of the first parallel ``torch.exp`` at up to 1.5e-4 relative
    error (2 processes in 40 measured; every later call within an ulp): a
    first-use race of its exp kernel, not the port's arithmetic. The
    chunked scan's exp spans threads, so one call runs first here."""
    torch.exp(torch.zeros(1 << 20))


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
    h = (rng.standard_normal((b, inner, n)) * 0.5).astype(f) if h0 else None
    return [x, dt, A, B, C, D, h]


def _torch(arrays, dtype=None):
    out = [None if a is None else torch.from_numpy(a) for a in arrays]
    if dtype is not None:          # x, dt, B and C in dtype, as the models
        for i in (0, 1, 3, 4):
            out[i] = out[i].to(dtype)
    return out


def _jax(arrays, dtype=None):
    out = [None if a is None else jnp.asarray(a) for a in arrays]
    if dtype is not None:
        for i in (0, 1, 3, 4):
            out[i] = out[i].astype(dtype)
    return out


def _close(got, want, err_msg=""):
    y, h = got
    yj, hj = want
    assert y.dtype == {jnp.float32: torch.float32,
                       jnp.bfloat16: torch.bfloat16}[yj.dtype.type]
    assert h.dtype == torch.float32 and y.shape == yj.shape
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yj.astype(jnp.float32)),
                               atol=ATOL, err_msg=err_msg + " y")
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL,
                               err_msg=err_msg + " h_last")


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("b,s,inner,n,chunk", SWEEP)
def test_chunked_scan_matches_reference(b, s, inner, n, chunk, h0):
    arrays = _inputs(b, s, inner, n, seed=s, h0=h0)
    got = ref.selective_scan_chunked(*_torch(arrays), chunk=chunk)
    _close(got, j_ref.selective_scan_chunked(*_jax(arrays), chunk=chunk))
    # The port's per-token loop computes the same function.
    y, h = ref.selective_scan_ref(*_torch(arrays))
    np.testing.assert_allclose(got[0].numpy(), y.numpy(), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), h.numpy(), atol=ATOL)


@pytest.mark.parametrize("s,chunk", [(37, 16), (5, 256), (1, 256)])
def test_chunked_scan_undivided_falls_back_to_one_associative_form(s,
                                                                    chunk):
    """Where chunk does not divide s, both packages run the associative
    form over the whole sequence (the JAX package's
    ``selective_scan_ref``), h0 included."""
    arrays = _inputs(2, s, 16, 4, seed=7, h0=True)
    got = ref.selective_scan_chunked(*_torch(arrays), chunk=chunk)
    _close(got, j_ref.selective_scan_chunked(*_jax(arrays), chunk=chunk))
    _close(got, j_ref.selective_scan_ref(*_jax(arrays)))
    seen = []
    with torch.no_grad(), token_loop.hooked(
            lambda n, step: seen.append(n) or [step(t) for t in range(n)]):
        ref.selective_scan_chunked(*_torch(arrays), chunk=chunk)
    assert seen == []


@pytest.mark.parametrize("h0", [False, True])
def test_chunked_scan_bf16_inputs(h0):
    """bf16 x, dt, B, C: the scan in f32, y rounded to bf16 once (within
    one bf16 rounding of |y| on top of the f32 bar), h_last f32."""
    arrays = _inputs(2, 128, 32, 8, seed=3, h0=h0)
    y, h = ref.selective_scan_chunked(*_torch(arrays, torch.bfloat16),
                                      chunk=32)
    yj, hj = j_ref.selective_scan_chunked(*_jax(arrays, jnp.bfloat16),
                                          chunk=32)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want = np.asarray(yj.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want,
                               atol=ATOL + 2.0 ** -8 * np.abs(want).max())
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL)


@pytest.mark.parametrize("n_elems", list(range(1, 12)) + [64, 100])
def test_associative_scan_is_the_references_recursion(n_elems):
    """``associative_scan`` against ``jax.lax.associative_scan`` of the
    JAX package's combine, odd and even lengths, and against the
    sequential scan."""
    rng = np.random.default_rng(n_elems)
    a = rng.uniform(0.5, 1.0, (2, n_elems, 3)).astype(np.float32)
    b = rng.standard_normal((2, n_elems, 3)).astype(np.float32)
    got = ref.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = jax.lax.associative_scan(j_ref._scan_combine,
                                    (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    ha, hb = np.ones_like(a[:, 0]), np.zeros_like(b[:, 0])
    for t in range(n_elems):
        ha, hb = ha * a[:, t], a[:, t] * hb + b[:, t]
    np.testing.assert_allclose(got[0][:, -1].numpy(), ha, rtol=1e-5)
    np.testing.assert_allclose(got[1][:, -1].numpy(), hb, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("h0", [False, True])
def test_chunked_scan_gradients_match_jax_grad(h0):
    b, s, inner, n, chunk = 2, 64, 16, 4, 16
    arrays = _inputs(b, s, inner, n, seed=11, h0=True)
    rng = np.random.default_rng(12)
    wy = rng.standard_normal((b, s, inner)).astype(np.float32)
    wh = rng.standard_normal((b, inner, n)).astype(np.float32)
    names = ["x", "dt", "A", "B", "C", "D"] + (["h0"] if h0 else [])
    ops = arrays[:len(names)]

    def j_loss(*o):
        y, h = j_ref.selective_scan_chunked(*o, *(None,) * (7 - len(o)),
                                            chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)
    want = jax.grad(j_loss, argnums=tuple(range(len(ops))))(
        *map(jnp.asarray, ops))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ops]
    y, h = ref.selective_scan_chunked(*leaves, *(None,) * (7 - len(ops)),
                                      chunk=chunk)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(h * torch.from_numpy(wh))).backward()
    for name, t, w in zip(names, leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# ssm_impl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", ["pallas", "interpret", "auto"])
def test_kernel_values_of_ssm_impl_are_refused(bad):
    """The JAX package's kernel values (and anything else outside
    ``SSM_IMPLS``) raise ValueError at every entry that takes it."""
    cfg = t_configs.get(NAME).reduced()
    assert t_models.registry.SSM_IMPLS == ("ref", "chunked")
    with pytest.raises(ValueError, match="ssm_impl"):
        t_models.build(cfg, ssm_impl=bad)
    with pytest.raises(ValueError, match="ssm_impl"):
        t_models.TransformerLM(cfg, ssm_impl=bad)
    model = t_models.build(cfg)
    params = t_models.common.init_params(
        model.template(), torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(1, 4, cfg.d_model)
    layer = t_tf._period(params["blocks"], 0)["p1"]
    with pytest.raises(ValueError, match="ssm_impl"):
        t_ssm.mamba_apply(layer["mixer"], x, cfg, ssm_impl=bad)
    with pytest.raises(ValueError, match="ssm_impl"):
        t_tf.block_apply(layer, x, cfg, model.period[1], ssm_impl=bad)
    with pytest.raises(ValueError, match="ssm_impl"):
        t_tf.stack_apply(params["blocks"], x, cfg, model.period,
                         ssm_impl=bad)
    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        with pytest.raises(ValueError, match="ssm_impl"):
            plan_cell(cfg, InputShape("t", 8, 2, "train"), mesh,
                      ssm_impl=bad)


def test_chunked_impl_runs_the_chunked_scan_whatever_impl(monkeypatch):
    """Under ssm_impl="chunked" every Mamba layer's scan is
    ``selective_scan_chunked``, for impl "auto" and "torch"; under "ref"
    the ``selective_scan`` wrapper."""
    cfg = t_configs.get(NAME).reduced()
    calls = []
    real_chunked, real_wrapper = t_ssm.selective_scan_chunked, \
        t_ssm.selective_scan
    monkeypatch.setattr(t_ssm, "selective_scan_chunked",
                        lambda *a, **k: calls.append("chunked")
                        or real_chunked(*a, **k))
    monkeypatch.setattr(t_ssm, "selective_scan",
                        lambda *a, **k: calls.append(k["impl"])
                        or real_wrapper(*a, **k))
    tokens = torch.zeros(1, 5, dtype=torch.int64)
    params = None
    for impl in ("auto", "torch"):
        for ssm_impl in ("ref", "chunked"):
            model = t_models.build(cfg, impl=impl, ssm_impl=ssm_impl)
            if params is None:
                params = t_models.common.init_params(
                    model.template(), torch.Generator().manual_seed(0),
                    device="cpu")
            calls.clear()
            with torch.no_grad():
                model.forward(params, {"tokens": tokens})
            want = "chunked" if ssm_impl == "chunked" else impl
            assert calls == [want] * 6, (impl, ssm_impl)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_plan_cell_resolves_ssm_impl_per_kind(kind, monkeypatch):
    """``ssm_impl=None`` is "chunked" for a train plan and "ref" for
    prefill and decode (whose Mamba scan is the kernel on the card); an
    explicit value wins; the dry run counts every kind through the
    chunked scan."""
    cfg = t_configs.get(NAME).reduced()
    shape = InputShape("t", 16, 2, kind)
    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        plan = plan_cell(cfg, shape, mesh)
        assert plan.model.ssm_impl == ("chunked" if kind == "train"
                                       else "ref")
        other = {"ref": "chunked", "chunked": "ref"}[plan.model.ssm_impl]
        assert plan_cell(cfg, shape, mesh,
                         ssm_impl=other).model.ssm_impl == other
    seen = []
    real = dryrun.plan_cell

    def spy(*a, **k):
        p = real(*a, **k)
        seen.append(p.model.ssm_impl)
        return p
    monkeypatch.setattr(dryrun, "plan_cell", spy)
    dryrun.measure_cell(cfg, shape, Mesh(("data", "model"), (1, 1)),
                        skip_extrapolation=True)
    assert seen == ["chunked"]


def test_trainer_steps_reduced_jamba_as_the_reference(monkeypatch):
    """Two steps of ``launch.train.run`` on reduced jamba (the chunked
    scan: 16 tokens < 256, so one associative form a layer in both) from
    the JAX package's initial parameters against its ``launch.train.run``:
    losses within 1e-5 relative, parameters within atol 2e-5 (the bars of
    tests/test_torch_training.py)."""
    kw = dict(steps=2, batch=2, seq=16, log_every=0, lr=1e-3)
    cfg_j = j_configs.get(NAME).reduced()
    pj = j_init(j_build(cfg_j).template(), jax.random.PRNGKey(0),
                jnp.dtype(cfg_j.dtype))
    start = jax.tree.map(np.asarray, pj)
    want = j_train.run(cfg_j, **kw)
    cfg_t = t_configs.ModelConfig(**dataclasses.asdict(cfg_j))
    monkeypatch.setattr(t_train, "init_params",
                        lambda tmpl, gen, dtype, device:
                        params_from_numpy(start, device))
    got = t_train.run(cfg_t, device="cpu", **kw)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for a, b in zip(tree_leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=0)
