"""The port's optimizer, gradient compression, train and eval steps and
training launcher held against the JAX package on the CPU.

Bars: AdamW's parameters and moments within 2e-6 relative (+1e-7) of the
JAX package's after 3 steps (two f32 computations of one formula, which
may differ by an ulp in ``pow``, ``cos`` or ``sqrt``), bf16 leaves within
one bf16 ulp; the int8 codes and scales bitwise; the train step (1 and 4
microbatches, reduced qwen2.5-3b) loss within 1e-5 relative and
parameters within atol 2e-5 (tests/test_training.py's microbatch bars);
the eval step's loss within 1e-5 relative. Parameters are made by the JAX
package's ``init_params`` and carried over by
``convert.params_from_numpy``; other inputs come from numpy seeds."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.training import compression as j_comp  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import train_step as j_ts  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import compression as t_comp  # noqa: E402
from repro_torch.training import optimizer as t_opt  # noqa: E402
from repro_torch.training import train_step as t_ts  # noqa: E402

OPT_TOL = dict(rtol=2e-6, atol=1e-7)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-7)      # one bf16 ulp
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _t2np(tree):
    return [t.detach().float().numpy() for t in tree_leaves(tree)]


def _close(j_tree, t_tree, **tol):
    jl = jax.tree.leaves(_np(j_tree))
    tl = _t2np(t_tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, **tol)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_case(param_dtype, seed=0, grad_scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 2, 4)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: (rng.standard_normal(s) * grad_scale
                                     ).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
             for _ in range(3)]
    jdt = jnp.dtype(param_dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = params_from_numpy(params, "cpu", dtype=tdt)
    return jp, tp, grads


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule,warmup", [("cosine", 2), ("constant", 2),
                                             ("cosine", 0)])
@pytest.mark.parametrize("grad_scale,clip", [(1.0, 1.0), (1e-3, 1.0),
                                             (1.0, 0.0)])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_three_steps_match_reference(state_dtype, schedule, warmup,
                                           grad_scale, clip, weight_decay):
    kw = dict(lr=1e-2, state_dtype=state_dtype, schedule=schedule,
              warmup_steps=warmup, total_steps=5, grad_clip=clip,
              weight_decay=weight_decay)
    jcfg, tcfg = j_opt.AdamWConfig(**kw), t_opt.AdamWConfig(**kw)
    jp, tp, grads = _opt_case("float32", grad_scale=grad_scale)
    js, ts = j_opt.init(jp, jcfg), t_opt.init(tp, tcfg)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    assert tree_leaves(ts["m"])[0].dtype == {
        "float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    for g in grads:
        jp, js, jm = j_opt.update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = t_opt.update(tp, params_from_numpy(g, "cpu"), ts, tcfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       **OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    _close(jp, tp, **OPT_TOL)
    tol = OPT_TOL if state_dtype == "float32" else BF16_TOL
    _close(js["m"], ts["m"], **tol)
    _close(js["v"], ts["v"], **tol)


def test_adamw_bf16_parameters_match_reference():
    """bf16 parameters, f32 state: the update in f32, the result cast back
    to bf16 (the full configs' layout)."""
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4)
    jcfg, tcfg = j_opt.AdamWConfig(**kw), t_opt.AdamWConfig(**kw)
    jp, tp, grads = _opt_case("bfloat16", seed=1)
    js, ts = j_opt.init(jp, jcfg), t_opt.init(tp, tcfg)
    for g in grads:
        jp, js, _ = j_opt.update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, _ = t_opt.update(tp, params_from_numpy(g, "cpu"), ts, tcfg)
    assert tree_leaves(tp)[0].dtype == torch.bfloat16
    _close(jp, tp, **BF16_TOL)
    _close(js["m"], ts["m"], **OPT_TOL)


@pytest.mark.parametrize("chunk", [1 << 26, 7])
def test_adamw_donate_writes_in_place(chunk, monkeypatch):
    """The in-place update equals the functional one bitwise, whether a
    leaf is updated whole or in slices."""
    monkeypatch.setattr(t_opt, "DONATE_CHUNK", chunk)
    cfg = t_opt.AdamWConfig(lr=1e-2, warmup_steps=0)
    _, tp, grads = _opt_case("float32", seed=2)
    ts = t_opt.init(tp, cfg)
    g = params_from_numpy(grads[0], "cpu")
    want_p, want_s, _ = t_opt.update(tp, g, ts, cfg)
    ids = [id(t) for t in tree_leaves(tp)]
    got_p, got_s, _ = t_opt.update(tp, g, ts, cfg, donate=True)
    assert [id(t) for t in tree_leaves(got_p)] == ids
    for a, b in zip(tree_leaves({"p": want_p, "s": want_s}),
                    tree_leaves({"p": got_p, "s": got_s})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("warmup", [0, 1, 100])
def test_lr_at_matches_reference(schedule, warmup):
    kw = dict(lr=3e-4, schedule=schedule, warmup_steps=warmup,
              total_steps=1000)
    for step in (0, 1, 7, 99, 100, 101, 500, 999, 1000, 5000):
        want = float(j_opt.lr_at(j_opt.AdamWConfig(**kw),
                                 jnp.asarray(step, jnp.int32)))
        got = t_opt.lr_at(t_opt.AdamWConfig(**kw),
                          torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **OPT_TOL)


def test_global_norm_matches_reference():
    _, _, grads = _opt_case("float32", seed=3)
    np.testing.assert_allclose(
        float(t_opt.global_norm(params_from_numpy(grads[0], "cpu"))),
        float(j_opt.global_norm(jax.tree.map(jnp.asarray, grads[0]))),
        **OPT_TOL)


def test_adamw_minimizes_quadratic():
    """tests/test_training.py's test, on the port."""
    cfg = t_opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            schedule="constant", grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = t_opt.init(params, cfg)
    for _ in range(300):
        g = {"w": 2.0 * params["w"]}
        params, state, _ = t_opt.update(params, g, state, cfg)
    assert float(torch.max(torch.abs(params["w"]))) < 1e-2


def test_grad_clip_bounds_update():
    """tests/test_training.py's test, on the port."""
    cfg = t_opt.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0,
                            schedule="constant", weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = t_opt.init(params, cfg)
    g = {"w": torch.full((4,), 1e6)}
    _, state2, metrics = t_opt.update(params, g, state, cfg)
    assert float(metrics["grad_norm"]) > 1e5
    # m after one step is (1-b1)*clipped_g; clipped norm == 1.
    m_norm = float(torch.linalg.norm(state2["m"]["w"])) / (1 - cfg.b1)
    assert m_norm == pytest.approx(1.0, rel=1e-3)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def _comp_input(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, rng.uniform(0.1, 10), size=n).astype(np.float32)
    # Exact halves of a step (ties of the rounding), zeros and one
    # all-zero block.
    x[:5] = [0.5, -1.5, 2.5, 0.0, -0.0]
    return x


@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("n,seed", [(300, 0), (256, 1), (1000, 2), (7, 3)])
def test_quantize_codes_are_the_references_bitwise(block, n, seed):
    x = _comp_input(n, seed)
    qj, sj, pj = j_comp.quantize(jnp.asarray(x), block)
    qt, st, pt = t_comp.quantize(torch.from_numpy(x), block)
    assert pt == pj and qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        t_comp.roundtrip(torch.from_numpy(x), block).numpy(),
        np.asarray(j_comp.roundtrip(jnp.asarray(x), block)))


def test_quantize_rounds_half_to_even():
    """Codes on exact halves: 127 * [0.5, 1.5, 2.5] / 127 in one block
    whose max is 127 (scale 1)."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q, s, _ = t_comp.quantize(x, block=6)
    assert float(s) == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


def test_compress_grads_tree_matches_reference():
    rng = np.random.default_rng(4)
    g = {"a": rng.standard_normal((9, 31)).astype(np.float32),
         "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    want = j_comp.compress_grads(jax.tree.map(jnp.asarray, g), ("data",))
    got = t_comp.compress_grads(params_from_numpy(g, "cpu"), ("data",))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert b.shape == a.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_quantization_error_bound():
    """tests/test_training.py's bound on the port: |x - dq(q(x))| <=
    scale / 2 = max|block| / 254."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(st.integers(0, 1000), st.sampled_from([64, 256]))
    def inner(seed, block):
        rng = np.random.default_rng(seed)
        x = rng.normal(0, rng.uniform(0.1, 10), size=300).astype(np.float32)
        y = t_comp.roundtrip(torch.from_numpy(x), block=block).numpy()
        err = np.abs(y - x)
        pad = (-len(x)) % block
        bl = np.pad(x, (0, pad)).reshape(-1, block)
        scale = np.abs(bl).max(1, keepdims=True) / 127.0
        bound = np.repeat(scale / 2 + 1e-7, block, 1).reshape(-1)[:len(x)]
        assert (err <= bound + 1e-6).all()
    inner()


# ---------------------------------------------------------------------------
# Train and eval steps, the launcher
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _qwen(seed=0):
    cj = j_configs.get("qwen2.5-3b").reduced()
    ct = t_configs.get("qwen2.5-3b").reduced()
    mj, mt = j_build(cj), t_models.build(ct, impl="torch")
    pj = jax.jit(lambda k: j_init(mj.template(), k))(
        jax.random.PRNGKey(seed))
    return cj, mj, mt, pj


def _tokens(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _step_pair(n_micro, compression=False):
    cj, mj, mt, pj = _qwen()
    kw = dict(lr=1e-3)
    jcfg, tcfg = j_opt.AdamWConfig(**kw), t_opt.AdamWConfig(**kw)
    batch = _tokens(cj.vocab, 4, 32, 5)
    dp = ("data",) if compression else None
    jstep = jax.jit(j_ts.make_train_step(mj, jcfg, n_micro,
                                         compression=compression,
                                         dp_axes=dp))
    jp, js, jm = jstep(pj, j_opt.init(pj, jcfg),
                       jax.tree.map(jnp.asarray, batch))
    tp0 = params_from_numpy(_np(pj), "cpu")
    tstep = t_ts.make_train_step(mt, tcfg, n_micro, compression=compression,
                                 dp_axes=dp)
    tp, ts, tm = tstep(tp0, t_opt.init(tp0, tcfg),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    return (jp, js, jm), (tp, ts, tm)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_train_step_matches_reference(n_micro):
    (jp, js, jm), (tp, ts, tm) = _step_pair(n_micro)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _close(jp, tp, atol=PARAM_ATOL, rtol=0)
    assert int(ts["step"]) == 1


def test_train_step_with_compression_matches_reference():
    (jp, _, jm), (tp, _, tm) = _step_pair(1, compression=True)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    _close(jp, tp, atol=PARAM_ATOL, rtol=0)


def test_microbatch_accumulation_matches_full_batch():
    """tests/test_training.py's test on the port (loss rel 1e-4,
    parameters atol 2e-5)."""
    _, _, mt, pj = _qwen()
    cfg = t_opt.AdamWConfig(lr=1e-3)
    batch = {k: torch.from_numpy(v)
             for k, v in _tokens(200, 4, 32, 6).items()}
    outs = []
    for n in (1, 4):
        p0 = params_from_numpy(_np(pj), "cpu")
        outs.append(t_ts.make_train_step(mt, cfg, n)(
            p0, t_opt.init(p0, cfg), batch))
    (p1, _, m1), (p4, _, m4) = outs
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


def test_train_step_pre_constrain_and_donate():
    """``pre_constrain`` runs once per step, gradients at its output;
    ``donate`` returns the given trees updated in place, equal to the
    undonated step."""
    _, _, mt, pj = _qwen()
    cfg = t_opt.AdamWConfig(lr=1e-3)
    batch = {k: torch.from_numpy(v)
             for k, v in _tokens(200, 4, 16, 7).items()}
    calls = []

    def pre(p):
        calls.append(1)
        return p
    p0 = params_from_numpy(_np(pj), "cpu")
    want_p, _, want_m = t_ts.make_train_step(mt, cfg, 2, pre_constrain=pre)(
        p0, t_opt.init(p0, cfg), batch)
    assert len(calls) == 1
    p1 = params_from_numpy(_np(pj), "cpu")
    ids = [id(t) for t in tree_leaves(p1)]
    got_p, _, got_m = t_ts.make_train_step(mt, cfg, 2, donate=True)(
        p1, t_opt.init(p1, cfg), batch)
    assert [id(t) for t in tree_leaves(got_p)] == ids
    assert float(got_m["loss"]) == float(want_m["loss"])
    for a, b in zip(tree_leaves(want_p), tree_leaves(got_p)):
        assert torch.equal(a, b)


def test_split_microbatches_shapes():
    out = t_ts.split_microbatches({"tokens": torch.zeros((8, 16))}, 4)
    assert out["tokens"].shape == (4, 2, 16)
    out = t_ts.split_microbatches({"tokens": np.zeros((6, 3))}, 3)
    assert out["tokens"].shape == (3, 2, 3)


def test_eval_step_matches_reference():
    cj, mj, mt, pj = _qwen()
    batch = _tokens(cj.vocab, 2, 24, 8)
    want = float(j_ts.make_eval_step(mj)(pj, jax.tree.map(jnp.asarray,
                                                          batch)))
    tp = params_from_numpy(_np(pj), "cpu")
    got = t_ts.make_eval_step(t_models.build(
        t_configs.get("qwen2.5-3b").reduced()))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def test_launcher_loss_decreases_end_to_end():
    """tests/test_training.py's end-to-end bar on the port: the reduced
    model's loss falls by 0.1 over 30 steps."""
    cfg = t_configs.get("qwen2.5-3b").reduced()
    out = t_train.run(cfg, steps=30, batch=4, seq=64, log_every=0,
                      device="cpu")
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.1, (first, last)
    assert len(out["step_s"]) == 30 and np.all(np.isfinite(out["grad_norms"]))
    assert out["straggler"].count == 30


def test_launcher_main_on_the_cpu(capsys):
    out = t_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                        "--batch", "2", "--seq", "16", "--arch",
                        "qwen2.5-3b"])
    assert len(out["losses"]) == 3
    assert "final loss" in capsys.readouterr().out
    assert tree_leaves(out["params"])[0].device.type == "cpu"


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_launcher_feeds_the_stubs(arch):
    """The VLM and the encoder-decoder train on the pipeline's stub
    embeddings."""
    cfg = t_configs.get(arch).reduced()
    out = t_train.run(cfg, steps=2, batch=2, seq=8, log_every=0,
                      device="cpu")
    assert np.all(np.isfinite(out["losses"]))


def test_launcher_bf16_parameters_f32_state():
    """A config in bf16 initialises bf16 parameters and keeps f32 AdamW
    moments, as the full configs do."""
    cfg = dataclasses.replace(t_configs.get("qwen2.5-3b").reduced(),
                              dtype="bfloat16", remat="full")
    out = t_train.run(cfg, steps=2, batch=2, seq=8, log_every=0,
                      device="cpu")
    assert {t.dtype for t in tree_leaves(out["params"])} == {torch.bfloat16}
    assert {t.dtype for t in tree_leaves(out["opt_state"]["m"])} == {
        torch.float32}
    assert np.all(np.isfinite(out["losses"]))
