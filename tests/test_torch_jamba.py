"""The port's hybrid path (the Mamba block, the MoE FFN, the reduced
jamba TransformerLM and its serving through the Engine) held against the
JAX package on the CPU. Parameters are made by the JAX package's
``init_params`` and carried over by ``convert.params_from_numpy``; inputs
come from numpy seeds. The reference model runs its scan as its default
``ssm_impl="chunked"`` and through the Pallas kernel in interpret mode;
the port's as its default ``"ref"`` (the per-token loop on the CPU) and
as ``"chunked"``."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Frame as JFrame  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Engine as TEngine  # noqa: E402
from repro_torch.serving import Frame as TFrame  # noqa: E402

# f32 logits through the reduced model's 8 layers: 1e-4, the bar the
# reduced qwen2.5-3b and xlstm-1.3b are held to (~6e-6 measured); blocks
# with O(1) outputs are held tighter.
ATOL = 1e-4
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
NAME = "jamba-1.5-large-398b"
# Gates on the same logits: the softmax's exp and sum round differently in
# XLA and in PyTorch on the CPU, then the top-k are renormalised (at most
# 2 ulps apart measured); the decisions themselves are held bitwise.
GATE_ULP = 4


@pytest.fixture(scope="module", autouse=True)
def _exp_warmed():
    """PyTorch 2.13's CPU build returns, in some processes, one thread's
    block of the first parallel ``torch.exp`` at up to 1.5e-4 relative
    error (2 processes in 40 measured; every later call within an ulp): a
    first-use race of its exp kernel, not the port's arithmetic. The
    chunked scan's exp spans threads, so one call runs first here."""
    torch.exp(torch.zeros(1 << 20))


def _cfg(**kw):
    return dataclasses.replace(j_configs.get(NAME).reduced(), **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _block_params(template, seed):
    pj = j_init(template, jax.random.PRNGKey(seed))
    return pj, params_from_numpy(_np(pj), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Initialisers and the full configuration
# ---------------------------------------------------------------------------

def test_s4d_init_is_log_1_to_n_correctly_rounded():
    """A_log = log(1..n) broadcast: the port's is the correctly rounded f32
    log (float64 rounded once) bitwise. XLA's f32 log on the CPU is one ulp
    off at n = 7 (and 47, 49), so the reference's is held within one
    ulp."""
    p_j = j_common.P((3, 32, 16), (j_common.LAYERS, j_common.SSM_INNER,
                                   j_common.SSM_STATE), init="s4d")
    p_t = t_common.P((3, 32, 16), (t_common.LAYERS, t_common.SSM_INNER,
                                   t_common.SSM_STATE), init="s4d")
    want = np.asarray(j_init({"a": p_j}, jax.random.PRNGKey(0))["a"])
    got = t_common.init_params({"a": p_t}, torch.Generator().manual_seed(0),
                               device="cpu")["a"]
    assert got.dtype == torch.float32 and got.is_contiguous()
    exact = np.log(np.arange(1, 17, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(),
                                  np.broadcast_to(exact, (3, 32, 16)))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_s4d_dt_init_is_an_inverse_softplus_in_range():
    p = t_common.P((4096,), (t_common.SSM_INNER,), init="s4d_dt")
    bias = t_common.init_params({"b": p}, torch.Generator().manual_seed(1),
                                device="cpu")["b"]
    dt = torch.nn.functional.softplus(bias.double())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    # log-uniform: log dt spreads evenly over [log 1e-3, log 0.1].
    u = (torch.log(dt) - math.log(1e-3)) / (math.log(0.1) - math.log(1e-3))
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert abs(float(u.std()) - (1 / 12) ** 0.5) < 0.02
    again = t_common.init_params({"b": p}, torch.Generator().manual_seed(1),
                                 device="cpu")["b"]
    assert torch.equal(bias, again)


def test_full_config_builds_the_references_template():
    """jamba-1.5-large-398b at full width and depth (templates only): the
    hybrid period [attn, mamba x7] with MoE on the odd layers, the
    reference's 398,555,111,424 parameters, leaf for leaf."""
    cfg = t_configs.get(NAME)
    m = t_models.build(cfg)
    assert [(s.mixer, s.ffn) for s in m.period] == (
        [("attn", "dense")] + [("mamba", "moe" if i % 2 else "dense")
                               for i in range(1, 8)])
    assert m.n_periods == 9
    assert m.param_count() == 398_555_111_424
    mj = j_build(j_configs.get(NAME))
    leaves_j = jax.tree.leaves(mj.template(), is_leaf=j_common.is_leaf)
    leaves_t = t_common.tree_leaves(m.template())
    assert [tuple(p.shape) for p in leaves_t] == [tuple(p.shape)
                                                 for p in leaves_j]
    assert [p.init for p in leaves_t] == [p.init for p in leaves_j]
    ffn = m.template()["blocks"]["p1"]["ffn"]
    assert tuple(ffn["wi_gate"].shape) == (9, 16, 8192, 24576)
    state = m.cache_template(8, 4096)["blocks"]["p1"]["state"]
    assert tuple(state["h"].shape) == (9, 8, 16384, 16)
    assert tuple(state["conv"].shape) == (9, 8, 3, 16384)
    # The chip's cut: one period, 4 experts.
    cut = t_models.build(dataclasses.replace(cfg, n_layers=8, n_experts=4))
    assert cut.param_count() == 16_246_923_264


# ---------------------------------------------------------------------------
# The Mamba block
# ---------------------------------------------------------------------------

def test_causal_conv_matches_reference():
    x, w, b = _x((2, 9, 24), 0), _x((4, 24), 1), _x((24,), 2)
    want = j_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = t_ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (the reference's ssm_impl, the port's): the port's per-token loop against
# both of the reference's forms, and the port's chunked form against the
# reference's.
SSM_PAIRS = [("chunked", "ref"), ("interpret", "ref"), ("chunked", "chunked")]
SSM_IDS = ["chunked", "interpret", "chunked-port-chunked"]


@pytest.mark.parametrize("ssm_impl,port_impl", SSM_PAIRS, ids=SSM_IDS)
def test_mamba_apply_and_prefill_state_match_reference(ssm_impl, port_impl):
    """The full-sequence block, and the prefill from a non-zero h: output
    and the state written in place (the scan's h_last, the last conv - 1
    rows of the pre-conv input)."""
    cfg = _cfg()
    pj, pt = _block_params(j_ssm.mamba_template(cfg), 3)
    x = _x((2, 11, cfg.d_model), 4)
    want = j_ssm.mamba_apply(pj, jnp.asarray(x), cfg, impl=ssm_impl)
    got = t_ssm.mamba_apply(pt, torch.from_numpy(x), cfg,
                            ssm_impl=port_impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)

    inner = cfg.ssm_expand * cfg.d_model
    st = {"h": _x((2, inner, cfg.ssm_state), 5) * 0.5,
          "conv": _x((2, cfg.ssm_conv - 1, inner), 6)}
    want, wst = j_ssm.mamba_apply(pj, jnp.asarray(x), cfg, impl=ssm_impl,
                                  state=jax.tree.map(jnp.asarray, st))
    state = params_from_numpy(st, "cpu")
    got, gst = t_ssm.mamba_apply(pt, torch.from_numpy(x), cfg,
                                 ssm_impl=port_impl, state=state)
    assert gst is state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **BLOCK_TOL, err_msg=key)


def test_mamba_decode_matches_reference():
    cfg = _cfg()
    pj, pt = _block_params(j_ssm.mamba_template(cfg), 7)
    inner = cfg.ssm_expand * cfg.d_model
    st = {"h": _x((3, inner, cfg.ssm_state), 8) * 0.5,
          "conv": _x((3, cfg.ssm_conv - 1, inner), 9)}
    x = _x((3, 1, cfg.d_model), 10)
    want, wst = j_ssm.mamba_decode(pj, jnp.asarray(x), cfg,
                                   jax.tree.map(jnp.asarray, st))
    state = params_from_numpy(st, "cpu")
    got, gst = t_ssm.mamba_decode(pt, torch.from_numpy(x), cfg, state)
    assert gst is state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **BLOCK_TOL, err_msg=key)


@pytest.mark.parametrize("s", [1, 2, 3, 5])
def test_mamba_prefill_then_decode_continues_the_sequence(s):
    """Prefill of s tokens then one decode step gives the last output of
    the full-sequence block over s + 1 tokens, also for prompts shorter
    than conv - 1 = 3: their conv state keeps the convolution's zero
    padding. The reference keeps only s rows there, and its decode then
    reads a clamped out-of-range tap and misses by O(1) (ROADMAP queue 3);
    from s = 3 on it agrees."""
    cfg = _cfg()
    pj, pt = _block_params(j_ssm.mamba_template(cfg), 11)
    x = _x((2, s + 1, cfg.d_model), 12)
    state = t_common.init_params(t_ssm.mamba_state_template(cfg, 2),
                                 torch.Generator(), device="cpu")
    xt = torch.from_numpy(x)
    t_ssm.mamba_apply(pt, xt[:, :s], cfg, state=state)
    got, _ = t_ssm.mamba_decode(pt, xt[:, s:], cfg, state)
    want = t_ssm.mamba_apply(pt, xt, cfg)[:, -1:]
    torch.testing.assert_close(got, want, **BLOCK_TOL)

    st = j_init(j_ssm.mamba_state_template(cfg, 2), jax.random.PRNGKey(0))
    _, st = j_ssm.mamba_apply(pj, jnp.asarray(x[:, :s]), cfg, state=st)
    ref_got, _ = j_ssm.mamba_decode(pj, jnp.asarray(x[:, s:]), cfg, st)
    miss = float(np.abs(np.asarray(ref_got) - want.numpy()).max())
    if s < cfg.ssm_conv - 1:
        assert st["conv"].shape[1] == s and miss > 0.05
    else:
        assert miss < 1e-5


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _dense(expert, slot, kept, gate, e, capacity):
    """The port's routing as the reference's one-hot dispatch and combine
    [b, s, e, c]: 1 and the gate where a kept choice sits; a dropped
    choice leaves its gate 0 at slot 0."""
    b, s, k = expert.shape
    dispatch = np.zeros((b, s, e, capacity), np.float32)
    combine = np.zeros((b, s, e, capacity), np.float32)
    for bi, si, ki in np.ndindex(b, s, k):
        ei, ci = int(expert[bi, si, ki]), int(slot[bi, si, ki])
        if kept[bi, si, ki]:
            dispatch[bi, si, ei, ci] = 1.0
            combine[bi, si, ei, ci] = gate[bi, si, ki]
    return dispatch, combine


def _exact_router(d, e, rng, favour=None, tie=None, padded=0):
    """x with small integer entries and router weights in multiples of
    1/8: every logit is an exact sum, so both packages see the same
    logits. ``favour`` adds 8 to that expert's logit for every token
    (capacity drops follow), ``tie`` makes two experts' columns equal,
    ``padded`` extra columns would win every token unless masked."""
    w = rng.integers(-4, 5, (d, e + padded)).astype(np.float32) / 8
    if favour is not None:
        w[0, favour] = 2.0
    if tie is not None:
        w[:, tie[1]] = w[:, tie[0]]
    if padded:
        w[:, e:] = 4.0
    return w


def _route_both(x, router, cfg, capacity):
    dj, cj, aj = j_moe._routing({"router": jnp.asarray(router)},
                                jnp.asarray(x), cfg, capacity)
    out = t_moe._routing({"router": torch.from_numpy(router)},
                         torch.from_numpy(x), cfg, capacity)
    expert, slot, kept, gate, at = (t.numpy() for t in out)
    dt, ct = _dense(expert, slot, kept, gate, router.shape[1], capacity)
    return (np.asarray(dj), np.asarray(cj), float(aj)), (dt, ct, float(at)), \
        out


@pytest.mark.parametrize("case", ["tie", "drops", "padded"])
def test_moe_routing_is_the_references_bitwise(case):
    """On the same logits the port's routing decisions equal the
    reference's one-hot dispatch bitwise, and its combine (the gates) to
    GATE_ULP: a planted tie (experts 1 and 2
    equal for every token: the lower index wins), capacity drops (expert
    0 favoured by every token, capacity 5 of 16), padded experts (two
    extra columns that would win every token are masked)."""
    rng = np.random.default_rng({"tie": 0, "drops": 1, "padded": 2}[case])
    cfg = _cfg()
    d, e = 16, cfg.n_experts
    x = rng.integers(-2, 3, (2, 16, d)).astype(np.float32)
    x[..., 0] = 4.0
    router = _exact_router(d, e, rng,
                           favour=0 if case == "drops" else None,
                           tie=(1, 2) if case == "tie" else None,
                           padded=2 if case == "padded" else 0)
    capacity = 5 if case == "drops" else 16
    (dj, cj, aj), (dt, ct, at), (expert, slot, kept, _, _) = _route_both(
        x, router, cfg, capacity)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(ct == 0, cj == 0)
    np.testing.assert_array_max_ulp(ct, cj, maxulp=GATE_ULP)
    assert at == pytest.approx(aj, rel=1e-6)
    if case == "tie":
        pair = expert[..., :2].numpy()
        assert ((pair[..., 0] == 1) & (pair[..., 1] == 2)).any()
        assert not ((pair[..., 0] == 2) & (pair[..., 1] == 1)).any()
    if case == "drops":
        assert int((~kept).sum()) >= 11        # past expert 0's 5 slots
        assert int(slot.max()) >= capacity
    if case == "padded":
        assert int(expert.max()) < e


def test_moe_grouped_routing_is_the_references(monkeypatch):
    """Past MOE_GROUP tokens (and a multiple of it) routing is per group:
    with MOE_GROUP = 8 on both sides, 16 tokens route as 2 groups of 8
    with capacity 5 each, the same decisions bitwise (gates to GATE_ULP)
    and the same output."""
    monkeypatch.setattr(j_moe, "MOE_GROUP", 8)
    monkeypatch.setattr(t_moe, "MOE_GROUP", 8)
    seen = {"j": [], "t": []}
    for key, mod in (("j", j_moe), ("t", t_moe)):
        original = mod._routing

        def recorder(params, x, cfg, capacity, _o=original, _k=key):
            out = _o(params, x, cfg, capacity)
            seen[_k].append((tuple(x.shape), capacity, out))
            return out
        monkeypatch.setattr(mod, "_routing", recorder)
    cfg = _cfg()
    pj, pt = _block_params(j_moe.moe_template(cfg), 13)
    x = _x((1, 16, cfg.d_model), 14)
    yj, aj = j_moe.moe_apply(pj, jnp.asarray(x), cfg)
    yt, at = t_moe.moe_apply(pt, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **BLOCK_TOL)
    assert float(at) == pytest.approx(float(aj), rel=1e-6)
    (shape_j, cap_j, (dj, cj, _)), = seen["j"]
    (shape_t, cap_t, (expert, slot, kept, gate, _)), = seen["t"]
    assert shape_j == shape_t == (2, 8, cfg.d_model) and cap_j == cap_t == 5
    dt, ct = _dense(expert.numpy(), slot.numpy(), kept.numpy(),
                    gate.numpy(), cfg.n_experts, cap_t)
    np.testing.assert_array_equal(dt, np.asarray(dj))
    np.testing.assert_array_max_ulp(ct, np.asarray(cj), maxulp=GATE_ULP)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("decode", [False, True])
def test_moe_apply_matches_reference(decode, shared):
    """moe_apply at the prefill capacity (capacity_factor 1.25: drops) and
    at decode's dropless capacity (n_experts / top_k), with and without a
    shared expert."""
    cfg = _cfg(n_shared_experts=shared)
    pj, pt = _block_params(j_moe.moe_template(cfg), 15 + shared)
    x = _x((3, 1, cfg.d_model) if decode else (2, 24, cfg.d_model), 16)
    cf = cfg.n_experts / cfg.top_k if decode else None
    yj, aj = j_moe.moe_apply(pj, jnp.asarray(x), cfg, capacity_factor=cf)
    yt, at = t_moe.moe_apply(pt, torch.from_numpy(x), cfg,
                             capacity_factor=cf)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **BLOCK_TOL)
    assert float(at) == pytest.approx(float(aj), rel=1e-6)
    assert ("shared" in pt) == bool(shared)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    """The reduced jamba (2 periods of [attn, mamba x3], MoE with 4
    experts on the odd layers, f32): the reference models with each
    ssm_impl, the port's model (its default ssm_impl, "ref") and one
    parameter tree carried across."""
    cfg = _cfg()
    models_j = {impl: j_build(cfg, ssm_impl=impl)
                for impl in ("chunked", "interpret")}
    mt = t_models.build(t_configs.ModelConfig(**dataclasses.asdict(cfg)))
    pj = j_init(models_j["chunked"].template(), jax.random.PRNGKey(0))
    return cfg, models_j, mt, pj, params_from_numpy(_np(pj), "cpu")


@pytest.mark.parametrize("ssm_impl,port_impl", SSM_PAIRS, ids=SSM_IDS)
def test_model_forward_prefill_and_decode_match_reference(reduced, ssm_impl,
                                                          port_impl):
    """Reduced jamba: forward logits and aux, prefill and 8 greedy decode
    steps within ATOL with identical tokens, and the caches after them."""
    cfg, models_j, mt, pj, pt = reduced
    mj = models_j[ssm_impl]
    if port_impl != mt.ssm_impl:
        mt = t_models.build(mt.cfg, ssm_impl=port_impl)
    assert [(s.mixer, s.ffn) for s in mt.period] == [
        ("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe")]
    assert mt.n_periods == 2 and mt.param_count() == mj.param_count()
    toks = np.random.default_rng(17).integers(0, 256, (2, 13)).astype(
        np.int32)
    lj, aj = mj.forward(pj, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        lt, at = mt.forward(pt, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert float(at) > 0
    assert float(at) == pytest.approx(float(aj), rel=1e-5)

    cj = j_init(mj.cache_template(2, 32), jax.random.PRNGKey(0))
    ct = params_from_numpy(_np(cj), "cpu")
    lj, cj = mj.prefill(pj, {"tokens": jnp.asarray(toks)}, cj)
    with torch.no_grad():
        lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(toks)}, ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    tj, tt = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    for i in range(8):
        lj, cj = mj.decode_step(pj, tj, cj)
        with torch.no_grad():
            lt, ct = mt.decode_step(pt, tt, ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   err_msg=str(i))
        np.testing.assert_array_equal(lt.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(lj, -1)))
        tj, tt = jnp.argmax(lj, -1), lt.argmax(-1)
    assert np.array_equal(ct["len"].numpy(), np.asarray(cj["len"]))
    for p in ("p1", "p2", "p3"):
        for key, got in ct["blocks"][p]["state"].items():
            w = np.asarray(cj["blocks"][p]["state"][key])
            np.testing.assert_allclose(got.numpy(), w,
                                       atol=1e-5 * max(1.0, np.abs(w).max()),
                                       err_msg=f"{p} {key}")
    for key in ("k", "v"):
        np.testing.assert_allclose(ct["blocks"]["p0"]["self"][key].numpy(),
                                   np.asarray(cj["blocks"]["p0"]["self"][key]),
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _engines(reduced, n_lanes=3, decode_tokens=6, max_len=48):
    cfg, models_j, mt, pj, pt = reduced
    return (JEngine(models_j["chunked"], pj, n_lanes=n_lanes,
                    max_len=max_len, decode_tokens=decode_tokens),
            TEngine(mt, pt, n_lanes=n_lanes, max_len=max_len,
                    decode_tokens=decode_tokens, device="cpu"))


def test_engine_serves_reduced_jamba_as_reference(reduced):
    """Admits, a preemption and decode ticks through both Engines:
    identical greedy tokens and completions, and the lanes' Mamba
    states."""
    ej, et = _engines(reduced)
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (7, 12, 4)]
    for i, p in enumerate(prompts):
        assert ej.admit(JFrame(i, 0.0, 0.0), p)
        assert et.admit(TFrame(i, 0.0, 0.0), p)
    done_j, done_t = [], []
    for tick in range(9):
        if tick == 2:
            assert ej.preempt_stream(1) == et.preempt_stream(1) == 1
            p = rng.integers(0, 256, 9).astype(np.int32)
            assert ej.admit(JFrame(5, 0.0, 0.0), p)
            assert et.admit(TFrame(5, 0.0, 0.0), p)
        done_j += ej.decode_tick()
        done_t += et.decode_tick()
        assert ([list(l.out) for l in ej.lanes]
                == [list(l.out) for l in et.lanes]), tick
    assert len(done_j) == len(done_t) == 3
    for a, b in zip(done_j, done_t):
        assert a.stream_id == b.stream_id
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for key, got in et.cache["blocks"]["p2"]["state"].items():
        w = np.asarray(ej.cache["blocks"]["p2"]["state"][key])
        np.testing.assert_allclose(got.numpy(), w,
                                   atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=key)


def test_engine_prefill_starts_from_the_zero_state(reduced):
    """The state trap: the prefill writes the single-lane cache in place
    and the scan starts from its h. Prompt B admitted after prompt A must
    give the logits and lane state of B admitted into a fresh engine (the
    reference's prefills always start from zeros)."""
    ej, et = _engines(reduced, n_lanes=2)
    _, fresh = _engines(reduced, n_lanes=2)
    rng = np.random.default_rng(19)
    a = rng.integers(0, 256, 10).astype(np.int32)
    b = rng.integers(0, 256, 6).astype(np.int32)
    et.prefill_lane(a, 0)
    assert float(et._single_cache["blocks"]["p1"]["state"]["h"].abs()
                 .max()) > 0
    got = et.prefill_lane(b, 1)
    want = fresh.prefill_lane(b, 1)
    assert torch.equal(got, want)
    for key, leaf in fresh.cache["blocks"]["p1"]["state"].items():
        assert torch.equal(et.cache["blocks"]["p1"]["state"][key][:, 1],
                           leaf[:, 1]), key
    assert not torch.equal(et.cache["blocks"]["p1"]["state"]["h"][:, 0],
                           et.cache["blocks"]["p1"]["state"]["h"][:, 1])
    # And the reference agrees on B's first token.
    assert ej.admit(JFrame(0, 0.0, 0.0), a) and ej.admit(JFrame(1, 0.0, 0.0),
                                                          b)
    assert ej.lanes[1].out[0] == int(torch.argmax(got))
