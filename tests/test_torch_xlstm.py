"""The port's xLSTM (sLSTM cell and blocks, the mLSTM block, the reduced
xlstm-1.3b TransformerLM and its serving through the Engine) held against
the JAX package on the CPU. Parameters are made by the JAX package's
``init_params`` and carried over by ``convert.params_from_numpy``; inputs
come from numpy seeds. The reference model runs its mLSTM prefill through
the Pallas kernel in interpret mode (``mlstm_impl="interpret"``)."""
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
from repro.models import build as j_build  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Frame as JFrame  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Engine as TEngine  # noqa: E402
from repro_torch.serving import Frame as TFrame  # noqa: E402

# f32 logits through the reduced model's 4 layers: 1e-4, the bar the
# reduced qwen2.5-3b is held to (5e-6 measured); blocks and cells are held
# tighter where their outputs are O(1).
ATOL = 1e-4
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)


def _cfg(**kw):
    return dataclasses.replace(j_configs.get("xlstm-1.3b").reduced(), **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _slstm_state(b, h, hd, rng):
    st = {key: (rng.standard_normal((b, h, hd)) * 0.5).astype(np.float32)
          for key in ("c", "h")}
    st["n"] = rng.uniform(0.5, 2.0, (b, h, hd)).astype(np.float32)
    st["m"] = rng.standard_normal((b, h)).astype(np.float32)
    return st


def _block_params(template, seed):
    pj = j_init(template, jax.random.PRNGKey(seed))
    return pj, params_from_numpy(_np(pj), "cpu")


def test_slstm_cell_matches_reference():
    cfg = _cfg()
    pj, pt = _block_params(j_xlstm.slstm_template(cfg), 0)
    rng = np.random.default_rng(0)
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    xt = rng.standard_normal((3, 4, h, hd)).astype(np.float32)
    st = _slstm_state(3, h, hd, rng)
    hj, nj = j_xlstm._slstm_cell(pj, jnp.asarray(xt),
                                 jax.tree.map(jnp.asarray, st))
    ht, nt = t_xlstm._slstm_cell(pt, torch.from_numpy(xt),
                                 params_from_numpy(st, "cpu"))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **BLOCK_TOL)
    for key in ("c", "n", "h", "m"):
        np.testing.assert_allclose(nt[key].numpy(), np.asarray(nj[key]),
                                   **BLOCK_TOL, err_msg=key)


@pytest.mark.parametrize("from_state", [False, True])
def test_slstm_apply_matches_reference(from_state):
    """The full-sequence sLSTM block, from zeros or from a non-zero state
    (the prefill's start from the cache), which it then overwrites."""
    cfg = _cfg()
    pj, pt = _block_params(j_xlstm.slstm_template(cfg), 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    if not from_state:
        want = j_xlstm.slstm_apply(pj, jnp.asarray(x), cfg)
        got = t_xlstm.slstm_apply(pt, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **BLOCK_TOL)
        return
    st = _slstm_state(2, cfg.n_heads, cfg.d_model // cfg.n_heads, rng)
    want, wst = j_xlstm.slstm_apply(pj, jnp.asarray(x), cfg,
                                    state=jax.tree.map(jnp.asarray, st))
    state = params_from_numpy(st, "cpu")
    got, gst = t_xlstm.slstm_apply(pt, torch.from_numpy(x), cfg,
                                   state=state)
    assert gst is state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for key in ("c", "n", "h", "m"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **BLOCK_TOL, err_msg=key)


def test_mlstm_and_slstm_blocks_decode_as_reference():
    """One decode step of each block from a non-zero state: outputs and
    the states (updated in place by the port) against the reference."""
    cfg = _cfg()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    h = cfg.n_heads
    hd_m = 2 * cfg.d_model // h
    pj, pt = _block_params(j_xlstm.mlstm_template(cfg), 2)
    st = {"C": (rng.standard_normal((3, h, hd_m, hd_m)) * 0.1)
          .astype(np.float32),
          "n": (rng.standard_normal((3, h, hd_m)) * 0.1).astype(np.float32),
          "m": rng.standard_normal((3, h)).astype(np.float32)}
    want, wst = j_xlstm.mlstm_decode(pj, jnp.asarray(x), cfg,
                                     jax.tree.map(jnp.asarray, st))
    state = params_from_numpy(st, "cpu")
    got, gst = t_xlstm.mlstm_decode(pt, torch.from_numpy(x), cfg, state)
    assert gst is state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **BLOCK_TOL, err_msg=key)

    pj, pt = _block_params(j_xlstm.slstm_template(cfg), 3)
    st = _slstm_state(3, h, cfg.d_model // h, rng)
    xg = jnp.einsum("bsd,dghe->bsghe", jnp.asarray(x), pj["w_x"])[:, 0]
    hj, wst = j_xlstm._slstm_cell(pj, xg, jax.tree.map(jnp.asarray, st))
    y = hj.reshape(3, 1, cfg.d_model)
    y = jax.nn.gelu(jnp.einsum("bsd,df->bsf", y, pj["ffn_up"]))
    want = jnp.einsum("bsf,fd->bsd", y, pj["ffn_down"])    # block_decode's
    state = params_from_numpy(st, "cpu")
    got, _ = t_xlstm.slstm_decode(pt, torch.from_numpy(x), cfg, state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for key in ("c", "n", "h", "m"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(wst[key]),
                                   **BLOCK_TOL, err_msg=key)


def test_mlstm_block_matches_interpret_kernel():
    """The full-sequence mLSTM block (plain version on the CPU) against
    the reference's block through the Pallas kernel in interpret mode."""
    cfg = _cfg()
    pj, pt = _block_params(j_xlstm.mlstm_template(cfg), 4)
    x = np.random.default_rng(4).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32)
    want = j_xlstm.mlstm_apply(pj, jnp.asarray(x), cfg, impl="interpret")
    got = t_xlstm.mlstm_apply(pt, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

def _models(cfg, seed=0, mlstm_impl="interpret"):
    mj = j_build(cfg, mlstm_impl=mlstm_impl)
    mt = t_models.build(t_configs.ModelConfig(**dataclasses.asdict(cfg)))
    pj = j_init(mj.template(), jax.random.PRNGKey(seed))
    return mj, mt, pj, params_from_numpy(_np(pj), "cpu")


@pytest.mark.parametrize("mlstm_impl", ["ref", "interpret"])
def test_model_forward_prefill_and_decode_match_reference(mlstm_impl):
    """Reduced xlstm-1.3b (2 periods of [mlstm, slstm], f32): forward,
    prefill and 8 greedy decode steps within ATOL with identical tokens,
    and the caches' states after them."""
    mj, mt, pj, pt = _models(_cfg(), mlstm_impl=mlstm_impl)
    assert [s.mixer for s in mt.period] == ["mlstm", "slstm"]
    assert mt.n_periods == 2 and mt.param_count() == mj.param_count()
    toks = np.random.default_rng(5).integers(0, 256, (2, 13)).astype(
        np.int32)
    lj, _ = mj.forward(pj, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        lt, aux = mt.forward(pt, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert float(aux) == 0.0

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
    for p in ("p0", "p1"):
        want = cj["blocks"][p]["state"]
        for key, got in ct["blocks"][p]["state"].items():
            w = np.asarray(want[key])
            np.testing.assert_allclose(got.numpy(), w,
                                       atol=1e-5 * max(1.0, np.abs(w).max()),
                                       err_msg=f"{p} {key}")


def test_full_config_builds_the_reference_model():
    """xlstm-1.3b at full width and depth: 6 periods of [mlstm x7, slstm],
    the reference's 1,985,603,920 parameters (templates only)."""
    cfg = t_configs.get("xlstm-1.3b")
    m = t_models.build(cfg)
    assert [s.mixer for s in m.period] == ["mlstm"] * 7 + ["slstm"]
    assert m.n_periods == 6
    assert m.param_count() == 1_985_603_920
    assert m.param_count() == j_build(j_configs.get("xlstm-1.3b")
                                      ).param_count()
    tmpl = m.template()["blocks"]["p0"]["mixer"]
    assert tuple(tmpl["wq"].shape) == (6, 4, 1024, 1024)    # hd = inner / h
    cache = m.cache_template(8, 4096)["blocks"]
    assert tuple(cache["p0"]["state"]["C"].shape) == (6, 8, 4, 1024, 1024)
    assert tuple(cache["p7"]["state"]["h"].shape) == (6, 8, 4, 512)


def test_reference_scan_rejects_bf16_at_depth_the_port_runs():
    """At 3 periods with dtype=bfloat16 the reference's lax.scan carry
    changes type (the bf16 stream becomes f32 after the first mLSTM
    block) and raises; the port's layer loop runs it. ROADMAP queue 3."""
    mj, mt, pj, pt = _models(_cfg(dtype="bfloat16", n_layers=6),
                             mlstm_impl="ref")
    cj = j_init(mj.cache_template(1, 8), jax.random.PRNGKey(0))
    toks = np.arange(5, dtype=np.int32)[None]
    with pytest.raises(TypeError, match="carry"):
        mj.prefill(pj, {"tokens": jnp.asarray(toks)}, cj)
    with torch.no_grad():
        lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(toks)},
                            params_from_numpy(_np(cj), "cpu"))
        lt2, _ = mt.decode_step(pt, lt[:, -1].argmax(-1), ct)
    assert mt.n_periods == 3
    assert lt.dtype == torch.float32 and torch.isfinite(lt).all()
    assert torch.isfinite(lt2).all()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _engines(n_lanes=3, decode_tokens=6, max_len=48):
    mj, mt, pj, pt = _models(_cfg())
    return (JEngine(mj, pj, n_lanes=n_lanes, max_len=max_len,
                    decode_tokens=decode_tokens),
            TEngine(mt, pt, n_lanes=n_lanes, max_len=max_len,
                    decode_tokens=decode_tokens, device="cpu"))


def test_engine_serves_reduced_xlstm_as_reference():
    """Admits, a preemption and decode ticks through both Engines:
    identical greedy tokens and completions."""
    ej, et = _engines()
    rng = np.random.default_rng(6)
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


def test_engine_prefill_starts_from_the_zero_state():
    """The state trap: the port's prefill writes its single-lane cache in
    place, and an sLSTM prefill starts from the cache's state. Prompt B
    admitted after prompt A must give the logits of B admitted into a
    fresh engine (the reference's prefills always start from zeros)."""
    ej, et = _engines(n_lanes=2)
    _, fresh = _engines(n_lanes=2)
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, 10).astype(np.int32)
    b = rng.integers(0, 256, 6).astype(np.int32)
    et.prefill_lane(a, 0)
    got = et.prefill_lane(b, 1)
    want = fresh.prefill_lane(b, 1)
    assert torch.equal(got, want)
    for key, leaf in fresh.cache["blocks"]["p1"]["state"].items():
        assert torch.equal(et.cache["blocks"]["p1"]["state"][key][:, 1],
                           leaf[:, 1]), key
    assert not torch.equal(et.cache["blocks"]["p1"]["state"]["c"][:, 0],
                           et.cache["blocks"]["p1"]["state"]["c"][:, 1])
    # And the reference agrees on B's first token.
    assert ej.admit(JFrame(0, 0.0, 0.0), a) and ej.admit(JFrame(1, 0.0, 0.0),
                                                          b)
    assert ej.lanes[1].out[0] == int(torch.argmax(got))
