"""The port's LM (configs, layers, init, the dense GQA TransformerLM) held
against the JAX package on the CPU. Parameters are made by the JAX
package's ``init_params`` and carried over by ``convert.params_from_numpy``;
inputs come from numpy seeds."""
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
from repro.models import layers as j_layers  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ATOL = 1e-4     # f32 logits of the reduced model, port vs reference


def _cfgs(**kw):
    return (dataclasses.replace(j_configs.get("qwen2.5-3b").reduced(), **kw),
            dataclasses.replace(t_configs.get("qwen2.5-3b").reduced(), **kw))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_configs_copy_the_reference():
    """All ten architectures of the JAX package, full and reduced, equal
    the port's copies, and ``build`` takes each of them."""
    assert set(t_configs.ARCHS) == set(j_configs.ARCHS)
    assert len(t_configs.ARCHS) == 10
    for name in j_configs.ARCHS:
        j, t = j_configs.get(name), t_configs.get(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (dataclasses.asdict(j.reduced())
                == dataclasses.asdict(t.reduced()))
        assert t.padded_vocab == j.padded_vocab
        for cfg in (t, t.reduced()):
            model = t_models.build(cfg)
            assert isinstance(model, t_models.EncDecLM if cfg.enc_layers
                              else t_models.TransformerLM)
    assert t_configs.get("qwen2.5-3b").padded_vocab == 152_064
    with pytest.raises(KeyError):
        t_configs.get("gpt-5")
    assert t_models.build(j_configs.get("jamba-1.5-large-398b")).n_periods \
        == 9
    assert t_models.build(j_configs.get("llama-3.2-vision-11b")).n_periods \
        == 8


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))
    want = j_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jd))
    got = t_layers.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-6 if dtype == "float32" else 1e-2,
                               atol=1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dims", [None, 8])
def test_rope_matches_reference(dims):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               dims=dims)
    got = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6, dims=dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(t_layers.rope_frequencies(16, 1e6).numpy(),
                               np.asarray(j_layers.rope_frequencies(16, 1e6)),
                               rtol=1e-6)


def test_swiglu_matches_reference_and_promotes():
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("wi_gate", (32, 48)), ("wi_up", (32, 48)),
                      ("wo", (48, 32)))}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = j_layers.swiglu(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = t_layers.swiglu(params_from_numpy(p, "cpu"),
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # A bf16 activation against f32 weights promotes to f32, as jnp does.
    xb = torch.from_numpy(x).bfloat16()
    assert (t_layers.swiglu(params_from_numpy(p, "cpu"), xb).dtype
            == torch.float32)
    assert j_layers.swiglu(jax.tree.map(jnp.asarray, p),
                           jnp.asarray(x, jnp.bfloat16)).dtype == jnp.float32


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------

def test_init_params_matches_template_and_scales():
    cfg_j, cfg_t = _cfgs(n_layers=3)
    mj, mt = j_build(cfg_j), t_models.build(cfg_t)
    pj = _tree_np(j_init(mj.template(), jax.random.PRNGKey(0)))
    pt = t_common.init_params(mt.template(),
                              torch.Generator().manual_seed(0), device="cpu")
    tmpl = mt.template()
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    leaves_t = t_common.tree_leaves(pt)
    leaves_p = t_common.tree_leaves(tmpl)
    assert len(flat_j) == len(leaves_t) == len(leaves_p)
    for (path, a), b, p in zip(flat_j, leaves_t, leaves_p):
        assert tuple(a.shape) == tuple(b.shape) == tuple(p.shape), path
        assert b.dtype == torch.float32 and a.dtype == np.float32
        x = b.numpy().astype(np.float64)
        if p.init == "zeros":
            assert not x.any()
        elif p.init == "ones":
            assert (x == 1).all()
        else:
            want = (p.scale if p.init == "embed" else
                    1.0 / np.sqrt(t_common._fan_in(p)))
            # Sample std of n normals: relative error ~ 1/sqrt(2n).
            bound = 5.0 / np.sqrt(2 * x.size)
            assert abs(x.std() / want - 1) < bound, path
            assert abs(np.asarray(a, np.float64).std() / want - 1) < bound
            assert abs(x.mean()) < 5 * want / np.sqrt(x.size), path
    cache = t_common.init_params(mt.cache_template(2, 8),
                                 torch.Generator(), device="cpu")
    assert cache["len"].dtype == torch.int32
    assert cache["blocks"]["p0"]["self"]["k"].shape == (3, 2, 8, 2, 16)
    assert mt.param_count() == mj.param_count()
    full = t_configs.get("qwen2.5-3b")
    assert (t_models.build(full).param_count()
            == j_build(j_configs.get("qwen2.5-3b")).param_count())


def test_init_params_and_converter_default_to_the_card(monkeypatch):
    """Without a card, both entry points raise unless the CPU is asked for
    by name: nothing carries on on the CPU by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mt = t_models.build(_cfgs()[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_common.init_params(mt.template(), torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    assert params_from_numpy({"w": np.zeros(3, np.float32)},
                             "cpu")["w"].device.type == "cpu"


# ---------------------------------------------------------------------------
# The model: prefill + decode against repro's build(cfg, impl=...)
# ---------------------------------------------------------------------------

def _run_both(cfg_j, cfg_t, impl, *, batch=2, seq=7, steps=8, seed=0):
    mj, mt = j_build(cfg_j, impl=impl), t_models.build(cfg_t)
    pj = j_init(mj.template(), jax.random.PRNGKey(seed))
    cj = j_init(mj.cache_template(batch, 32), jax.random.PRNGKey(seed))
    pt = params_from_numpy(_tree_np(pj), "cpu")
    ct = params_from_numpy(_tree_np(cj), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_t.vocab, (batch, seq)).astype(np.int32)
    lj, cj = mj.prefill(pj, {"tokens": jnp.asarray(toks)}, cj)
    with torch.no_grad():
        lt, ct = mt.prefill(pt, {"tokens": torch.from_numpy(toks)}, ct)
    out = [(np.asarray(lj, np.float32), lt.float().numpy())]
    tj, tt = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    for _ in range(steps):
        lj, cj = mj.decode_step(pj, tj, cj)
        with torch.no_grad():
            lt, ct = mt.decode_step(pt, tt, ct)
        out.append((np.asarray(lj, np.float32), lt.float().numpy()))
        tj, tt = jnp.argmax(lj, -1), lt.argmax(-1)
    return out, cj, ct


@pytest.mark.parametrize("dtype,n_layers", [("float32", 2), ("bfloat16", 2),
                                            ("float32", 3)])
@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_model_prefill_and_decode_match_reference(dtype, n_layers, impl):
    """Reduced qwen2.5-3b: prefill logits and 8 greedy decode steps within
    atol 1e-4 with identical tokens, against the reference's jnp path and
    its Pallas kernels in interpret mode; n_layers=3 is the reference's
    lax.scan branch, bf16 its embedding-rounding promotion path."""
    cfg_j, cfg_t = _cfgs(dtype=dtype, n_layers=n_layers)
    steps, cj, ct = _run_both(cfg_j, cfg_t, impl)
    for i, (a, b) in enumerate(steps):
        assert b.shape == a.shape and b.shape[-1] == cfg_t.padded_vocab
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=0, err_msg=str(i))
        np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))
    assert np.array_equal(ct["len"].numpy(), np.asarray(cj["len"]))
    kj = np.asarray(cj["blocks"]["p0"]["self"]["k"])
    kt = ct["blocks"]["p0"]["self"]["k"].numpy()
    fill = int(ct["len"][0])
    np.testing.assert_allclose(kt[:, :, :fill], kj[:, :, :fill], atol=ATOL)


def test_reference_scan_rejects_bf16_at_depth_the_port_runs():
    """At n_layers > 2 with dtype=bfloat16 the reference's lax.scan carry
    changes type (bf16 in, f32 out) and raises; the port's layer loop
    runs and, at depth 2, equals the reference's unrolled branch (the
    test above). ROADMAP queue 3."""
    cfg_j, cfg_t = _cfgs(dtype="bfloat16", n_layers=3)
    mj, mt = j_build(cfg_j), t_models.build(cfg_t)
    pj = j_init(mj.template(), jax.random.PRNGKey(0))
    cj = j_init(mj.cache_template(1, 8), jax.random.PRNGKey(0))
    toks = np.arange(5, dtype=np.int32)[None]
    with pytest.raises(TypeError, match="carry"):
        mj.prefill(pj, {"tokens": jnp.asarray(toks)}, cj)
    with torch.no_grad():
        lt, _ = mt.prefill(params_from_numpy(_tree_np(pj), "cpu"),
                           {"tokens": torch.from_numpy(toks)},
                           params_from_numpy(_tree_np(cj), "cpu"))
    assert lt.dtype == torch.float32 and torch.isfinite(lt).all()


def test_forward_matches_reference():
    cfg_j, cfg_t = _cfgs()
    mj, mt = j_build(cfg_j), t_models.build(cfg_t)
    pj = j_init(mj.template(), jax.random.PRNGKey(3))
    toks = np.random.default_rng(3).integers(0, 256, (2, 9)).astype(np.int32)
    lj, _ = mj.forward(pj, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        lt, aux = mt.forward(params_from_numpy(_tree_np(pj), "cpu"),
                             {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert float(aux) == 0.0
    assert not hasattr(mt, "vocab")      # engine_plane reads vocab=32


def test_decode_at_a_full_cache_drops_the_write():
    """A lane whose len has reached max_len writes nothing (the
    reference's mode="drop") and still decodes."""
    cfg_j, cfg_t = _cfgs()
    mj, mt = j_build(cfg_j), t_models.build(cfg_t)
    pj = j_init(mj.template(), jax.random.PRNGKey(4))
    cj = j_init(mj.cache_template(2, 6), jax.random.PRNGKey(4))
    cj = {**cj, "len": jnp.asarray([6, 2], jnp.int32)}
    ct = params_from_numpy(_tree_np(cj), "cpu")
    assert ct["len"].dtype == torch.int32
    before = ct["blocks"]["p0"]["self"]["k"].clone()
    toks = np.array([3, 4], np.int32)
    lj, cj2 = mj.decode_step(pj, jnp.asarray(toks), cj)
    with torch.no_grad():
        lt, ct2 = mt.decode_step(params_from_numpy(_tree_np(pj), "cpu"),
                                 torch.from_numpy(toks), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    k_after = ct2["blocks"]["p0"]["self"]["k"]
    assert torch.equal(k_after[:, 0], before[:, 0])          # dropped
    assert not torch.equal(k_after[:, 1, 2], before[:, 1, 2])
    np.testing.assert_allclose(
        k_after.numpy(), np.asarray(cj2["blocks"]["p0"]["self"]["k"]),
        atol=ATOL)
