"""The rest of the port's LM ladder held against the JAX package on the
CPU: yi-6b, yi-34b, qwen2-moe-a2.7b, dbrx-132b, minicpm3-4b (MLA),
llama-3.2-vision-11b (cross-attention) and seamless-m4t-large-v2 (the
encoder-decoder), each at ``reduced()``. Parameters are made by the JAX
package's ``init_params`` and carried over by
``convert.params_from_numpy``; inputs come from numpy seeds; f32 logits
within 1e-4 (``test_torch_models.py``'s bar)."""
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
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import mla as j_mla  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Frame as JFrame  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import mla as t_mla  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import Engine as TEngine  # noqa: E402
from repro_torch.serving import Frame as TFrame  # noqa: E402

ATOL = 1e-4
LADDER = ("yi-6b", "yi-34b", "qwen2-moe-a2.7b", "dbrx-132b", "minicpm3-4b",
          "llama-3.2-vision-11b", "seamless-m4t-large-v2")
MOE = ("qwen2-moe-a2.7b", "dbrx-132b")
AUDIO_FRAMES = 11


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, capacity="default"):
    """The reduced config in both packages; ``capacity="dropless"`` sets
    the MoE's capacity factor to n_experts / top_k, as
    tests/test_models.py does."""
    cj, ct = j_configs.get(arch).reduced(), t_configs.get(arch).reduced()
    if capacity == "dropless":
        cf = cj.n_experts / cj.top_k
        cj = dataclasses.replace(cj, capacity_factor=cf)
        ct = dataclasses.replace(ct, capacity_factor=cf)
    return cj, ct


def _init(template, seed):
    """repro's init_params, compiled as one program (eager, it compiles
    one small program per leaf shape)."""
    return jax.jit(lambda key: j_init(template, key))(
        jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _models(arch, capacity="default", seed=0):
    cj, ct = _cfgs(arch, capacity)
    mj, mt = j_build(cj), t_models.build(ct)
    pj = _init(mj.template(), seed)
    return mj, mt, pj, params_from_numpy(_np(pj), "cpu")


def _batch(cfg, b, s, seed):
    """numpy inputs: tokens and the stub frontends' embeddings (vision:
    normal x 0.3, as repro.data.pipeline draws them; audio frames)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)) * 0.3).astype(np.float32)
    if cfg.enc_layers:
        out["audio_embeds"] = rng.standard_normal(
            (b, AUDIO_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _cache_kw(model):
    return {"enc_len": AUDIO_FRAMES} if model.cfg.enc_layers else {}


# ---------------------------------------------------------------------------
# configs, templates, parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LADDER)
def test_param_count_matches_reference(arch):
    """The full config's parameter count equals repro's at ep_degree=1."""
    assert (t_models.build(t_configs.get(arch)).param_count()
            == j_build(j_configs.get(arch), ep_degree=1).param_count())


@pytest.mark.parametrize("arch", LADDER)
def test_cache_template_matches_reference(arch):
    """Every cache leaf of the reduced model, shape and dtype, as repro's
    (the VLM's cross caches of n_vision_tokens rows, the encoder-decoder's
    of enc_len rows)."""
    mj, mt, _, _ = _models(arch)
    tj = mj.cache_template(3, 12, **_cache_kw(mj))
    tt = mt.cache_template(3, 12, **_cache_kw(mt))
    flat_j = jax.tree_util.tree_flatten_with_path(tj)[0]
    flat_t = t_common.tree_leaves(tt)
    assert len(flat_j) == len(flat_t)
    for (path, a), b in zip(flat_j, flat_t):
        assert tuple(a.shape) == tuple(b.shape), path
    ct = params_from_numpy(_np(_init(tj, 0)), "cpu")
    assert ct["len"].dtype == torch.int32
    assert t_common.tree_leaves(t_common.init_params(
        tt, torch.Generator(), device="cpu"))[0].shape == flat_t[0].shape
    if mt.cfg.family == "vlm":
        enc = ct["blocks"]["p0"]["enc"]["k"]
        assert enc.shape[2] == mt.cfg.n_vision_tokens


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _dtypes(dtype):
    return ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
            else (jnp.float32, torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    jd, td = _dtypes(dtype)
    want = j_layers.layernorm(jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x, jd))
    got = t_layers.layernorm(params_from_numpy(p, "cpu"),
                             torch.from_numpy(x).to(td))
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    """The audio FFN in f32 and on a bf16 stream (the GELU's output cast
    back to bf16, the products promoted to f32 by the f32 weights)."""
    rng = np.random.default_rng(1)
    p = {"wi": rng.standard_normal((32, 48)).astype(np.float32) * 0.2,
         "bi": rng.standard_normal(48).astype(np.float32) * 0.1,
         "wo": rng.standard_normal((48, 32)).astype(np.float32) * 0.2,
         "bo": rng.standard_normal(32).astype(np.float32) * 0.1}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jd, td = _dtypes(dtype)
    want = j_layers.gelu_mlp(jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x, jd))
    got = t_layers.gelu_mlp(params_from_numpy(p, "cpu"),
                            torch.from_numpy(x).to(td))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_params(seed):
    cj, ct = _cfgs("minicpm3-4b")
    pj = _init(j_mla.mla_template(cj), seed)
    return cj, ct, pj, params_from_numpy(_np(pj), "cpu")


def test_mla_apply_and_absorbed_decode_match_reference():
    """The expanded prefill (output and the cached latent and rotary key)
    and three absorbed decode steps at ragged lengths, one of them at a
    full cache (the write dropped)."""
    cj, ct, pj, pt = _mla_params(2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, ct.d_model)).astype(np.float32)
    cache_j = _init(j_mla.mla_cache_template(cj, 3, 9), 0)
    cache_t = params_from_numpy(_np(cache_j), "cpu")
    apply = jax.jit(functools.partial(j_mla.mla_apply, cfg=cj))
    decode = jax.jit(functools.partial(j_mla.mla_decode, cfg=cj))
    yj, cache_j = apply(pj, jnp.asarray(x), cache=cache_j)
    yt, cache_t = t_mla.mla_apply(pt, torch.from_numpy(x), ct, cache=cache_t)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(cache_t[key].numpy(),
                                   np.asarray(cache_j[key]), atol=ATOL)
    lens = np.array([7, 3, 9], np.int32)
    for step in range(3):
        xs = rng.standard_normal((3, 1, ct.d_model)).astype(np.float32)
        yj, cache_j = decode(pj, jnp.asarray(xs), cache=cache_j,
                             lens=jnp.asarray(lens))
        yt, cache_t = t_mla.mla_decode(pt, torch.from_numpy(xs), ct, cache_t,
                                       torch.from_numpy(lens))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL,
                                   err_msg=str(step))
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(cache_t[key].numpy(),
                                       np.asarray(cache_j[key]), atol=ATOL)
        lens = np.minimum(lens + 1, 9)


def test_mla_absorbed_decode_equals_the_expanded_form():
    """On the port alone: the absorbed decode of token s after a prefill of
    s tokens equals the expanded form's last row over s + 1 tokens."""
    _, ct, _, pt = _mla_params(3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 6, ct.d_model)).astype(np.float32))
    full = t_mla.mla_apply(pt, x, ct)
    cache = t_common.init_params(t_mla.mla_cache_template(ct, 2, 8),
                                 torch.Generator(), device="cpu")
    t_mla.mla_apply(pt, x[:, :5], ct, cache=cache)
    y, _ = t_mla.mla_decode(pt, x[:, 5:], ct, cache,
                            torch.full((2,), 5, dtype=torch.int32))
    np.testing.assert_allclose(y[:, 0].numpy(), full[:, 5].numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_rounds_the_context_on_a_bf16_stream(dtype):
    """With ``dtype="bfloat16"`` (every full config's) the first layer's
    stream is bf16, and repro's absorbed decode casts the latent context
    to the stream's dtype before ``v_up`` (``ctx.astype(x.dtype)``) where
    the expanded form keeps f32: its decode steps then miss the forward
    over the same tokens by ~1e-2 (tests/test_models.py runs reduced
    configs in f32 and cannot see it). The port follows, to 1e-6 of
    repro's own gap; on an f32 stream both agree with the forward to
    1e-5 (ROADMAP section 3)."""
    cj, ct = (dataclasses.replace(c, dtype=dtype)
              for c in _cfgs("minicpm3-4b"))
    mj, mt = j_build(cj), t_models.build(ct)
    pj = _init(mj.template(), 0)
    pt = params_from_numpy(_np(pj), "cpu")
    toks = np.random.default_rng(13).integers(0, 256, (2, 12)).astype(
        np.int32)
    cache = _np(_init(mj.cache_template(2, 16), 0))

    def gaps(m, p, conv, c):
        full = np.asarray(m.forward(p, {"tokens": conv(toks)})[0],
                          np.float32)
        lg, c = m.prefill(p, {"tokens": conv(toks[:, :10])}, c)
        steps = []
        for i in (10, 11):
            lg, c = m.decode_step(p, conv(toks[:, i]), c)
            steps.append(np.asarray(lg, np.float32))
        return [np.abs(x - full[:, i]).max()
                for x, i in zip(steps, (10, 11))], steps

    gj, sj = gaps(mj, pj, jnp.asarray, jax.tree.map(jnp.asarray, cache))
    with torch.no_grad():
        gt, st = gaps(mt, pt, torch.from_numpy,
                      params_from_numpy(cache, "cpu"))
    np.testing.assert_allclose(gt, gj, atol=1e-6)
    for a, b in zip(sj, st):
        np.testing.assert_allclose(b, a, atol=ATOL)
    if dtype == "float32":
        assert max(gj) < 1e-5 and max(gt) < 1e-5
    else:
        assert min(gj) > 2e-3 and min(gt) > 2e-3


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_cross_attention_matches_reference(impl):
    """gqa_apply with kv_x (no rope, every query sees every key; s < t and
    s > t), encode_kv and cross_decode against repro's jnp path and its
    Pallas kernels in interpret mode."""
    cj, ct = _cfgs("llama-3.2-vision-11b")
    cj = dataclasses.replace(cj, qkv_bias=True)
    ct = dataclasses.replace(ct, qkv_bias=True)
    pj = _init(j_attn.gqa_template(cj), 4)
    pj = dict(pj, bq=pj["bq"] + 0.1, bk=pj["bk"] - 0.1, bv=pj["bv"] + 0.2)
    pt = params_from_numpy(_np(pj), "cpu")
    rng = np.random.default_rng(4)
    src = (rng.standard_normal((2, 8, ct.d_model)) * 0.3).astype(np.float32)
    for s in (5, 12):
        x = rng.standard_normal((2, s, ct.d_model)).astype(np.float32)
        want = j_attn.gqa_apply(pj, jnp.asarray(x), cj,
                                kv_x=jnp.asarray(src), impl=impl)
        got = t_attn.gqa_apply(pt, torch.from_numpy(x), ct,
                               kv_x=torch.from_numpy(src))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    kj, vj = j_attn.encode_kv(pj, cj, jnp.asarray(src))
    kt, vt = t_attn.encode_kv(pt, ct, torch.from_numpy(src))
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)
    x1 = rng.standard_normal((2, 1, ct.d_model)).astype(np.float32)
    want = j_attn.cross_decode(pj, jnp.asarray(x1), cj, kj, vj, impl=impl)
    got = t_attn.cross_decode(pt, torch.from_numpy(x1), ct, kt, vt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # A one-token query attends to the whole source: cross_decode equals
    # the full-sequence cross-attention of that token.
    np.testing.assert_allclose(
        got.numpy(), t_attn.gqa_apply(pt, torch.from_numpy(x1), ct,
                                      kv_x=torch.from_numpy(src)).numpy(),
        atol=ATOL)


def test_cross_cache_must_fit_the_source():
    """The port writes the cross caches in place, so a cache made for
    another source length is refused (the reference replaces it)."""
    mj, mt, _, pt = _models("llama-3.2-vision-11b")
    batch = _batch(mt.cfg, 1, 4, 5)
    batch["vision_embeds"] = batch["vision_embeds"][:, :5]
    cache = t_common.init_params(mt.cache_template(1, 8), torch.Generator(),
                                 device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="kv_source_len"):
        mt.prefill(pt, _both(batch)[1], cache)


def test_vlm_without_vision_embeds_follows_the_reference():
    """Without ``vision_embeds`` repro's VLM runs each cross layer as a
    causal self-attention layer with rope (its gqa_apply takes kv_x=None
    for self-attention), with no error, and its prefill fails building the
    cross cache. The port follows both (ROADMAP section 3)."""
    mj, mt, pj, pt = _models("llama-3.2-vision-11b")
    batch = _batch(mt.cfg, 2, 6, 12)
    del batch["vision_embeds"]
    bj, bt = _both(batch)
    lj, _ = mj.forward(pj, bj)
    with torch.no_grad():
        lt, _ = mt.forward(pt, bt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    with pytest.raises(ValueError, match="shape of None"):
        mj.prefill(pj, bj, _init(mj.cache_template(2, 8), 0))
    cache = t_common.init_params(mt.cache_template(2, 8), torch.Generator(),
                                 device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="source"):
        mt.prefill(pt, bt, cache)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LADDER)
def test_forward_matches_reference(arch):
    mj, mt, pj, pt = _models(arch)
    bj, bt = _both(_batch(mt.cfg, 2, 9, 7))
    lj, aj = mj.forward(pj, bj)
    with torch.no_grad():
        lt, at = mt.forward(pt, bt)
    assert lt.shape == (2, 9, mt.cfg.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert float(at) == pytest.approx(float(aj), rel=1e-5, abs=1e-7)
    assert not hasattr(mt, "vocab")      # engine_plane reads vocab=32


def _prefill_decode(arch, capacity, steps=2):
    mj, mt, pj, pt = _models(arch, capacity)
    bj, bt = _both(_batch(mt.cfg, 2, 9, 8))
    cj = _init(mj.cache_template(2, 16, **_cache_kw(mj)), 0)
    ct = params_from_numpy(_np(cj), "cpu")
    lj, cj = mj.prefill(pj, bj, cj)
    with torch.no_grad():
        lt, ct = mt.prefill(pt, bt, ct)
    out = [(np.asarray(lj), lt.numpy())]
    tj, tt = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    for _ in range(steps):
        lj, cj = mj.decode_step(pj, tj, cj)
        with torch.no_grad():
            lt, ct = mt.decode_step(pt, tt, ct)
        out.append((np.asarray(lj), lt.numpy()))
        tj, tt = jnp.argmax(lj, -1), lt.argmax(-1)
    return out, cj, ct


@pytest.mark.parametrize("arch,capacity",
                         [(a, "default") for a in LADDER]
                         + [(a, "dropless") for a in MOE])
def test_prefill_and_decode_match_reference(arch, capacity):
    """Prefill logits and 2 greedy decode steps within 1e-4 with identical
    tokens, and every cache leaf (MoE: at the default capacity factor,
    which drops tokens in the prefill, and dropless)."""
    out, cj, ct = _prefill_decode(arch, capacity)
    for i, (a, b) in enumerate(out):
        np.testing.assert_allclose(b, a, atol=ATOL, err_msg=str(i))
        np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))
    flat_j = jax.tree_util.tree_flatten_with_path(cj)[0]
    for (path, a), b in zip(flat_j, t_common.tree_leaves(ct)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL,
                                   err_msg=str(path))
    if arch in MOE and capacity == "default":
        other = _prefill_decode(arch, "dropless", steps=0)[0]
        assert not np.allclose(other[0][1], out[0][1], atol=ATOL), \
            "the default capacity dropped no token"


@pytest.mark.parametrize("arch", LADDER)
def test_prefill_then_decode_continues_the_forward(arch):
    """On the port alone, as tests/test_models.py holds the reference:
    prefill of s tokens and 2 decode steps against one forward over the s
    + 2 tokens (MoE dropless; for minicpm3 the absorbed decode against the
    expanded form)."""
    _, mt, _, pt = _models(arch, "dropless" if arch in MOE else "default")
    batch = _batch(mt.cfg, 2, 10, 9)
    toks = torch.from_numpy(batch["tokens"])
    full = _both(batch)[1]
    with torch.no_grad():
        logits, _ = mt.forward(pt, full)
        cache = t_common.init_params(mt.cache_template(2, 12, **_cache_kw(mt)),
                                     torch.Generator(), device="cpu")
        lg, cache = mt.prefill(pt, dict(full, tokens=toks[:, :8]), cache)
        got = [lg[:, 0]]
        for i in (8, 9):
            lg, cache = mt.decode_step(pt, toks[:, i], cache)
            got.append(lg)
    for j, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), logits[:, 7 + j].numpy(),
                                   atol=ATOL, err_msg=str(j))


def test_encdec_encode_matches_reference():
    mj, mt, pj, pt = _models("seamless-m4t-large-v2")
    audio = _batch(mt.cfg, 2, 3, 10)["audio_embeds"]
    want = mj.encode(pj, jnp.asarray(audio))
    with torch.no_grad():
        got = mt.encode(pt, torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert isinstance(mt, t_models.EncDecLM)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-moe-a2.7b", "minicpm3-4b"])
def test_engine_matches_reference(arch):
    """Both Engines on the same parameters: the same first tokens from
    ragged prompts, the same greedy tokens over decode ticks, the same lane
    states."""
    mj, mt, pj, pt = _models(arch)
    ej = JEngine(mj, pj, n_lanes=3, max_len=32, decode_tokens=4)
    et = TEngine(mt, pt, n_lanes=3, max_len=32, decode_tokens=4,
                 device="cpu")
    rng = np.random.default_rng(11)
    for i, n in enumerate((6, 11, 3)):
        toks = rng.integers(0, mt.cfg.vocab, n).astype(np.int32)
        assert ej.admit(JFrame(i, 0.0, 0.0, seq=i), toks)
        assert et.admit(TFrame(i, 0.0, 0.0, seq=i), toks)
    done_j, done_t = [], []
    for _ in range(5):
        done_j += ej.decode_tick()
        done_t += et.decode_tick()
        assert ([list(lane.out) for lane in ej.lanes]
                == [list(lane.out) for lane in et.lanes])
        np.testing.assert_array_equal(np.asarray(ej.cache["len"]),
                                      et.cache["len"].numpy())
    assert (sorted((r.stream_id, tuple(int(x) for x in r.tokens))
                   for r in done_j)
            == sorted((r.stream_id, tuple(int(x) for x in r.tokens))
                      for r in done_t))
    assert len(done_t) == 3 and et.utilization == 0.0


def test_remat_under_autograd_is_not_ported():
    """Remat under autograd, which raised while training was not ported,
    now runs: a config with remat="full" gives the same logits under
    autograd as under torch.no_grad(), and gradients flow to its
    parameters (tests/test_torch_train_grads.py holds them to the JAX
    package's)."""
    _, ct = _cfgs("yi-6b")
    mt = t_models.build(dataclasses.replace(ct, remat="full"))
    pt = t_common.init_params(mt.template(), torch.Generator().manual_seed(0),
                              device="cpu")
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.int32)}
    with torch.no_grad():
        want = mt.forward(pt, batch)[0]
    assert want.shape == (1, 3, ct.padded_vocab)
    w = pt["blocks"]["p0"]["ffn"]["wo"].requires_grad_(True)
    got = mt.forward(pt, batch)[0]
    assert torch.equal(got.detach(), want)
    got.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
