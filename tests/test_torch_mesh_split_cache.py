"""The sequence-sharded decode cache over 4 gloo ranks on the CPU, through
``launch.specs.plan_cell``, against the JAX package's unsharded
``prefill`` / ``decode_step`` on the same parameters; and experts on a
non-data axis against the unsharded forward.

- Reduced qwen2.5-3b on (1, 4): its 2 kv heads do not divide the model
  axis, so ``make_rules`` puts ``cache_seq`` there. Prompt 12, 32 rows (8
  a rank), 8 decode steps: rank 3's block stays empty throughout.
- Reduced qwen2.5-3b on (2, 2) with ``{"cache_seq": "model", "kv_heads":
  None}``, the override the four-card runs take where the kv heads divide
  the axis.
- Reduced dbrx-132b on (2, 2) with ``{"cache_seq": "model"}``: the
  all-to-all MoE path and the split cache together, and the placement
  conflict of the cache (kv heads and rows both on ``model``: the rows
  win, and the kv projections' heads are gathered into the cache).
- Reduced dbrx-132b on (2, 2) with ``{"experts": "model"}``: the forward
  (logits, every routing decision, the aux loss) and a train step.

Bars: qwen atol 1e-4, dbrx 2e-3 (as ``test_torch_mesh_serve.py``); the
greedy tokens equal; the train step at ``test_torch_mesh_moe.py``'s.
"""
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models.common import pspec_tree  # noqa: E402
from repro_torch.sharding import rules as t_rules  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402

DBRX = dict(n_experts=4, top_k=2, capacity_factor=2.0)
SPLIT = {"cache_seq": "model", "kv_heads": None}
SERVE = [("qwen2.5-3b", {}, [1, 4], None, 1e-4),
         ("qwen2.5-3b", {}, [2, 2], SPLIT, 1e-4),
         ("dbrx-132b", DBRX, [2, 2], {"cache_seq": "model"}, 2e-3)]
OPT = dict(lr=1e-3, warmup_steps=1)


def _reference(arch, over):
    cfg = dataclasses.replace(j_configs.get(arch).reduced(), **over)
    model = j_build(cfg)
    return cfg, model, j_init(model.template(), jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch,over,mesh,rules,atol", SERVE,
                         ids=["qwen-1x4", "qwen-2x2-override",
                              "dbrx-2x2-conflict"])
def test_split_cache_prefill_and_decode_match_unsharded(
        arch, over, mesh, rules, atol, tmp_path):
    cfg, model, params = _reference(arch, over)
    n_decode, max_len = 8, 32
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (4, 12), 0,
                                         cfg.vocab), np.int32)
    cache = j_init(model.cache_template(4, max_len), jax.random.PRNGKey(3))
    logits, cache = model.prefill(params, {"tokens": jnp.asarray(toks)},
                                  cache)
    steps, chosen = [np.asarray(logits[:, 0])], []
    for _ in range(n_decode):
        nxt = jnp.argmax(jnp.asarray(steps[-1]), axis=-1).astype(jnp.int32)
        chosen.append(np.asarray(nxt))
        logits, cache = model.decode_step(params, nxt, cache)
        steps.append(np.asarray(logits))
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    outs = workers.spawn("serve", 4, tmp_path,
                         dict(arch=arch, cfg=over, mesh=mesh,
                              overrides=rules, max_len=max_len,
                              n_decode=n_decode), arrays)
    for out in outs:
        # Each rank holds a quarter or a half of the rows, and the decode
        # exchanged partials.
        assert out["cache_rows"].tolist() == [max_len // mesh[1]]
        assert int(out["all_to_all"]) > 0
        np.testing.assert_array_equal(out["tokens"], np.stack(chosen, 1))
        np.testing.assert_allclose(out["logits"], np.stack(steps, 1),
                                   atol=atol, rtol=0)


class FakeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)


def test_cache_rows_win_the_placement_conflict():
    """kv heads and cache rows both on ``model``: the cache's placement
    gives the axis to the rows (its earlier dim), the kv projections keep
    theirs, and a cache length the axis does not divide is refused."""
    cfg = dataclasses.replace(t_configs.get("dbrx-132b").reduced(), **DBRX)
    mesh = FakeMesh({"data": 2, "model": 2})
    rules = t_rules.make_rules(cfg, mesh, overrides={"cache_seq": "model"})
    assert rules["kv_heads"] == "model"
    model = t_build(cfg, impl="torch", ep_degree=2)
    cache = pspec_tree(model.cache_template(4, 32), rules)
    assert cache["blocks"]["p0"]["self"]["k"] == [None, ("data",),
                                                  "model", None, None]
    params = pspec_tree(model.template(), rules)
    assert params["blocks"]["p0"]["mixer"]["wk"] == [None, None, "model",
                                                     None]
    fake = t_mesh.Mesh(("data", "model"), (1, 4), device_mesh=object(),
                       device=torch.device("cpu"))
    qwen = t_configs.get("qwen2.5-3b").reduced()
    for kind in ("prefill", "decode"):
        with pytest.raises(ValueError, match="does not split"):
            t_specs.plan_cell(qwen, t_configs.InputShape(kind, 30, 4, kind),
                              fake, impl="torch")


def _routes(fn):
    """Run ``fn`` recording each MoE layer's kept (expert, slot) codes
    (expert * 1000 + slot) per token, sorted."""
    seen = []
    real = j_moe._routing

    def record(params, x, cfg, capacity):
        dispatch, combine, aux = real(params, x, cfg, capacity)
        seen.append(np.asarray(dispatch))
        return dispatch, combine, aux
    j_moe._routing = record
    try:
        out = fn()
    finally:
        j_moe._routing = real
    codes = []
    for d in seen:
        b, s = d.shape[:2]
        codes.append([[sorted(int(e) * 1000 + int(c)
                              for e, c in zip(*np.nonzero(d[i, j])))
                       for j in range(s)] for i in range(b)])
    return out, codes


def route_flips(out, codes) -> int:
    """Tokens of this rank whose kept (expert, slot) choices differ from
    the reference's, over every MoE layer."""
    lo, b_loc = (int(v) for v in out["rows"])
    assert sum(k.startswith("route_") for k in out) == len(codes)
    flips = 0
    for layer, want in enumerate(codes):
        got = out[f"route_{layer}"]
        for i in range(b_loc):
            for j in range(got.shape[1]):
                flips += sorted(int(c) for c in got[i, j] if c >= 0) \
                    != want[lo + i][j]
    return flips


def test_experts_on_model_forward_matches_unsharded(tmp_path):
    cfg, model, params = _reference("dbrx-132b", DBRX)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                         cfg.vocab), np.int32)
    (want, _), codes = _routes(
        lambda: model.forward(params, {"tokens": jnp.asarray(toks)}))
    aux_shards = [float(model.forward(params, {"tokens": jnp.asarray(
        toks[i:i + 2])})[1]) for i in (0, 2)]
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    outs = workers.spawn("forward", 4, tmp_path,
                         dict(arch="dbrx-132b", cfg=DBRX, mesh=[2, 2],
                              overrides={"experts": "model"}), arrays)
    for out in outs:
        np.testing.assert_allclose(out["logits"], np.asarray(want),
                                   atol=2e-3, rtol=0)
        assert route_flips(out, codes) == 0
        assert float(out["aux"]) == pytest.approx(np.mean(aux_shards),
                                                  rel=1e-5)


def test_experts_on_model_train_step_matches_blockwise_reference(tmp_path):
    """The aux loss's gradient is counted once although every rank of the
    experts' axis computes it: loss, grad norm and parameters as the
    all-to-all path's bars."""
    cfg, model, params = _reference("dbrx-132b", DBRX)
    ocfg = j_opt.AdamWConfig(**OPT)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (4, 17), 0,
                                         cfg.vocab), np.int32)
    blocks = [{"tokens": jnp.asarray(toks[a:a + 2, :-1]),
               "labels": jnp.asarray(toks[a:a + 2, 1:])} for a in (0, 2)]

    def loss_fn(p):
        return sum(model.loss(p, b) for b in blocks) / len(blocks)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    want, _, metrics = j_opt.update(params, grads,
                                    j_opt.init(params, ocfg), ocfg)
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    outs = workers.spawn("train", 4, tmp_path,
                         dict(arch="dbrx-132b", cfg=DBRX, mesh=[2, 2],
                              opt=OPT, microbatches=1, hoist=False,
                              overrides={"experts": "model"}), arrays)
    flat_want = workers.flat_numpy(want)
    for out in outs:
        assert float(out["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert float(out["grad_norm"]) == pytest.approx(
            float(metrics["grad_norm"]), rel=1e-5)
        for key, w in flat_want.items():
            np.testing.assert_allclose(out[key], w, atol=3e-5, rtol=0,
                                       err_msg=key)
