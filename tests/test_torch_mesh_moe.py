"""Expert parallelism over 4 gloo ranks on the CPU (mesh data 2 x model
2): the all-to-all MoE path (``models.moe._moe_apply_a2a``) of reduced
dbrx-132b (4 experts, top-2, capacity factor 2.0, as
``tests/test_distribution.py``) and reduced qwen2-moe-a2.7b (with its
shared expert), against the JAX package's unsharded run on the same
parameters.

Bars: logits within 2e-3 of the unsharded forward (the gap is printed),
every routing decision equal (each token's kept (expert, slot) choices),
the aux loss equal (1e-5 relative) to the mean of the data shards' aux
losses, as the JAX package's all-to-all path averages it; a train step
(2 microbatches) against ``jax.value_and_grad`` of the mean loss over the
same (shard, microbatch) blocks: loss and grad norm within 1e-5
relative, parameters within atol 3e-5.
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

from repro import configs as j_configs  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402

MESH = [2, 2]
CFGS = {"dbrx-132b": dict(n_experts=4, top_k=2, capacity_factor=2.0),
        "qwen2-moe-a2.7b": {}}
OPT = dict(lr=1e-3, warmup_steps=1)


def _reference(arch):
    cfg = dataclasses.replace(j_configs.get(arch).reduced(), **CFGS[arch])
    model = j_build(cfg)
    return cfg, model, j_init(model.template(), jax.random.PRNGKey(0))


def _routes(monkeypatch, fn):
    """Run ``fn`` recording each MoE layer's kept (expert, slot) codes
    (expert * 1000 + slot) per token."""
    seen = []
    real = j_moe._routing

    def record(params, x, cfg, capacity):
        dispatch, combine, aux = real(params, x, cfg, capacity)
        seen.append(np.asarray(dispatch))
        return dispatch, combine, aux
    monkeypatch.setattr(j_moe, "_routing", record)
    out = fn()
    monkeypatch.setattr(j_moe, "_routing", real)
    codes = []
    for d in seen:
        b, s = d.shape[:2]
        codes.append([[sorted(int(e) * 1000 + int(c)
                              for e, c in zip(*np.nonzero(d[i, j])))
                       for j in range(s)] for i in range(b)])
    return out, codes


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_a2a_forward_matches_unsharded(arch, tmp_path, monkeypatch):
    cfg, model, params = _reference(arch)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                         cfg.vocab), np.int32)
    (want, _), codes = _routes(
        monkeypatch, lambda: model.forward(params,
                                           {"tokens": jnp.asarray(toks)}))
    aux_shards = [float(model.forward(params, {"tokens": jnp.asarray(
        toks[i:i + 2])})[1]) for i in (0, 2)]
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    outs = workers.spawn("forward", 4, tmp_path,
                         dict(arch=arch, cfg=CFGS[arch], mesh=MESH), arrays)
    gap = max(float(np.abs(o["logits"] - np.asarray(want)).max())
              for o in outs)
    print(f"{arch}: a2a logits within {gap:.3e} of the unsharded forward")
    assert gap <= 2e-3
    n_layers = len(codes)
    for out in outs:
        lo, b_loc = (int(v) for v in out["rows"])
        assert sum(k.startswith("route_") for k in out) == n_layers
        for layer in range(n_layers):
            got = out[f"route_{layer}"]
            for i in range(b_loc):
                for j in range(got.shape[1]):
                    assert sorted(int(c) for c in got[i, j] if c >= 0) \
                        == codes[layer][lo + i][j], (layer, lo + i, j)
        assert float(out["aux"]) == pytest.approx(np.mean(aux_shards),
                                                  rel=1e-5)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_a2a_train_step_matches_blockwise_reference(arch, tmp_path):
    cfg, model, params = _reference(arch)
    ocfg = j_opt.AdamWConfig(**OPT)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (8, 17), 0,
                                         cfg.vocab), np.int32)
    # Data rank r's microbatch i: rows r * 4 + 2 i .. + 2.
    blocks = [{"tokens": jnp.asarray(toks[a:a + 2, :-1]),
               "labels": jnp.asarray(toks[a:a + 2, 1:])}
              for a in (0, 2, 4, 6)]

    def loss_fn(p):
        return sum(model.loss(p, b) for b in blocks) / len(blocks)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    want, _, metrics = j_opt.update(params, grads,
                                    j_opt.init(params, ocfg), ocfg)
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    outs = workers.spawn("train", 4, tmp_path,
                         dict(arch=arch, cfg=CFGS[arch], mesh=MESH, opt=OPT,
                              microbatches=2, hoist=True), arrays)
    flat_want = workers.flat_numpy(want)
    for out in outs:
        assert float(out["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert float(out["grad_norm"]) == pytest.approx(
            float(metrics["grad_norm"]), rel=1e-5)
        for key, w in flat_want.items():
            np.testing.assert_allclose(out[key], w, atol=3e-5, rtol=0,
                                       err_msg=key)
