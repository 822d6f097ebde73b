"""Prefill and greedy decode through ``launch.specs.plan_cell`` over 4
gloo ranks on the CPU (mesh data 2 x model 2), against the JAX package's
unsharded ``prefill`` / ``decode_step`` on the same parameters: reduced
qwen2.5-3b with FSDP off and on (the caches' kv heads split over
``model``, the batch over ``data``; within atol 1e-4) and reduced
dbrx-132b on the all-to-all MoE path (4 experts, top-2, capacity factor
2.0; within 2e-3). 8 decode steps; the greedy tokens must be equal.
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
from repro.models.common import init_params as j_init  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402

MESH = [2, 2]
CFGS = {"qwen2.5-3b": [dict(fsdp=False), dict(fsdp=True)],
        "dbrx-132b": [dict(n_experts=4, top_k=2, capacity_factor=2.0)]}
CASES = [(a, c) for a, cs in sorted(CFGS.items()) for c in cs]
ATOL = {"qwen2.5-3b": 1e-4, "dbrx-132b": 2e-3}


@pytest.mark.parametrize("arch,over", CASES,
                         ids=[f"{a}-{i}" for i, (a, _) in enumerate(CASES)])
def test_prefill_and_decode_match_unsharded(arch, over, tmp_path):
    cfg = dataclasses.replace(j_configs.get(arch).reduced(), **over)
    model = j_build(cfg)
    params = j_init(model.template(), jax.random.PRNGKey(0))
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
                         dict(arch=arch, cfg=over, mesh=MESH,
                              max_len=max_len, n_decode=n_decode), arrays)
    for out in outs:
        np.testing.assert_array_equal(out["tokens"], np.stack(chosen, 1))
        np.testing.assert_allclose(out["logits"], np.stack(steps, 1),
                                   atol=ATOL[arch], rtol=0)
