"""Dense tensor and data parallelism over 4 gloo ranks on the CPU (mesh
data 2 x model 2): reduced qwen2.5-3b with FSDP off and on, against the
JAX package's unsharded run on the same parameters (converted, not drawn
twice). The ranks run ``tests/torch_mesh_workers.py``.

Bars: forward logits within atol 1e-4; one train step of 2 microbatches
with the hoisted FSDP gather: loss and grad norm within 1e-5 relative,
parameters within atol 3e-5 (``tests/test_distribution.py``'s bars).
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
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training.train_step import make_train_step as j_step  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402

ARCH = "qwen2.5-3b"
MESH = [2, 2]
OPT = dict(lr=1e-3, warmup_steps=1)


def _reference(fsdp: bool):
    cfg = dataclasses.replace(j_configs.get(ARCH).reduced(), fsdp=fsdp)
    model = j_build(cfg)
    params = j_init(model.template(), jax.random.PRNGKey(0))
    return cfg, model, params


def _args(fsdp: bool, **kw):
    return dict(arch=ARCH, cfg=dict(fsdp=fsdp), mesh=MESH, **kw)


@pytest.mark.parametrize("fsdp", [False, True])
def test_forward_matches_unsharded(fsdp, tmp_path):
    cfg, model, params = _reference(fsdp)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                         cfg.vocab), np.int32)
    want, _ = model.forward(params, {"tokens": jnp.asarray(toks)})
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    outs = workers.spawn("forward", 4, tmp_path, _args(fsdp), arrays)
    for out in outs:
        np.testing.assert_allclose(out["logits"], np.asarray(want),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("fsdp", [False, True])
def test_train_step_matches_unsharded(fsdp, tmp_path):
    cfg, model, params = _reference(fsdp)
    ocfg = j_opt.AdamWConfig(**OPT)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (8, 17), 0,
                                         cfg.vocab), np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    step = j_step(model, ocfg, n_microbatches=2)
    want, _, metrics = step(params, j_opt.init(params, ocfg), batch)
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    outs = workers.spawn("train", 4, tmp_path,
                         _args(fsdp, opt=OPT, microbatches=2, hoist=True),
                         arrays)
    flat_want = workers.flat_numpy(want)
    for out in outs:
        assert bool(out["hoist"]) == fsdp
        assert float(out["loss"]) == pytest.approx(float(metrics["loss"]),
                                                   rel=1e-5)
        assert float(out["grad_norm"]) == pytest.approx(
            float(metrics["grad_norm"]), rel=1e-5)
        for key, w in flat_want.items():
            np.testing.assert_allclose(out[key], w, atol=3e-5, rtol=0,
                                       err_msg=key)


def test_remat_recomputes_under_the_rules(tmp_path):
    """Remat "full" gives remat "none"'s gradients on the mesh when the
    backward pass runs where the rules are not set (on the card autograd
    recomputes a period in its own thread): the recomputed body must
    still issue its collectives."""
    cfg, model, params = _reference(True)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (4, 17), 0,
                                         cfg.vocab), np.int32)
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    for out in workers.spawn("remat", 4, tmp_path, _args(True), arrays):
        assert float(out["full/loss"]) == float(out["none/loss"])
        keys = [k[len("none/"):] for k in out
                if k.startswith("none/") and k != "none/loss"]
        assert len(keys) == 15
        for key in keys:
            np.testing.assert_allclose(out["full/" + key], out["none/" + key],
                                       rtol=0, atol=1e-6, err_msg=key)
