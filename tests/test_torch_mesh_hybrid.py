"""Jamba's hybrid stack under a mesh: reduced jamba-1.5-large-398b (8
layers, two periods of one attention and three Mamba layers, MoE on every
other layer: 4 experts, top-2; 2 kv heads, inner 128) over 4 gloo ranks
on the CPU, against the JAX package's unsharded run on the same
parameters.

- (1, 4): the kv heads do not divide the model axis, so the decode cache's
  rows are split over it; Mamba's inner channels over ``model``
  (``in_proj``'s block exchanged onto the rank's channels); the experts
  local (data extent 1), their MLP columns over ``model``.
- (2, 2): the batch and the experts over ``data`` (the all-to-all MoE
  path), the kv heads and Mamba over ``model``; and with ``{"cache_seq":
  "model", "kv_heads": None}`` the split cache too.

Bars: the forward's logits within 2e-3 and every routing decision equal
(the count of changed decisions is printed); prefill and 8 greedy decode
steps within 2e-3 with the tokens equal; one (2, 2) train step against
``jax.value_and_grad`` at ``test_torch_mesh_moe.py``'s bars, its gradients
also compared leaf by leaf. The reference's jamba runs once, in a
module-scoped fixture.
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

import torch_mesh_workers as workers  # noqa: E402
from test_torch_mesh_split_cache import _routes, route_flips  # noqa: E402

ARCH = "jamba-1.5-large-398b"
N_DECODE, MAX_LEN = 8, 32
OPT = dict(lr=1e-3, warmup_steps=1)
# The gradients the step hands the optimizer, each leaf within GRAD_REL of
# its largest element plus GRAD_ABS (test_torch_train_grads.py's bars).
# AdamW's first step moves each parameter by about lr * sign(g), so the
# parameters after it are held at atol 3e-5 where |g| is above twice that
# bar, where the gradient check fixes the sign.
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
SPLIT = {"cache_seq": "model", "kv_heads": None}


@pytest.fixture(scope="module")
def reference():
    """The reference's parameters, forward (with its routing decisions
    and the data shards' aux losses), and prefill with greedy decode."""
    cfg = j_configs.get(ARCH).reduced()
    model = j_build(cfg)
    params = j_init(model.template(), jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 12), 0,
                                         cfg.vocab), np.int32)
    (logits, aux), codes = _routes(
        lambda: model.forward(params, {"tokens": jnp.asarray(toks)}))
    aux_halves = [float(model.forward(params, {"tokens": jnp.asarray(
        toks[i:i + 2])})[1]) for i in (0, 2)]
    cache = j_init(model.cache_template(4, MAX_LEN), jax.random.PRNGKey(3))
    last, cache = model.prefill(params, {"tokens": jnp.asarray(toks)}, cache)
    steps, chosen = [np.asarray(last[:, 0])], []
    for _ in range(N_DECODE):
        nxt = jnp.argmax(jnp.asarray(steps[-1]), axis=-1).astype(jnp.int32)
        chosen.append(np.asarray(nxt))
        last, cache = model.decode_step(params, nxt, cache)
        steps.append(np.asarray(last))
    arrays = workers.flat_numpy(params)
    arrays["tokens"] = toks
    return dict(cfg=cfg, model=model, params=params, arrays=arrays,
                logits=np.asarray(logits), aux=float(aux),
                aux_halves=aux_halves, codes=codes,
                steps=np.stack(steps, 1), chosen=np.stack(chosen, 1))


@pytest.mark.parametrize("mesh", [[1, 4], [2, 2]], ids=["1x4", "2x2"])
def test_forward_matches_unsharded(reference, mesh, tmp_path):
    outs = workers.spawn("forward", 4, tmp_path, dict(arch=ARCH, mesh=mesh),
                         reference["arrays"])
    # The aux loss is averaged over the data shards, as the reference's
    # all-to-all path averages it; over one shard it is the whole batch's.
    aux = reference["aux"] if mesh[0] == 1 else np.mean(
        reference["aux_halves"])
    flips = sum(route_flips(out, reference["codes"]) for out in outs)
    gap = max(float(np.abs(o["logits"] - reference["logits"]).max())
              for o in outs)
    print(f"jamba {mesh}: logits within {gap:.3e}, {flips} routing "
          "decisions changed")
    assert flips == 0
    assert gap <= 2e-3
    for out in outs:
        assert float(out["aux"]) == pytest.approx(aux, rel=1e-5)


@pytest.mark.parametrize("mesh,rules", [([1, 4], None), ([2, 2], None),
                                        ([2, 2], SPLIT)],
                         ids=["1x4-split", "2x2", "2x2-split"])
def test_prefill_and_decode_match_unsharded(reference, mesh, rules,
                                            tmp_path):
    outs = workers.spawn("serve", 4, tmp_path,
                         dict(arch=ARCH, mesh=mesh, overrides=rules,
                              max_len=MAX_LEN, n_decode=N_DECODE),
                         reference["arrays"])
    split = mesh[1] == 4 or rules is not None
    for out in outs:
        assert out["cache_rows"].tolist() == [
            MAX_LEN // mesh[1] if split else MAX_LEN]
        np.testing.assert_array_equal(out["tokens"], reference["chosen"])
        np.testing.assert_allclose(out["logits"], reference["steps"],
                                   atol=2e-3, rtol=0)


def test_train_step_matches_blockwise_reference(reference, tmp_path):
    cfg, model, params = (reference[k] for k in ("cfg", "model", "params"))
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
    arrays = dict(reference["arrays"], tokens=toks)
    outs = workers.spawn("train", 4, tmp_path,
                         dict(arch=ARCH, mesh=[2, 2], opt=OPT,
                              microbatches=1, hoist=False, grads=True),
                         arrays)
    flat_want = workers.flat_numpy(want)
    flat_grads = workers.flat_numpy(grads, "g/")
    for out in outs:
        assert float(out["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert float(out["grad_norm"]) == pytest.approx(
            float(metrics["grad_norm"]), rel=1e-5)
        assert sorted(k for k in out if k.startswith("g/")) == sorted(
            flat_grads)
        for key, g in flat_grads.items():
            bar = GRAD_REL * float(np.abs(g).max()) + GRAD_ABS
            err = float(np.abs(out[key] - g).max())
            assert err <= bar, f"{key}: {err:.3e} > {bar:.3e}"
            sure = np.abs(g) > 2 * bar
            pkey = "p/" + key[2:]
            np.testing.assert_allclose(out[pkey][sure],
                                       flat_want[pkey][sure], atol=3e-5,
                                       rtol=0, err_msg=pkey)
