"""The checks that ``test_torch_mesh_sp*.py`` share: the sequence-parallel
residual (``{"act_seq": "model"}``) of one reduced architecture over
gloo ranks, one a device of the mesh, against the JAX package's
unsharded run on the same parameters (``torch_mesh_families.reference``).

One group of 4 ranks (``torch_mesh_workers.task_sp``) runs, on (1, 4)
and then on (2, 2), the forward over 4 x 12 tokens, one planned train step over 4 x 16 (two blocks of 2 rows:
the data shards on (2, 2), two microbatches on (1, 4)) and the planned
prefill of 4 x 12 with 8 greedy decode steps; every sequence is a
multiple of the model extent, so the stream splits.

Bars: the forward's logits within 1e-4 and its aux loss within 1e-5
relative (the data shards' mean on the all-to-all MoE path, as the
reference's); prefill and decode within 1e-4 with the tokens equal; the
train step against ``jax.value_and_grad`` of the mean of the two
blocks' losses: loss and grad norm within 1e-5 relative, the gradients
leaf by leaf within 1e-4 of each leaf's largest element plus 1e-6, the
parameters after AdamW's first step within 3e-5 where the gradient fixes
their sign (``torch_mesh_families``' bars for the train step). The
forward must have issued reduce-scatters: the stream split.
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

import torch_mesh_families as fam  # noqa: E402
import torch_mesh_workers as workers  # noqa: E402

SP = {"act_seq": "model"}
ATOL = 1e-4
TRAIN_ROWS, TRAIN_SEQ = 4, 16


def reference(arch: str, **over) -> dict:
    """``torch_mesh_families.reference``'s run of reduced ``arch`` with
    the config changes ``over``, each function jitted: parameters,
    forward logits and aux loss over the whole batch and the mean over
    its halves, prefill with greedy decode; and the train step's
    tokens."""
    cfg = dataclasses.replace(j_configs.get(arch).reduced(), **over)
    model = j_build(cfg)
    params = j_init(model.template(), jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (fam.BATCH, fam.PROMPT), 0, cfg.vocab),
        np.int32)
    extra = fam.embeds(cfg, fam.BATCH, fam.MAX_LEN)
    forward = jax.jit(model.forward)

    def batch(rows):
        return {"tokens": jnp.asarray(toks[rows]),
                **{k: jnp.asarray(v[rows]) for k, v in extra.items()}}
    logits, aux = forward(params, batch(slice(None)))
    # The data shards' aux losses (the MoE's; 0 for the other FFNs).
    halves = [float(forward(params, batch(slice(a, a + 2)))[1])
              for a in (0, 2)] if cfg.is_moe else [float(aux)] * 2
    enc = {"enc_len": fam.MAX_LEN} if cfg.family == "audio" else {}
    cache = j_init(model.cache_template(fam.BATCH, fam.MAX_LEN, **enc),
                   jax.random.PRNGKey(3))
    last, cache = jax.jit(model.prefill)(params, batch(slice(None)), cache)
    decode = jax.jit(model.decode_step)
    steps, chosen = [np.asarray(last[:, 0])], []
    for _ in range(fam.N_DECODE):
        nxt = jnp.argmax(jnp.asarray(steps[-1]), axis=-1).astype(jnp.int32)
        chosen.append(np.asarray(nxt))
        last, cache = decode(params, nxt, cache)
        steps.append(np.asarray(last))
    arrays = workers.flat_numpy(params)
    arrays.update(tokens=toks, **extra)
    return dict(
        arch=arch, cfg=cfg, model=model, params=params, enc=enc,
        over=over, arrays=arrays, logits=np.asarray(logits),
        aux={1: float(aux), 2: float(np.mean(halves))},
        steps=np.stack(steps, 1), chosen=np.stack(chosen, 1),
        train_tokens=np.asarray(jax.random.randint(
            jax.random.PRNGKey(4), (TRAIN_ROWS, TRAIN_SEQ + 1), 0,
            cfg.vocab), np.int32),
        train_extra=fam.embeds(cfg, TRAIN_ROWS, TRAIN_SEQ))


def _train_reference(ref: dict):
    """``jax.value_and_grad`` of the mean of the two halves' losses and
    AdamW's first update: (loss, grads, new params, grad norm), once a
    reference. The port's step takes the same blocks: the halves are the
    data shards on (2, 2) and the two microbatches on (1, 4)."""
    if "train" in ref:
        return ref["train"]
    model, params = ref["model"], ref["params"]
    toks, extra = ref["train_tokens"], ref["train_extra"]
    n = TRAIN_ROWS // 2
    blocks = [{"tokens": jnp.asarray(toks[a:a + n, :-1]),
               "labels": jnp.asarray(toks[a:a + n, 1:]),
               **{k: jnp.asarray(v[a:a + n]) for k, v in extra.items()}}
              for a in (0, n)]

    def loss_fn(p):
        return sum(model.loss(p, b) for b in blocks) / len(blocks)
    ocfg = j_opt.AdamWConfig(**fam.OPT)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want, _, metrics = j_opt.update(params, grads,
                                    j_opt.init(params, ocfg), ocfg)
    ref["train"] = (float(loss), grads, want, float(metrics["grad_norm"]))
    return ref["train"]


MESHES = ((1, 4), (2, 2))


def check(ref: dict, tmp_path, rules=None, meshes=MESHES) -> list:
    """The port's forward, train step and serving under ``SP`` (and
    ``rules``) on each of ``meshes`` (4 ranks each, one group) against
    the reference at the bars; returns each mesh's outputs of every rank,
    their keys without the mesh's tag."""
    arrays = dict(ref["arrays"], train_tokens=ref["train_tokens"],
                  **{f"train_{k}": v for k, v in ref["train_extra"].items()})
    ranks = workers.spawn(
        "sp", 4, tmp_path,
        dict(arch=ref["arch"], cfg=ref["over"],
             meshes=[list(m) for m in meshes],
             overrides={**SP, **(rules or {})}, max_len=fam.MAX_LEN,
             n_decode=fam.N_DECODE, opt=fam.OPT,
             microbatches=[2 // m[0] for m in meshes], hoist=False,
             grads=True, **ref["enc"]),
        arrays)
    return [_check_mesh(ref, mesh, [
        {k[len(tag):]: v for k, v in out.items() if k.startswith(tag)}
        for out in ranks]) for mesh in meshes
        for tag in [f"{mesh[0]}x{mesh[1]}/"]]


def _check_mesh(ref: dict, mesh, outs: list) -> list:
    loss, grads, want, grad_norm = _train_reference(ref)
    flat_want = workers.flat_numpy(want, "train/p/")
    flat_grads = workers.flat_numpy(grads, "train/g/")
    gaps = []
    for out in outs:
        assert int(out["fwd/calls/reduce_scatter"]) > 0
        gaps.append(float(np.abs(out["fwd/logits"] - ref["logits"]).max()))
        assert float(out["fwd/aux"]) == pytest.approx(ref["aux"][mesh[0]],
                                                      rel=1e-5, abs=1e-7)
        np.testing.assert_array_equal(out["serve/tokens"], ref["chosen"])
        gaps.append(float(np.abs(out["serve/logits"] - ref["steps"]).max()))
        assert float(out["train/loss"]) == pytest.approx(loss, rel=1e-5)
        assert float(out["train/grad_norm"]) == pytest.approx(grad_norm,
                                                              rel=1e-5)
        assert sorted(k for k in out if k.startswith("train/g/")) == sorted(
            flat_grads)
        for key, g in flat_grads.items():
            bar = fam.GRAD_REL * float(np.abs(g).max()) + fam.GRAD_ABS
            err = float(np.abs(out[key] - g).max())
            assert err <= bar, f"{key}: {err:.3e} > {bar:.3e}"
            sure = np.abs(g) > 2 * bar
            pkey = "train/p/" + key[len("train/g/"):]
            np.testing.assert_allclose(out[pkey][sure],
                                       flat_want[pkey][sure], atol=3e-5,
                                       rtol=0, err_msg=pkey)
    print(f"{ref['arch']} {list(mesh)} act_seq: logits within "
          f"{max(gaps):.3e}")
    assert max(gaps) <= ATOL
    return outs
