"""The checks that ``test_torch_mesh_xlstm.py``, ``_mla.py`` and
``_cross.py`` share: a reduced architecture run unsharded by the JAX
package on one set of parameters (forward, prefill with greedy decode),
and the port's planned steps over gloo ranks, one a device of the mesh
(``torch_mesh_workers``), held against it.

Bars: the forward's logits within 2e-3; prefill and the greedy decode
steps within 2e-3 with the tokens equal; a (2, 2) train step against
``jax.value_and_grad`` of the mean of the data shards' losses, its
gradients leaf by leaf within 1e-4 of each leaf's largest element plus
1e-6 (``test_torch_train_grads.py``'s bars) and the parameters after
AdamW's first step within 3e-5 where the gradient fixes their sign
(``test_torch_mesh_moe.py``'s).
"""
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

N_DECODE, MAX_LEN, BATCH, PROMPT = 8, 32, 4, 12
LOGIT_ATOL = 2e-3
OPT = dict(lr=1e-3, warmup_steps=1)
GRAD_REL, GRAD_ABS = 1e-4, 1e-6


def embeds(cfg, n_rows: int, frames: int) -> dict:
    """The stub modality's input of ``cfg`` (numpy, from a seed): the
    vision embeddings (the VLM) or ``frames`` audio frames (the
    encoder-decoder); none for the other families."""
    rng = np.random.default_rng(7)
    if cfg.family == "vlm":
        return {"vision_embeds": rng.standard_normal(
            (n_rows, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"audio_embeds": rng.standard_normal(
            (n_rows, frames, cfg.d_model)).astype(np.float32)}
    return {}


def reference(arch: str, plant=None, frames: int = MAX_LEN) -> dict:
    """The JAX package's reduced ``arch`` unsharded: parameters (passed
    through ``plant`` when given), forward logits, and prefill with
    ``N_DECODE`` greedy decode steps into a cache of ``MAX_LEN`` rows. The
    encoder-decoder's audio has ``frames`` frames, and its cache as many
    (the plans' cache takes ``enc_len = max_len``)."""
    cfg = j_configs.get(arch).reduced()
    model = j_build(cfg)
    params = j_init(model.template(), jax.random.PRNGKey(0))
    if plant is not None:
        params = plant(params)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                         (BATCH, PROMPT), 0, cfg.vocab),
                      np.int32)
    extra = embeds(cfg, BATCH, frames)
    batch = {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    logits, _ = model.forward(params, batch)
    enc = {"enc_len": frames} if cfg.family == "audio" else {}
    cache = j_init(model.cache_template(BATCH, MAX_LEN, **enc),
                   jax.random.PRNGKey(3))
    last, cache = model.prefill(params, batch, cache)
    steps, chosen = [np.asarray(last[:, 0])], []
    for _ in range(N_DECODE):
        nxt = jnp.argmax(jnp.asarray(steps[-1]), axis=-1).astype(jnp.int32)
        chosen.append(np.asarray(nxt))
        last, cache = model.decode_step(params, nxt, cache)
        steps.append(np.asarray(last))
    arrays = workers.flat_numpy(params)
    arrays.update(tokens=toks, **extra)
    return dict(arch=arch, cfg=cfg, model=model, params=params, enc=enc,
                arrays=arrays, logits=np.asarray(logits),
                steps=np.stack(steps, 1), chosen=np.stack(chosen, 1))


def forward_gap(ref: dict, mesh, tmp_path, **args) -> float:
    """The port's forward on ``mesh`` (every rank's full logits) against
    the reference's: the largest gap."""
    outs = workers.spawn("forward", int(np.prod(mesh)), tmp_path,
                         dict(arch=ref["arch"], mesh=mesh, **args),
                         ref["arrays"])
    return max(float(np.abs(o["logits"] - ref["logits"]).max())
               for o in outs)


def check_serve(ref: dict, mesh, tmp_path, rules=None) -> list:
    """plan_cell's prefill and greedy decode on ``mesh`` (rule
    overrides ``rules``) against the reference at the bars; returns the
    ranks' outputs (their cache rows among them)."""
    outs = workers.spawn("serve", int(np.prod(mesh)), tmp_path,
                         dict(arch=ref["arch"], mesh=mesh, overrides=rules,
                              max_len=MAX_LEN, n_decode=N_DECODE,
                              **ref["enc"]),
                         ref["arrays"])
    for out in outs:
        np.testing.assert_array_equal(out["tokens"], ref["chosen"])
        np.testing.assert_allclose(out["logits"], ref["steps"],
                                   atol=LOGIT_ATOL, rtol=0)
    return outs


def check_train(ref: dict, tmp_path, mesh=(2, 2)) -> None:
    """One planned train step on ``mesh`` against ``jax.value_and_grad``
    of the mean of the two halves' losses (the batch's, whatever the data
    extent: the halves hold as many tokens) and AdamW's update."""
    cfg, model, params = (ref[k] for k in ("cfg", "model", "params"))
    ocfg = j_opt.AdamWConfig(**OPT)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(4),
                                         (BATCH, 17), 0, cfg.vocab),
                      np.int32)
    extra = embeds(cfg, BATCH, 16)
    blocks = [{"tokens": jnp.asarray(toks[a:a + 2, :-1]),
               "labels": jnp.asarray(toks[a:a + 2, 1:]),
               **{k: jnp.asarray(v[a:a + 2]) for k, v in extra.items()}}
              for a in (0, 2)]

    def loss_fn(p):
        return sum(model.loss(p, b) for b in blocks) / len(blocks)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    want, _, metrics = j_opt.update(params, grads,
                                    j_opt.init(params, ocfg), ocfg)
    arrays = dict(ref["arrays"], tokens=toks, **extra)
    outs = workers.spawn("train", int(np.prod(mesh)), tmp_path,
                         dict(arch=ref["arch"], mesh=list(mesh), opt=OPT,
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
