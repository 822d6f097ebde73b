"""The port's training loss and its gradients held against the JAX
package's ``jax.value_and_grad(model.loss)`` on the CPU, for each of the
ten architectures at ``reduced()``; the three remat policies against each
other; and what each policy keeps for the backward pass.

Bars: the loss within 1e-5 relative; every gradient leaf within 1e-4 x
its own max |g| + 1e-6 (two f32 backward passes through the same
functions, summed in different orders). Parameters are made by the JAX
package's ``init_params`` and carried over by
``convert.params_from_numpy``; tokens and stub embeddings come from numpy
seeds. The caches' and states' in-place writes run only when a cache is
passed, so none of them is on this path; the gradients below are the
evidence."""
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
from torch.multiprocessing.reductions import StorageWeakRef  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves as pytree_leaves  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_ABS = 1e-6
ARCHS = sorted(t_configs.ARCHS)
AUDIO_FRAMES = 11


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models(arch, seed=0):
    cj, ct = j_configs.get(arch).reduced(), t_configs.get(arch).reduced()
    mj, mt = j_build(cj), t_models.build(ct, impl="torch")
    pj = jax.jit(lambda k: j_init(mj.template(), k))(
        jax.random.PRNGKey(seed))
    return cj, ct, mj, mt, pj


def _batch(cfg, b, s, seed):
    """numpy tokens, labels and the family's stub embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.normal(
            0, 0.3, (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_embeds"] = rng.normal(
            0, 0.3, (b, AUDIO_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _value_and_grad(model, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    gparams = tree_map(lambda _: next(it), params)
    loss = model.loss(gparams, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cj, ct, mj, mt, pj = _models(arch)
    batch = _batch(cj, 2, 8, 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(mj.loss))(
        pj, jax.tree.map(jnp.asarray, batch))
    tloss, tgrads = _value_and_grad(mt, params_from_numpy(_np(pj), "cpu"),
                                    _torch_batch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    jl = jax.tree.leaves(_np(jgrads))
    assert len(jl) == len(tgrads)
    for want, got in zip(jl, tgrads):
        got = got.numpy()
        assert got.shape == want.shape
        bar = GRAD_REL * float(np.max(np.abs(want))) + GRAD_ABS
        assert float(np.max(np.abs(got - want))) <= bar


@pytest.mark.parametrize("vocab,padded", [(200, 256), (256, 256)])
@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_softmax_xent_matches_reference(vocab, padded, z_loss):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 5, padded)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 5), dtype=np.int32)
    jl, jg = jax.value_and_grad(
        lambda x: j_layers.softmax_xent(x, jnp.asarray(labels), vocab,
                                        z_loss))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl = t_layers.softmax_xent(x, torch.from_numpy(labels), vocab, z_loss)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-10)
    if vocab < padded:
        assert float(x.grad[..., vocab:].abs().max()) == 0.0


def test_softmax_xent_bf16_logits_match_reference():
    """bf16 logits are masked in bf16, then the loss runs in f32."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 4, 64)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, 4), dtype=np.int32)
    want = j_layers.softmax_xent(jnp.asarray(logits, jnp.bfloat16),
                                 jnp.asarray(labels), 50)
    got = t_layers.softmax_xent(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(labels), 50)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

REMAT_ARCHS = ("qwen2.5-3b", "jamba-1.5-large-398b", "xlstm-1.3b",
               "qwen2-moe-a2.7b", "seamless-m4t-large-v2")


def _policy_model(arch, remat, **changes):
    ct = dataclasses.replace(t_configs.get(arch).reduced(), remat=remat,
                             **changes)
    return ct, t_models.build(ct, impl="torch")


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_gradients_equal_under_the_three_remat_policies(arch):
    """Remat changes only what the backward pass keeps: the loss and every
    gradient are bitwise equal under "none", "dots" and "full" on the
    CPU."""
    cj, _, _, _, pj = _models(arch)
    batch = _torch_batch(_batch(cj, 2, 8, 4))
    out = {}
    for remat in ("none", "dots", "full"):
        _, mt = _policy_model(arch, remat)
        out[remat] = _value_and_grad(mt, params_from_numpy(_np(pj), "cpu"),
                                     batch)
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


class _LiveOutputs(TorchDispatchMode):
    """Records the storage of every op's output; ``live_bytes`` sums those
    still alive."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.refs[st.data_ptr()] = (StorageWeakRef(st), st.nbytes())
        return out

    def live_bytes(self) -> int:
        return sum(n for ref, n in self.refs.values() if not ref.expired())


def _kept_bytes(arch, remat):
    """(bytes the saved-tensor hooks see, bytes of the forward's outputs
    still alive when it returns) for one loss at 4 layers."""
    ct, mt = _policy_model(arch, remat, n_layers=4)
    params = t_models.common.init_params(
        mt.template(), torch.Generator().manual_seed(0), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = _torch_batch(_batch(ct, 2, 32, 5))
    hooked = {}

    def pack(t):
        hooked[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    rec = _LiveOutputs()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), rec:
        loss = mt.loss(params, batch)
    live = rec.live_bytes()
    loss.backward()
    return sum(hooked.values()), live


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "xlstm-1.3b"])
def test_remat_policies_keep_less_for_backward(arch):
    """Bytes kept for the backward pass fall from "none" to "dots" to
    "full".

    ``saved_tensors_hooks`` sees what autograd saves outside the
    checkpointed periods: everything under "none", and under "dots" and
    "full" only the embedding, the logits and the loss (the non-reentrant
    checkpoint installs its own hooks inside a period, and the selective
    checkpoint keeps its saved products in its own cache, out of the
    hooks' sight). So the hooks order "none" above the other two, and the
    forward's outputs still alive when it returns (saved tensors, the
    selective checkpoint's cache and the periods' inputs) order all
    three."""
    none, dots, full = (_kept_bytes(arch, r) for r in ("none", "dots",
                                                         "full"))
    assert none[0] > dots[0] and dots[0] == full[0]
    assert none[1] > dots[1] > full[1]


def test_unknown_remat_raises():
    _, mt = _policy_model("qwen2.5-3b", "everything")
    params = t_models.common.init_params(
        mt.template(), torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.int32),
             "labels": torch.zeros((1, 3), dtype=torch.int32)}
    with pytest.raises(ValueError, match="remat"):
        mt.loss(params, batch)
    with torch.no_grad():                     # inference: no remat at all
        assert torch.isfinite(mt.loss(params, batch))
