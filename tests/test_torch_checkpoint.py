"""The port's checkpoints (``repro_torch.training.checkpoint``): the JAX
package's round-trip, latest/cleanup, corruption, orphaned-tmp and
missing-directory tests on the port; checkpoints written by either
package restored by the other, bitwise; and the launcher's resume."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import json  # noqa: E402
import os  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.training import checkpoint as j_ckpt  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402


def _tree(seed, bf16=False):
    g = torch.Generator().manual_seed(seed)
    t = {"a": torch.randn((16, 8), generator=g),
         "b": {"c": torch.randn((4,), generator=g),
               "step": torch.tensor(3, dtype=torch.int32)}}
    if bf16:
        t["b"]["h"] = torch.randn((5, 3), generator=g).bfloat16()
    return t


def _leaves(tree):
    return [t for part in (tree if isinstance(tree, tuple) else (tree,))
            for t in tree_leaves(part)]


def _bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    tree = _tree(0, bf16=True)
    ckpt.save(str(tmp_path), 7, tree)
    restored, step = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert step == 7
    for a, b in zip(_leaves(tree), _leaves(restored)):
        _bitwise(a, b)


def test_roundtrip_of_a_tuple_tree(tmp_path):
    """The launcher saves (params, opt_state)."""
    tree = (_tree(1), {"m": _tree(2), "step": torch.tensor(5)})
    ckpt.save(str(tmp_path), 2, tree)
    restored, _ = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert isinstance(restored, tuple) and len(restored) == 2
    for a, b in zip(_leaves(tree), _leaves(restored)):
        _bitwise(a, b)


def test_latest_and_cleanup(tmp_path):
    tree = _tree(1)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 5
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 3


def test_corruption_detected(tmp_path):
    tree = _tree(2)
    d = ckpt.save(str(tmp_path), 1, tree)
    target = os.path.join(d, "leaf_00000.npy")
    data = bytearray(open(target, "rb").read())
    data[-1] ^= 0xFF
    open(target, "wb").write(bytes(data))
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), tree, device="cpu")


def test_orphan_tmp_dirs_cleaned(tmp_path):
    tree = _tree(3)
    orphan = tmp_path / "step_000000009.tmp-deadbeef"
    orphan.mkdir()
    ckpt.save(str(tmp_path), 1, tree)
    assert not orphan.exists()
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), {"a": torch.zeros(1)},
                     device="cpu")


def test_restore_structure_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree(4))
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(1)}, device="cpu")


def test_restore_defaults_to_cuda(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree(4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ckpt.restore(str(tmp_path), _tree(4))


def test_meta_is_the_references_layout(tmp_path):
    """Leaf files in ``jax.tree.leaves`` order, with the same shapes,
    dtypes (bf16 as "bfloat16") and hashes the JAX package writes."""
    tree = _tree(5, bf16=True)
    d_t = ckpt.save(str(tmp_path / "port"), 1, tree)
    jtree = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()), tree)
    d_j = j_ckpt.save(str(tmp_path / "ref"), 1, jtree)
    mt = json.load(open(os.path.join(d_t, "meta.json")))
    mj = json.load(open(os.path.join(d_j, "meta.json")))
    assert mt["leaves"] == mj["leaves"]
    assert mt["treedef"] == mj["treedef"]


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    rng = np.random.default_rng(6)
    jtree = {"w": jnp.asarray(rng.standard_normal((6, 4)), jnp.float32),
             "h": jnp.asarray(rng.standard_normal((3,)), jnp.bfloat16),
             "opt": {"step": jnp.asarray(9, jnp.int32),
                     "m": jnp.asarray(rng.standard_normal((2, 2)),
                                      jnp.float32)}}
    j_ckpt.save(str(tmp_path), 4, jtree)
    like = {"w": torch.zeros(6, 4), "h": torch.zeros(3, dtype=torch.bfloat16),
            "opt": {"step": torch.tensor(0, dtype=torch.int32),
                    "m": torch.zeros(2, 2)}}
    got, step = ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 4
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(got)):
        if a.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                b.view(torch.int16).numpy(),
                np.asarray(a).view(np.int16))
        else:
            assert str(b.dtype).endswith(str(a.dtype))
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    tree = _tree(7)
    ckpt.save(str(tmp_path), 3, tree)
    like = jax.tree.map(lambda t: jnp.zeros(t.shape), tree)
    got, step = j_ckpt.restore(str(tmp_path), like)
    assert step == 3
    for a, b in zip(tree_leaves(tree), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())


def test_reference_cannot_restore_bf16_leaves(tmp_path):
    """The JAX package writes a bf16 leaf as 'V2' records and its
    ``restore`` then refuses the 'V2' array (ROADMAP section 3); the port
    writes the same bytes and reads them back as bf16."""
    tree = {"h": torch.randn(4).bfloat16()}
    ckpt.save(str(tmp_path / "port"), 1, tree)
    with pytest.raises(TypeError, match="V2"):
        j_ckpt.restore(str(tmp_path / "port"),
                       {"h": jnp.zeros(4, jnp.bfloat16)})
    jt = {"h": jnp.asarray(tree["h"].float().numpy(), jnp.bfloat16)}
    j_ckpt.save(str(tmp_path / "ref"), 1, jt)
    with pytest.raises(TypeError, match="V2"):
        j_ckpt.restore(str(tmp_path / "ref"), jt)
    got, _ = ckpt.restore(str(tmp_path / "ref"), tree, device="cpu")
    _bitwise(got["h"], tree["h"])


class _Stop(Exception):
    pass


def test_launcher_resumes_where_it_stopped(tmp_path, monkeypatch):
    """run(steps=6) against run(steps=6, ckpt_every=3) stopped after its
    first save, then run(steps=6, resume=True): steps 3-5's losses and the
    final parameters and moments are bitwise the uninterrupted run's."""
    cfg = t_configs.get("qwen2.5-3b").reduced()
    kw = dict(steps=6, batch=2, seq=16, log_every=0, device="cpu")
    whole = t_train.run(cfg, **kw)
    real_save = ckpt.save

    def save_then_stop(*a, **k):
        real_save(*a, **k)
        raise _Stop
    monkeypatch.setattr(ckpt, "save", save_then_stop)
    with pytest.raises(_Stop):
        t_train.run(cfg, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    monkeypatch.setattr(ckpt, "save", real_save)
    assert ckpt.latest_step(str(tmp_path)) == 3
    resumed = t_train.run(cfg, ckpt_dir=str(tmp_path), ckpt_every=3,
                          resume=True, **kw)
    assert resumed["losses"] == whole["losses"][3:]
    for a, b in zip(_leaves((whole["params"], whole["opt_state"])),
                    _leaves((resumed["params"], resumed["opt_state"]))):
        assert torch.equal(a, b)
    assert ckpt.latest_step(str(tmp_path)) == 6
