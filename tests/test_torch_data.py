"""The port's synthetic data pipeline (``repro_torch.data``) held against
the JAX package's: every batch and stub bitwise equal for the same
(seed, step, host), and ``batch_for`` over every input shape."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import data as t_data  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


def _pipes(vocab, seq, gb, seed, host_id=0, n_hosts=1, **kw):
    return (j_pipe.TokenPipeline(j_pipe.PipelineConfig(vocab, seq, gb, seed,
                                                       **kw),
                                 host_id, n_hosts),
            t_pipe.TokenPipeline(t_pipe.PipelineConfig(vocab, seq, gb, seed,
                                                       **kw),
                                 host_id, n_hosts))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("step", [0, 1, 123])
@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (1, 2), (3, 4)])
def test_batches_are_the_references_bitwise(seed, step, host_id, n_hosts):
    jp, tp = _pipes(1000, 33, 8, seed, host_id, n_hosts)
    _same(jp.batch(step), tp.batch(step))


@pytest.mark.parametrize("kw", [dict(zipf_a=1.1), dict(doc_len_mean=16),
                                dict(eos_id=5)])
def test_config_knobs_are_the_references(kw):
    jp, tp = _pipes(257, 64, 4, 3, **kw)
    _same(jp.batch(2), tp.batch(2))


@pytest.mark.parametrize("kind", ["vision", "audio"])
def test_modality_stubs_are_the_references_bitwise(kind):
    jp, tp = _pipes(512, 16, 4, 11)
    a = jp.modality_stub(5, 9, 24, kind=kind)
    b = tp.modality_stub(5, 9, 24, kind=kind)
    assert b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_batch_structure():
    _, tp = _pipes(100, 12, 6, 0)
    b = tp.batch(3)
    assert b["tokens"].shape == (6, 12) and b["tokens"].dtype == np.int32
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].min() >= 1 and b["tokens"].max() < 100
    # A restart mid-epoch re-draws the same batch without state.
    np.testing.assert_array_equal(tp.batch(3)["labels"], b["labels"])


@pytest.mark.parametrize("arch", sorted(t_configs.ARCHS))
@pytest.mark.parametrize("shape", sorted(t_configs.SHAPES))
def test_batch_for_every_arch_and_shape(arch, shape):
    cj, ct = j_configs.get(arch).reduced(), t_configs.get(arch).reduced()
    sj = j_configs.SHAPES[shape]
    st = t_configs.SHAPES[shape]
    # A short sequence keeps the draws small; the shape's kind and the
    # family's stubs are what differ.
    sj = dataclasses.replace(sj, seq_len=min(sj.seq_len, 32))
    st = dataclasses.replace(st, seq_len=min(st.seq_len, 32))
    _same(j_pipe.batch_for(cj, sj, step=2, seed=1, reduced_batch=2),
          t_data.batch_for(ct, st, step=2, seed=1, reduced_batch=2))
