"""The xLSTM under a mesh: reduced xlstm-1.3b (4 layers, two periods of
one mLSTM and one sLSTM layer; 4 heads, inner 128) over 4 gloo ranks on
the CPU, against the JAX package's unsharded run on the same parameters
(``torch_mesh_families``).

- (1, 4): one head a rank. The mLSTM's ``up_proj`` block is exchanged
  onto the rank's channels, its gates reduce-scattered onto its heads,
  ``out_norm``'s sum of squares all-reduced; the sLSTM's output
  all-gathered before its column-parallel FFN.
- (2, 2): two heads a rank, the batch over ``data``.
- (1, 8), over 8 ranks: the model axis does not divide the 4 heads, so
  they stay whole on every rank while the 128 inner channels split (16 a
  rank), as the rules place xlstm-1.3b's 4 heads and 4,096 channels on a
  model axis of 8 or 16. The mLSTM gathers the rank's channels of ``xu``
  onto every head, all-reduces the gates, and keeps its channels after
  the whole-width norm for the row-parallel ``down_proj``; the sLSTM's
  heads stay whole and only its FFN splits.

Bars as ``torch_mesh_families`` states them. ``out_norm`` is one RMS norm
over the whole inner width: with the value projection of head 0 planted
8x larger, the ranks' sums of squares differ by ~64x, so a norm over the
rank's channels alone misses the reference by far more than the bar
(``test_out_norm_spans_the_whole_width``).
"""
import numpy as np
import pytest

import torch_mesh_families as fam

ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def reference():
    return fam.reference(ARCH)


def _plant(params):
    """Head 0's value projection in every mLSTM layer 8x larger."""
    blocks = dict(params["blocks"])
    p0 = dict(blocks["p0"])
    mixer = dict(p0["mixer"])
    mixer["wv"] = mixer["wv"].at[:, 0].multiply(8.0)
    p0["mixer"] = mixer
    blocks["p0"] = p0
    return dict(params, blocks=blocks)


MESHES = pytest.mark.parametrize("mesh", [[1, 4], [2, 2], [1, 8]],
                                 ids=["1x4", "2x2", "1x8"])


@MESHES
def test_forward_matches_unsharded(reference, mesh, tmp_path):
    gap = fam.forward_gap(reference, mesh, tmp_path)
    print(f"xlstm {mesh}: logits within {gap:.3e}")
    assert gap <= fam.LOGIT_ATOL


@MESHES
def test_prefill_and_decode_match_unsharded(reference, mesh, tmp_path):
    outs = fam.check_serve(reference, mesh, tmp_path)
    # No attention layer: no cache rows to split.
    assert all(o["cache_rows"].size == 0 for o in outs)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 8)], ids=["2x2", "1x8"])
def test_train_step_matches_blockwise_reference(reference, mesh, tmp_path):
    fam.check_train(reference, tmp_path, mesh)


def test_out_norm_spans_the_whole_width(tmp_path):
    ref = fam.reference(ARCH, plant=_plant)
    gap = fam.forward_gap(ref, [1, 4], tmp_path / "whole")
    local = fam.forward_gap(ref, [1, 4], tmp_path / "local",
                            local_norm=True)
    print(f"planted xlstm (1, 4): whole-width norm within {gap:.3e}, "
          f"rank-local norm off by {local:.3e}")
    assert gap <= fam.LOGIT_ATOL
    assert local > 100 * fam.LOGIT_ATOL
    assert np.isfinite(local)
