"""The sequence-parallel residual (``{"act_seq": "model"}``) of jamba's
hybrid stack: reduced jamba-1.5-large-398b (two periods of one attention
and three Mamba layers, MoE on every other layer) on (1, 4) and (2, 2)
over 4 gloo ranks, against the JAX package's unsharded run
(``torch_mesh_sp``' bars). The Mamba layers gather the sequence before
``in_proj`` (the scan and the convolution read all of it, and a prefill
writes the state after its last token) and reduce-scatter ``out_proj``'s
partial sums; on (1, 4) the attention cache's rows split over the same
axis.
"""
import pytest

import torch_mesh_sp as sp


@pytest.fixture(scope="module")
def reference():
    return sp.reference("jamba-1.5-large-398b")


def test_sp_matches_unsharded(reference, tmp_path):
    sp.check(reference, tmp_path)
