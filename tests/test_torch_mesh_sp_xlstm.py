"""The sequence-parallel residual (``{"act_seq": "model"}``) of the
xLSTM: reduced xlstm-1.3b (two periods of one mLSTM and one sLSTM layer,
4 heads) over 4 gloo ranks against the JAX package's unsharded run
(``torch_mesh_sp``' bars): its heads split on (1, 4) and (2, 2), and
whole on every rank with ``{"heads": None}`` on (1, 4), as xlstm-1.3b's
4 heads on a model axis of 8 (the mLSTM's channels still split, so its
exit is still a reduce-scatter; the sLSTM's heads run whole and its FFN
splits). The recurrences read the gathered sequence.
"""
import pytest

import torch_mesh_sp as sp


@pytest.fixture(scope="module")
def reference():
    return sp.reference("xlstm-1.3b")


@pytest.mark.parametrize("rules", [None, {"heads": None}],
                         ids=["heads-split", "heads-whole"])
def test_sp_matches_unsharded(reference, rules, tmp_path):
    sp.check(reference, tmp_path, rules,
             sp.MESHES if rules is None else ((1, 4),))
