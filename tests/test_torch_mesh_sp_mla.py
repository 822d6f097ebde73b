"""The sequence-parallel residual (``{"act_seq": "model"}``) of MLA:
reduced minicpm3-4b over 4 gloo ranks on (1, 4) and (2, 2), against the
JAX package's unsharded run (``torch_mesh_sp``' bars). The replicated
latent projections read the gathered sequence whole on every rank (the
stream's gather keeps the rank's block of the gradient), the heads'
output is reduce-scattered; on (1, 4) the latent cache's rows split over
the same axis.
"""
import pytest

import torch_mesh_sp as sp


@pytest.fixture(scope="module")
def reference():
    return sp.reference("minicpm3-4b")


def test_sp_matches_unsharded(reference, tmp_path):
    sp.check(reference, tmp_path)
