"""The sequence-parallel residual (``{"act_seq": "model"}``) of the MoE
decoder: reduced qwen2-moe-a2.7b (4 experts, top-2, one shared expert)
over 4 gloo ranks against the JAX package's unsharded run
(``torch_mesh_sp``' bars). On (1, 4) the experts are local and their MLP
columns split over ``model`` (the einsum path: the router and the
experts gather the sequence apart, the combine is reduce-scattered); on
(2, 2) the experts split over ``data`` (the all-to-all path: the
sequence gathered for the routing, the combine's columns sent onto the
ranks' tokens by one all-to-all); and on (2, 2) with ``{"experts":
"model"}`` the experts split over the stream's own axis (every rank
routes the gathered sequence and runs its experts, the combine is
reduce-scattered). The shared expert is a SwiGLU on the stream, as the
dense FFN.
"""
import pytest

import torch_mesh_sp as sp


@pytest.fixture(scope="module")
def reference():
    return sp.reference("qwen2-moe-a2.7b")


@pytest.mark.parametrize("rules", [None, {"experts": "model"}],
                         ids=["experts-on-data", "experts-on-model"])
def test_sp_matches_unsharded(reference, rules, tmp_path):
    meshes = sp.MESHES if rules is None else ((2, 2),)
    for mesh, outs in zip(meshes, sp.check(reference, tmp_path, rules,
                                           meshes)):
        for out in outs:
            # The all-to-all path's exchanges, and none on the others.
            assert (int(out["fwd/calls/all_to_all"]) > 0) == (
                mesh == (2, 2) and rules is None)
