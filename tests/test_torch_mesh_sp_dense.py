"""The sequence-parallel residual (``{"act_seq": "model"}``) of the dense
GQA decoder: reduced qwen2.5-3b with FSDP off, and with FSDP on under
remat "full" (the recompute re-enters the rules, the stream's axis
with them), on (1, 4) and (2, 2) over 4 gloo ranks, against the JAX
package's unsharded run (``torch_mesh_sp``' bars). Off the model axis
the stream issues no all-reduce in the forward: the embedding's sum and
every sublayer's output are reduce-scattered onto the ranks' tokens.
"""
import pytest

import torch_mesh_sp as sp

ARCH = "qwen2.5-3b"
CFGS = {"plain": {}, "fsdp-remat": {"fsdp": True, "remat": "full"}}


@pytest.fixture(scope="module", params=sorted(CFGS))
def reference(request):
    return sp.reference(ARCH, **CFGS[request.param])


def test_sp_matches_unsharded(reference, tmp_path):
    for outs in sp.check(reference, tmp_path):
        for out in outs:
            assert int(out["fwd/calls/all_reduce"]) == 0
