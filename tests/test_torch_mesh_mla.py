"""MLA under a mesh: reduced minicpm3-4b (2 layers; 4 heads, q_lora 32,
kv_lora 16, nope 8, rope 8, v 8) over 4 gloo ranks on the CPU, against
the JAX package's unsharded run on the same parameters
(``torch_mesh_families``).

The query and output heads (``q_up``, ``k_up``, ``v_up``, ``wo``) split
over ``model``, the ``lora`` projections and norms replicated. The latent
cache stays whole under the default rules (the 4 kv heads divide both
meshes' model axes) and its rows split with ``{"cache_seq": "model"}``,
``repro``'s own rule wherever the heads do not divide the axis: the
absorbed decode then exchanges the softmax partials of the rank's rows
(``acc`` of width kv_lora) and merges them.

Bars as ``torch_mesh_families`` states them.
"""
import pytest

import torch_mesh_families as fam

ARCH = "minicpm3-4b"
SPLIT = {"cache_seq": "model"}


@pytest.fixture(scope="module")
def reference():
    return fam.reference(ARCH)


@pytest.mark.parametrize("mesh", [[1, 4], [2, 2]], ids=["1x4", "2x2"])
def test_forward_matches_unsharded(reference, mesh, tmp_path):
    gap = fam.forward_gap(reference, mesh, tmp_path)
    print(f"minicpm3 {mesh}: logits within {gap:.3e}")
    assert gap <= fam.LOGIT_ATOL


@pytest.mark.parametrize("mesh,rules", [([1, 4], None), ([2, 2], None),
                                        ([1, 4], SPLIT), ([2, 2], SPLIT)],
                         ids=["1x4", "2x2", "1x4-split", "2x2-split"])
def test_prefill_and_decode_match_unsharded(reference, mesh, rules,
                                            tmp_path):
    outs = fam.check_serve(reference, mesh, tmp_path, rules)
    rows = fam.MAX_LEN // mesh[1] if rules else fam.MAX_LEN
    for out in outs:
        assert out["cache_rows"].tolist() == [rows]
        # The split decode exchanges the partials once a layer and step.
        assert int(out["all_to_all"]) == (
            fam.N_DECODE * 2 if rules else 0)


def test_train_step_matches_blockwise_reference(reference, tmp_path):
    fam.check_train(reference, tmp_path)
