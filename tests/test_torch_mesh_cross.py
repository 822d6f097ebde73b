"""The VLM and the encoder-decoder under a mesh, against the JAX
package's unsharded runs on the same parameters over 4 gloo ranks on the
CPU (``torch_mesh_families``).

- Reduced llama-3.2-vision-11b (4 layers, two periods of a cross and a
  self-attention layer; 4 heads, 2 kv heads, 8 vision tokens). On (1, 4)
  the kv heads do not divide the model axis, so the rules split the cache
  rows over it: the self-attention cache's and the vision cache's (8
  rows, 2 a rank), whose decode then runs the split and combine passes
  over every row. On (2, 2) the kv heads split and the rows stay whole.
- Reduced seamless-m4t-large-v2 (2 encoder and 2 decoder layers; 4 heads,
  4 kv heads): the non-causal encoder on the rank's heads, its output
  replicated on ``model`` and read by every decoder layer's cross
  sublayer; with ``{"cache_seq": "model", "kv_heads": None}`` the
  encoder's 32 frames split over the model axis too. With 24 frames
  against a cache of 32 rows the decode step is told the encoder's
  frames (``enc_len``) and reads them, whole or split, apart from the
  self-attention cache's rows.

Bars as ``torch_mesh_families`` states them.
"""
import pytest

import torch_mesh_families as fam

VLM, ENCDEC = "llama-3.2-vision-11b", "seamless-m4t-large-v2"
SPLIT = {"cache_seq": "model", "kv_heads": None}


@pytest.fixture(scope="module")
def vlm():
    return fam.reference(VLM)


@pytest.fixture(scope="module")
def encdec():
    return fam.reference(ENCDEC)


@pytest.fixture(scope="module")
def encdec_24():
    return fam.reference(ENCDEC, frames=24)


@pytest.mark.parametrize("mesh", [[1, 4], [2, 2]], ids=["1x4", "2x2"])
@pytest.mark.parametrize("arch", ["vlm", "encdec"])
def test_forward_matches_unsharded(arch, mesh, request, tmp_path):
    ref = request.getfixturevalue(arch)
    gap = fam.forward_gap(ref, mesh, tmp_path)
    print(f"{ref['arch']} {mesh}: logits within {gap:.3e}")
    assert gap <= fam.LOGIT_ATOL


@pytest.mark.parametrize("mesh", [[1, 4], [2, 2]], ids=["1x4", "2x2"])
def test_vlm_prefill_and_decode_match_unsharded(vlm, mesh, tmp_path):
    outs = fam.check_serve(vlm, mesh, tmp_path)
    split = mesh[1] == 4
    n_vis = vlm["cfg"].n_vision_tokens
    for out in outs:
        assert out["cache_rows"].tolist() == [
            fam.MAX_LEN // 4 if split else fam.MAX_LEN]
        assert out["enc_rows"].tolist() == [n_vis // 4 if split else n_vis]


@pytest.mark.parametrize("mesh,rules", [([1, 4], None), ([2, 2], None),
                                        ([2, 2], SPLIT)],
                         ids=["1x4", "2x2", "2x2-split"])
def test_encdec_prefill_and_decode_match_unsharded(encdec, mesh, rules,
                                                   tmp_path):
    outs = fam.check_serve(encdec, mesh, tmp_path, rules)
    rows = fam.MAX_LEN // mesh[1] if rules else fam.MAX_LEN
    for out in outs:
        assert out["cache_rows"].tolist() == [rows]
        assert out["enc_rows"].tolist() == [rows]


@pytest.mark.parametrize("rules", [None, SPLIT], ids=["whole", "split"])
def test_encdec_frames_apart_from_cache_rows(encdec_24, rules, tmp_path):
    outs = fam.check_serve(encdec_24, [2, 2], tmp_path, rules)
    for out in outs:
        assert out["cache_rows"].tolist() == [
            fam.MAX_LEN // 2 if rules else fam.MAX_LEN]
        assert out["enc_rows"].tolist() == [24 // 2 if rules else 24]


@pytest.mark.parametrize("arch", ["vlm", "encdec"])
def test_train_step_matches_blockwise_reference(arch, request, tmp_path):
    fam.check_train(request.getfixturevalue(arch), tmp_path)
