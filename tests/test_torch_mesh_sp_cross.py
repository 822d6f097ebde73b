"""The sequence-parallel residual (``{"act_seq": "model"}``) of the VLM
and the encoder-decoder over 4 gloo ranks on (1, 4) and (2, 2), against
the JAX package's unsharded runs (``torch_mesh_sp``' bars).

- Reduced llama-3.2-vision-11b: the self and cross layers gather the
  stream's sequence; the cross layers' keys and values come from the
  vision embeddings, whole on every rank.
- Reduced seamless-m4t-large-v2: the encoder's stack splits its 32
  frames (its input projection's output taken onto the ranks' blocks, its
  output gathered whole before its norm, for every cross sublayer), the
  decoder's stream its tokens; the GELU MLP's output bias is added on
  the ranks' tokens.
"""
import pytest

import torch_mesh_sp as sp


@pytest.fixture(scope="module", params=["llama-3.2-vision-11b",
                                        "seamless-m4t-large-v2"])
def reference(request):
    return sp.reference(request.param)


def test_sp_matches_unsharded(reference, tmp_path):
    sp.check(reference, tmp_path)
