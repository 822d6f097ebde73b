"""The analytic half of the port's roofline (``launch/roofline.py``):
``active_params`` and ``model_flops`` equal the JAX package's for all ten
full configs and the four input shapes, and the card's constants."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import roofline as j_roof  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import roofline as t_roof  # noqa: E402
from repro_torch.models import build  # noqa: E402

ARCHS = sorted(t_configs.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_equal_the_references(arch):
    assert t_roof.active_params(t_configs.get(arch)) == \
        j_roof.active_params(j_configs.get(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(t_configs.SHAPES))
def test_model_flops_equal_the_references(arch, shape):
    got = t_roof.model_flops(t_configs.get(arch), t_configs.SHAPES[shape])
    want = j_roof.model_flops(j_configs.get(arch), j_configs.SHAPES[shape])
    assert got == want and got > 0


def test_moe_active_params_below_total():
    cfg = t_configs.get("dbrx-132b")
    assert t_roof.active_params(cfg) < build(cfg).param_count()
    dense = t_configs.get("qwen2.5-3b")
    assert t_roof.active_params(dense) == build(dense).param_count()


def test_train_flops_are_six_n_d():
    cfg = t_configs.get("qwen2.5-3b")
    shape = t_configs.SHAPES["train_4k"]
    n = t_roof.active_params(cfg)
    assert t_roof.model_flops(cfg, shape) == \
        6.0 * n * shape.global_batch * shape.seq_len


def test_h100_constants():
    assert t_roof.HBM_BW == 3.35e12
    assert t_roof.PEAK_FLOPS_F32 == 67e12
    assert t_roof.PEAK_FLOPS_BF16 == 989e12
    assert "H100" in t_roof.CARD
