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


# ---------------------------------------------------------------------------
# The per-device (dry-run) half: accounting over the sharding rules
# ---------------------------------------------------------------------------

PRODUCTION = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


class _FakeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(PRODUCTION))
def test_tree_device_bytes_equal_the_references(arch, mesh):
    from repro.models import build as j_build
    from repro.sharding.rules import make_rules as j_rules
    from repro_torch.sharding.rules import make_rules as t_rules
    sizes = PRODUCTION[mesh]
    t_cfg, j_cfg = t_configs.get(arch), j_configs.get(arch)
    for dtype_size in (2, 4):
        got = t_roof.tree_device_bytes(
            build(t_cfg, ep_degree=16).template(),
            t_rules(t_cfg, _FakeMesh(sizes)), dtype_size)
        want = j_roof.tree_device_bytes(
            j_build(j_cfg, ep_degree=16).template(),
            j_rules(j_cfg, _FakeMesh(sizes)), dtype_size)
        assert got == pytest.approx(want, rel=1e-12) and got > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(PRODUCTION))
@pytest.mark.parametrize("shape", sorted(t_configs.SHAPES))
def test_fused_memory_and_scores_equal_the_references(arch, mesh, shape):
    sizes = PRODUCTION[mesh]
    t_cfg, j_cfg = t_configs.get(arch), j_configs.get(arch)
    t_shape, j_shape = t_configs.SHAPES[shape], j_configs.SHAPES[shape]
    got = t_roof.fused_memory_bytes(t_cfg, t_shape, sizes)
    want = j_roof.fused_memory_bytes(j_cfg, j_shape, sizes)
    assert got == pytest.approx(want, rel=1e-12) and got > 0
    n = 512 if mesh == "multi" else 256
    assert t_roof.attention_score_bytes(t_cfg, t_shape, n) == \
        pytest.approx(j_roof.attention_score_bytes(j_cfg, j_shape, n),
                      rel=1e-12)


def _record(arch, shape, n, extrapolated=True):
    rec = {"arch": arch, "shape": shape, "n_devices": n,
           "mesh_name": "multi" if n == 512 else "single",
           "cost_full_hlo": {"flops": 3.1e14, "bytes": 7.7e12},
           "collectives_full_hlo": {"total_bytes": 2.2e9},
           "memory": {"argument_gib": 3.5, "temp_gib": 9.25,
                      "output_gib": 0.0, "alias_gib": 0.0}}
    if extrapolated:
        rec["extrapolated"] = {"flops": 2e14, "bytes": 5e12, "coll": 1e9}
    return rec


@pytest.mark.parametrize("arch", ["yi-6b", "dbrx-132b", "xlstm-1.3b"])
@pytest.mark.parametrize("shape", sorted(t_configs.SHAPES))
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("extrapolated", [True, False])
def test_terms_from_record_equal_the_references_per_constant(
        arch, shape, n, extrapolated):
    rec = _record(arch, shape, n, extrapolated)
    got, want = t_roof.terms_from_record(rec), j_roof.terms_from_record(rec)
    for key, t_c, j_c in (("t_compute_s", t_roof.PEAK_FLOPS,
                           j_roof.PEAK_FLOPS),
                          ("t_memory_s", t_roof.HBM_BW, j_roof.HBM_BW),
                          ("t_memory_hlo_s", t_roof.HBM_BW, j_roof.HBM_BW),
                          ("t_collective_s", t_roof.LINK_BW,
                           j_roof.LINK_BW)):
        assert got[key] * t_c == pytest.approx(want[key] * j_c, rel=1e-12)
    for key in ("arch", "shape", "mesh", "chips", "model_flops",
                "hlo_flops_per_dev", "useful_fraction",
                "mem_per_chip_raw_gib", "mem_per_chip_fused_gib"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    assert got["fits_80gb_fused"] == (
        got["mem_per_chip_fused_gib"] <= 80e9 / 2**30)
    assert "fits_16gib_fused" not in got


def test_roofline_table_and_main(tmp_path):
    import json
    d = tmp_path / "dryrun"
    d.mkdir()
    for i, (arch, shape) in enumerate([("yi-6b", "train_4k"),
                                       ("dbrx-132b", "decode_32k")]):
        (d / f"{i}.json").write_text(json.dumps(_record(arch, shape, 256)))
    (d / "skip.json").write_text(json.dumps({"skipped": "long_500k"}))
    rows = t_roof.main(["--dryrun", str(d), "--out",
                        str(tmp_path / "out" / "roofline")])
    assert [r["arch"] for r in rows] == ["yi-6b", "dbrx-132b"]
    assert all(r["suggestion"] == t_roof.suggestion(r) for r in rows)
    md = (tmp_path / "out" / "roofline.md").read_text()
    assert md == t_roof.to_markdown(rows) and "| yi-6b | train_4k |" in md
    assert json.loads((tmp_path / "out" / "roofline.json").read_text())


def test_nvlink_and_memory_constants():
    assert t_roof.PEAK_FLOPS == t_roof.PEAK_FLOPS_BF16
    assert t_roof.LINK_BW == 450e9 and t_roof.HBM_BYTES == 80e9
    assert t_roof.device_gib(t_configs.get("yi-34b"),
                             PRODUCTION["single"]) < 2.0
