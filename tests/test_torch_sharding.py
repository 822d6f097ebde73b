"""The port's sharding rules, placements and meshes (``repro_torch.
sharding``, ``launch.mesh``, ``models.common``) against the JAX package's
on shape-only meshes (16x16, 2x16x16, 2x2, 1x4) for all ten
architectures: ``spec_dims``, ``make_rules``, ``pspec_tree`` and
``batch_shardings`` equal exactly. Then the single-process side of the
multi-rank port: a mesh of one rank runs every collective (counted) and
plans steps bitwise equal to the unsharded ones; the refusals; the
placements of the families sharded last.
"""
import dataclasses

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models.common import P as JP  # noqa: E402
from repro.models.common import pspec_tree as j_pspec  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro.sharding.spec import spec_dims as j_spec_dims  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.sharding import ctx as t_ctx  # noqa: E402
from repro_torch.sharding import rules as t_rules  # noqa: E402
from repro_torch.sharding.spec import mesh_dims, spec_dims  # noqa: E402
from repro_torch.training import optimizer as t_opt  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

ARCHS = sorted(t_configs.ARCHS)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}}
RULES = {"_mesh_sizes": {"data": 16, "model": 16, "pod": 2},
         "batch": ("pod", "data"), "embed": "data", "heads": "model",
         "mlp": "model", "experts": "data", "expert_mlp": "model",
         "vocab": "model"}


class FakeMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)


def _norm(dims):
    """A placement as ``PartitionSpec`` keeps it: a one-axis tuple is the
    axis."""
    return [d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims]


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("shape,axes", [
    ((7168, 56, 128), ("embed", "heads", None)),
    ((7168, 64, 128), ("embed", "heads", None)),
    ((16, 6144, 10752), ("experts", "embed", "expert_mlp")),
    ((256, 4096), ("batch", None)),
    ((1, 4096), ("batch", None)),
])
def test_spec_dims_equal_the_references(shape, axes):
    assert spec_dims(shape, axes, RULES) == j_spec_dims(shape, axes, RULES)


def test_mesh_dims_keep_unit_axes():
    rules = dict(RULES, _mesh_sizes={"data": 1, "model": 1})
    assert spec_dims((64, 128), ("embed", "mlp"), rules) == [None, None]
    assert mesh_dims((64, 128), ("embed", "mlp"), rules) == \
        ["data", "model"]
    # The duplicate guard still holds: experts take data first.
    assert mesh_dims((4, 64, 8), ("experts", "embed", "expert_mlp"),
                     rules) == ["data", None, "model"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_make_rules_equal_the_references(arch, mesh):
    got = t_rules.make_rules(t_configs.get(arch), FakeMesh(MESHES[mesh]))
    want = j_rules.make_rules(j_configs.get(arch), FakeMesh(MESHES[mesh]))
    assert got == want
    assert got["_mesh"] is None
    assert t_rules.data_axes(FakeMesh(MESHES[mesh])) == \
        j_rules.data_axes(FakeMesh(MESHES[mesh]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pspec_trees_equal_the_references(arch, mesh):
    sizes = MESHES[mesh]
    ep = sizes["data"]
    t_cfg, j_cfg = t_configs.get(arch), j_configs.get(arch)
    rules = t_rules.make_rules(t_cfg, FakeMesh(sizes))
    tm, jm = t_build(t_cfg, ep_degree=ep), j_build(j_cfg, ep_degree=ep)
    for t_tmpl, j_tmpl in ((tm.template(), jm.template()),
                           (tm.cache_template(4, 256),
                            jm.cache_template(4, 256))):
        got = [_norm(s) for s in t_common.tree_leaves(
            t_common.pspec_tree(t_tmpl, rules))]
        want = [list(s) for s in _jax_leaves(j_pspec(j_tmpl, rules))]
        assert got == want
        shapes = [tuple(p.shape) for p in t_common.tree_leaves(t_tmpl)]
        assert shapes == [tuple(p.shape) for p in jax.tree.leaves(
            j_tmpl, is_leaf=lambda x: isinstance(x, JP))]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_shardings_equal_the_references(arch, mesh, monkeypatch):
    monkeypatch.setattr(j_rules, "NamedSharding", lambda m, spec: spec)
    sizes = FakeMesh(MESHES[mesh])
    t_cfg, j_cfg = t_configs.get(arch), j_configs.get(arch)
    rules = t_rules.make_rules(t_cfg, sizes)
    for name in sorted(t_configs.SHAPES):
        for kind in ("train", "prefill", "decode"):
            got = t_rules.batch_shardings(t_cfg, sizes, rules,
                                          t_configs.SHAPES[name], kind)
            want = j_rules.batch_shardings(j_cfg, sizes, rules,
                                           j_configs.SHAPES[name], kind)
            assert {k: _norm(v) for k, v in got.items()} == \
                {k: list(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b",
                                  "jamba-1.5-large-398b"])
def test_build_pads_experts_for_the_ep_degree(arch):
    for ep in (1, 16):
        assert t_build(t_configs.get(arch), ep_degree=ep).param_count() == \
            j_build(j_configs.get(arch), ep_degree=ep).param_count()
    pad = t_build(t_configs.get(arch), ep_degree=16).ep_pad
    assert pad == t_configs.get(arch).padded_experts(16) and pad % 16 == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_cover_every_param(arch):
    """Every full-config leaf gets a placement whose extents divide it."""
    sizes = MESHES["16x16"]
    cfg = t_configs.get(arch)
    rules = t_rules.make_rules(cfg, FakeMesh(sizes))
    tmpl = t_build(cfg, ep_degree=16).template()
    for p, s in zip(t_common.tree_leaves(tmpl), t_common.tree_leaves(
            t_common.pspec_tree(tmpl, rules))):
        for dim, ax in zip(p.shape, s):
            if ax is not None:
                axes = (ax,) if isinstance(ax, str) else ax
                assert dim % int(np.prod([sizes[a] for a in axes])) == 0


def test_local_template_and_shard_tree_slices():
    mesh = t_mesh.Mesh(("data", "model"), (2, 2))
    rules = {"_mesh_sizes": mesh.shape, "embed": "data", "mlp": "model"}
    tmpl = {"w": t_common.P((4, 6), ("embed", "mlp")),
            "b": t_common.P((6,), ("mlp",))}
    local = t_common.local_template(tmpl, rules)
    assert local["w"].shape == (2, 3) and local["b"].shape == (3,)
    abstract = t_common.abstract_params(tmpl)
    assert abstract["w"].device.type == "meta"
    assert tuple(abstract["w"].shape) == (4, 6)


def test_production_mesh_is_shape_only():
    m = t_mesh.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.device_mesh is None
    m2 = t_mesh.make_production_mesh(multi_pod=True)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert t_rules.make_rules(t_configs.get("yi-6b"), m2)["_mesh"] is None
    with pytest.raises(RuntimeError, match="shape-only"):
        m.group("data")


def test_meshes_refuse_what_they_cannot_run():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_mesh.make_host_mesh()


@pytest.fixture
def world_of_one():
    """A gloo group of one rank, torn down after the test."""
    assert not dist.is_initialized()
    mesh = t_mesh.make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_collectives_run_and_count_at_world_one(world_of_one):
    mesh = world_of_one
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.coord("data") == 0 and mesh.coord(("data", "model")) == 0
    rules = t_rules.make_rules(t_configs.get("qwen2.5-3b").reduced(), mesh)
    assert rules["_mesh"] is mesh
    t_ctx.reset_counts()
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    with t_ctx.activation_rules(rules):
        assert torch.equal(t_ctx.psum(x, "model"), x)
        assert torch.equal(t_ctx.all_gather(x, "data", 1), x)
        assert torch.equal(t_ctx.reduce_scatter(x, "model", 2), x)
        assert torch.equal(t_ctx.all_to_all(x, "data", 0, 1), x)
        assert torch.equal(t_ctx.pmean(x, ("data",)), x)
        g = torch.ones_like(x, requires_grad=True)
        t_ctx.enter(g, "model").sum().backward()
        assert torch.equal(g.grad, torch.ones_like(x))
    counts = {k: v["calls"] for k, v in t_ctx.counts.items()}
    assert counts == {"all_reduce": 3, "all_gather": 1,
                      "reduce_scatter": 1, "all_to_all": 1}
    assert t_ctx.counts["all_gather"]["bytes"] == x.numel() * 4


def test_constrain_checks_local_shapes(world_of_one):
    rules = t_rules.make_rules(t_configs.get("qwen2.5-3b").reduced(),
                               world_of_one)
    x = torch.zeros(2, 4, 16)
    assert t_ctx.constrain(x, ("batch", None, "heads")) is x
    with t_ctx.activation_rules(rules):
        assert t_ctx.constrain(x, ("batch", None, "heads"),
                               (2, 4, 16)) is x
        with pytest.raises(ValueError, match="constrain"):
            t_ctx.constrain(x, ("batch", None, "heads"), (2, 4, 8))


def _tree_equal(a, b):
    for x, y in zip(t_common.tree_leaves(a), t_common.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fsdp", [False, True])
def test_planned_train_step_is_bitwise_at_world_one(world_of_one, fsdp):
    cfg = dataclasses.replace(t_configs.get("qwen2.5-3b").reduced(),
                              fsdp=fsdp)
    ocfg = t_specs.opt_config(cfg)
    shape = t_configs.InputShape("t", 16, 4, "train")
    plan = t_specs.plan_cell(cfg, shape, world_of_one, n_microbatches=2,
                             hoist_fsdp_gather=True)
    assert plan.spmd.hoist == fsdp
    gen = torch.Generator().manual_seed(0)
    params = t_common.init_params(plan.model.template(), gen, device="cpu")
    toks = torch.randint(0, cfg.vocab, (4, 17), generator=gen)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    plain = make_train_step(t_build(cfg, impl="torch"), ocfg,
                            n_microbatches=2)
    want = plain(params, t_opt.init(params, ocfg), batch)
    got = plan.step_fn(*plan.shard(params, t_opt.init(params, ocfg),
                                   batch))
    _tree_equal(got[0], want[0])
    _tree_equal(got[1], want[1])
    for key in ("loss", "grad_norm", "lr"):
        assert torch.equal(got[2][key], want[2][key])


def test_planned_serving_is_bitwise_at_world_one(world_of_one):
    """The serving plans (weights held gathered, and with ``embed``
    sharded back onto ``data``, which gathers them on every call) against
    the unsharded model: bitwise."""
    cfg = dataclasses.replace(t_configs.get("qwen2.5-3b").reduced(),
                              fsdp=True)
    gen = torch.Generator().manual_seed(1)
    model = t_build(cfg, impl="torch")
    params = t_common.init_params(model.template(), gen, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    for over, gathers in ((None, False), ({"embed": "data"}, True)):
        pre, dec = (t_specs.plan_cell(
            cfg, t_configs.InputShape(kind, 16, 2, kind), world_of_one,
            impl="torch", rule_overrides=over)
            for kind in ("prefill", "decode"))
        cache = t_common.init_params(model.cache_template(2, 16), gen,
                                     device="cpu")
        t_ctx.reset_counts()
        got, got_cache = pre.step_fn(*pre.shard(params, {"tokens": toks},
                                                pre.cache()))
        assert t_ctx.counts["all_reduce"]["calls"] > 0
        # The FSDP gather, only where the plan shards the weights.
        assert (t_ctx.counts["all_gather"]["calls"] > 0) == gathers
        with torch.no_grad():
            want, cache = model.prefill(params, {"tokens": toks}, cache)
        assert torch.equal(got, want)
        for _ in range(3):
            nxt = torch.argmax(want[:, -1] if want.dim() == 3 else want,
                               dim=-1).to(torch.int32)
            got, got_cache = dec.step_fn(params, nxt, got_cache)
            with torch.no_grad():
                want, cache = model.decode_step(params, nxt, cache)
            assert torch.equal(got, want)


def test_global_norm_reduces_over_placements(world_of_one):
    tree = {"a": torch.ones(4), "b": torch.full((2, 2), 2.0)}
    placements = {"a": ["data"], "b": [None, "model"]}
    t_ctx.reset_counts()
    got = t_opt.global_norm(tree, placements, world_of_one)
    assert torch.equal(got, t_opt.global_norm(tree))
    assert t_ctx.counts["all_reduce"]["calls"] == 2


def _stub_embeds(cfg, n_rows, frames, gen) -> dict:
    if cfg.family == "vlm":
        return {"vision_embeds": torch.randn(
            n_rows, cfg.n_vision_tokens, cfg.d_model, generator=gen)}
    if cfg.family == "audio":
        return {"audio_embeds": torch.randn(n_rows, frames, cfg.d_model,
                                            generator=gen)}
    return {}


@pytest.mark.parametrize("arch,rules", [
    ("xlstm-1.3b", None), ("minicpm3-4b", None),
    ("minicpm3-4b", {"cache_seq": "model"}),
    ("llama-3.2-vision-11b", None), ("seamless-m4t-large-v2", None)],
    ids=["xlstm", "mla", "mla-split", "vlm", "encdec"])
def test_other_families_plan_bitwise_at_world_one(world_of_one, arch,
                                                  rules):
    """The families sharded last, planned on a mesh of one rank (every
    collective run over a group of one): a train step against
    make_train_step, and prefill with 3 decode steps against the
    unsharded model, all bitwise. Their order of sums is one card's:
    ``layers.own_channels`` hands on contiguous halves, the mLSTM's norm
    is one expression, a cross source sums each layer's gradient first
    and MLA's decode merges its partials with and without a mesh."""
    cfg = dataclasses.replace(t_configs.get(arch).reduced(), remat="full")
    gen = torch.Generator().manual_seed(2)
    ocfg = t_opt.AdamWConfig(lr=1e-3)
    plan = t_specs.plan_cell(cfg, t_configs.InputShape("t", 16, 2, "train"),
                             world_of_one, n_microbatches=1)
    params = t_common.init_params(plan.model.template(), gen, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=gen)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             **_stub_embeds(cfg, 2, 16, gen)}
    want = make_train_step(plan.model, ocfg)(
        params, t_opt.init(params, ocfg), batch)
    step = make_train_step(plan.model, ocfg, spmd=plan.spmd)
    got = step(*plan.shard(params, t_opt.init(params, ocfg), batch))
    _tree_equal(got[0], want[0])
    _tree_equal(got[1], want[1])
    assert torch.equal(got[2]["loss"], want[2]["loss"])

    model = t_build(cfg, impl="torch")
    batch = {"tokens": toks[:, :8], **_stub_embeds(cfg, 2, 16, gen)}
    pre, dec = (t_specs.plan_cell(
        cfg, t_configs.InputShape(kind, 16, 2, kind), world_of_one,
        impl="torch", rule_overrides=rules)
        for kind in ("prefill", "decode"))
    cache = t_common.init_params(model.cache_template(2, 16), gen,
                                 device="cpu")
    got, got_cache = pre.step_fn(*pre.shard(params, batch, pre.cache()))
    with torch.no_grad():
        want, cache = model.prefill(params, batch, cache)
    assert torch.equal(got, want)
    for _ in range(3):
        nxt = torch.argmax(want[:, -1] if want.dim() == 3 else want,
                           dim=-1).to(torch.int32)
        got, got_cache = dec.step_fn(params, nxt, got_cache)
        with torch.no_grad():
            want, cache = model.decode_step(params, nxt, cache)
        assert torch.equal(got, want)


def _fake_mesh(sizes):
    """A mesh that claims groups but has none: enough for the rules and
    placements, which move no data."""
    return t_mesh.Mesh(tuple(sizes), tuple(sizes.values()),
                       device_mesh=object(), device=torch.device("cpu"))


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "minicpm3-4b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_other_families_place_their_leaves_as_the_reference(arch):
    """The families a mesh refused until the xLSTM, MLA, the VLM and the
    encoder-decoder were sharded: on a mesh with process groups, each
    leaf of their parameters and caches (the VLM's vision rows and the
    encoder's frames among them) is placed as ``repro``'s ``make_rules``
    and ``spec_dims`` place it, and the rank's local shapes follow."""
    sizes = {"data": 1, "model": 2}
    cfg, j_cfg = t_configs.get(arch).reduced(), j_configs.get(arch).reduced()
    mesh = _fake_mesh(sizes)
    rules = t_rules.make_rules(cfg, mesh)
    want_rules = j_rules.make_rules(j_cfg, FakeMesh(sizes))
    assert rules["_mesh"] is mesh
    assert {k: v for k, v in rules.items() if k != "_mesh"} == \
        {k: v for k, v in want_rules.items() if k != "_mesh"}
    tm, jm = t_build(cfg, impl="torch"), j_build(j_cfg)
    split = 0
    for t_tmpl, j_tmpl in ((tm.template(), jm.template()),
                           (tm.cache_template(2, 8), jm.cache_template(2, 8))):
        got = [_norm(s) for s in t_common.tree_leaves(
            t_common.pspec_tree(t_tmpl, rules))]
        j_leaves = jax.tree.leaves(j_tmpl,
                                   is_leaf=lambda x: isinstance(x, JP))
        want = [j_spec_dims(p.shape, p.axes, want_rules) for p in j_leaves]
        assert got == want
        local = t_common.local_template(t_tmpl, rules)
        for p, q, dims in zip(t_common.tree_leaves(t_tmpl),
                              t_common.tree_leaves(local), got):
            assert tuple(q.shape) == tuple(
                n // (2 if d == "model" else 1)
                for n, d in zip(p.shape, dims))
        split += sum("model" in dims for dims in got)
    assert split > 0


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("shape", sorted(t_configs.SHAPES))
def test_input_specs_are_meta_of_the_cell(arch, shape):
    cfg, cell = t_configs.get(arch), t_configs.SHAPES[shape]
    out = t_specs.input_specs(cfg, cell)
    batch = out if cell.kind == "train" else out[0]
    gb, s = cell.global_batch, cell.seq_len
    want = (gb,) if cell.kind == "decode" else (gb, s)
    assert tuple(batch["tokens"].shape) == want
    assert all(t.device.type == "meta" for t in batch.values())
    assert ("labels" in batch) == (cell.kind == "train")
    if cell.kind != "train":
        cache = out[1]
        assert all(t.device.type == "meta"
                   for t in t_common.tree_leaves(cache))
        assert tuple(cache["len"].shape) == (gb,)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b", "yi-34b"])
def test_default_microbatches_and_opt_config_equal_the_references(arch):
    from repro.launch import specs as j_specs
    for mesh in MESHES.values():
        for name in sorted(t_configs.SHAPES):
            assert t_specs.default_microbatches(
                t_configs.get(arch), t_configs.SHAPES[name],
                FakeMesh(mesh)) == j_specs.default_microbatches(
                j_configs.get(arch), j_configs.SHAPES[name], FakeMesh(mesh))
    assert dataclasses.asdict(t_specs.opt_config(t_configs.get(arch))) == \
        dataclasses.asdict(j_specs.opt_config(j_configs.get(arch)))


def test_plan_cell_placements_equal_the_references(monkeypatch):
    """plan_cell's in and out placements on a shape-only 16x16 mesh
    against the JAX package's ``PartitionSpec``s (its ``plan_cell`` with
    ``NamedSharding`` replaced by the spec it holds). The port serves in
    the gathered layout: its prefill and decode plans equal the JAX
    package's with ``embed`` unsharded."""
    from repro.launch import specs as j_specs
    monkeypatch.setattr(j_specs, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(j_rules, "NamedSharding", lambda m, spec: spec)
    sizes = MESHES["16x16"]
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        over = None if name.startswith("train") else {"embed": None}
        got = t_specs.plan_cell(t_configs.get("qwen2.5-3b"),
                                t_configs.SHAPES[name], FakeMesh(sizes))
        want = j_specs.plan_cell(j_configs.get("qwen2.5-3b"),
                                 j_configs.SHAPES[name], FakeMesh(sizes),
                                 rule_overrides=over)
        assert got.rules["embed"] == (
            "data" if name.startswith("train") else None)
        assert got.kind == want.kind and got.donate == want.donate
        for g, w in zip(got.in_shardings, want.in_shardings):
            gl = [_norm(x) for x in t_common.tree_leaves(g)]
            wl = [list(x) for x in _jax_leaves(w)]
            assert gl == wl
        shapes = [tuple(t.shape) for t in t_common.tree_leaves(got.args[0])]
        assert shapes == [tuple(t.shape) for t in jax.tree.leaves(
            want.args[0])]


# ---------------------------------------------------------------------------
# Every logical axis the JAX package's models name is read by the port
# ---------------------------------------------------------------------------

def _reference_model_axes() -> set:
    """The logical axis names that ``src/repro/models/*.py`` passes to
    ``constrain`` or puts in a parameter template (``P(shape, axes)``),
    read by AST: string constants, and names bound to one at module level
    in the file or in ``models/common.py``."""
    import ast
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent / "src/repro/models"

    def constants(tree) -> dict:
        out = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Constant) and isinstance(
                    node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = node.value.value
        return out
    common = constants(ast.parse((root / "common.py").read_text()))
    axes = set()
    for path in sorted(root.glob("*.py")):
        tree = ast.parse(path.read_text())
        names = {**common, **constants(tree)}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or len(node.args) < 2:
                continue
            f = node.func
            fname = f.id if isinstance(f, ast.Name) else getattr(f, "attr",
                                                                  None)
            if fname not in ("constrain", "P"):
                continue
            spec = node.args[1]
            if not isinstance(spec, (ast.Tuple, ast.List)):
                continue
            for el in spec.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    axes.add(el.value)
                elif isinstance(el, ast.Name) and el.id in names:
                    axes.add(names[el.id])
    return axes


def test_every_reference_axis_is_read_by_the_port():
    """A rule the port stores but never reads is accepted and silently
    ignored (as ``act_seq`` was): every logical axis the JAX package's
    models lay a tensor along must be named in ``src/repro_torch`` outside
    ``sharding/rules.py``, which only stores the rules."""
    import pathlib
    src = pathlib.Path(__file__).resolve().parent.parent / "src/repro_torch"
    text = "\n".join(p.read_text() for p in sorted(src.rglob("*.py"))
                     if p.relative_to(src).as_posix() != "sharding/rules.py")
    axes = _reference_model_axes()
    assert {"act_seq", "batch", "heads", "embed"} <= axes
    missing = sorted(a for a in axes
                     if f'"{a}"' not in text and f"'{a}'" not in text)
    assert not missing, f"logical axes the port never reads: {missing}"
