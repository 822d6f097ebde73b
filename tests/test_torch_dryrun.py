"""The port's dry run (``repro_torch.launch.dryrun``): one rank's step of
``plan_cell`` on fake tensors over a fake process group, counted.

Held here: the depth extrapolation equals the full depth for the five
families; a dense train step's FLOPs equal the analytic count of its
products, on one rank and summed over a (2, 2) mesh; the fake group's
collective counts equal rank 0's of a real 4-rank gloo run of the same
plan (both are ``sharding.ctx.counts``, counted where the port issues a
collective: fake and real tensors take the same code path); a train
cell's argument, output and alias bytes equal the JAX package's record;
the scaled token loops equal the whole per-token trace; a record reads
through both packages' rooflines; the CLI's skipped and error records;
and the JAX package's sLSTM scan counted once, pinned.

The dry run joins (and destroys) the default process group, so this file
runs on one worker (``--dist loadfile``) with no group joined.
"""
import dataclasses
import json

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # Removed from newer jax; repro.core.queues still imports it.
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import configs, token_loop  # noqa: E402
from repro_torch.configs.base import SHAPES, InputShape  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (  # noqa: E402
    selective_scan_chunked, selective_scan_ref)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.specs import plan_cell  # noqa: E402
from repro_torch.models import build, xlstm  # noqa: E402
from repro_torch.models.common import init_params, tree_leaves  # noqa: E402
from repro_torch.models.transformer import _remat, layout  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402


def _mesh(shape):
    """A shape-only (data, model) mesh: the dry run joins its fake group
    for the cell."""
    return Mesh(("data", "model"), shape)


@pytest.fixture(autouse=True)
def _no_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()
    assert token_loop._hook is None


# ---------------------------------------------------------------------------
# Depth
# ---------------------------------------------------------------------------

FAMILIES = {"dense": "qwen2.5-3b", "moe": "qwen2-moe-a2.7b",
            "hybrid": "jamba-1.5-large-398b", "xlstm": "xlstm-1.3b",
            "encdec": "seamless-m4t-large-v2"}


def _periods(cfg, n):
    """``cfg`` with ``n`` periods, full remat (the full configs')."""
    return dataclasses.replace(dryrun._reduced_depth(cfg, n)[0],
                               remat="full")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_depth_extrapolation_matches_full_depth(family):
    cfg = _periods(configs.get(FAMILIES[family]).reduced(), 3)
    assert layout(cfg)[1] == 3
    rec = dryrun.measure_cell(cfg, InputShape("t", 8, 4, "train"),
                              _mesh((2, 2)), n_microbatches=1)
    assert rec["n_periods"] == 3 and rec["n_microbatches"] == 1
    full = {"flops": rec["cost_full_hlo"]["flops"],
            "bytes": rec["cost_full_hlo"]["bytes"],
            "coll": float(rec["collectives_full_hlo"]["total_bytes"])}
    assert rec["extrapolated"] == full
    # Each probe's own counts grow with depth: the slope is not zero.
    for key in full:
        assert rec["depth_probe"][2][key] > rec["depth_probe"][1][key]


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def _dense_products(cfg, b, s) -> int:
    """Analytic train-step FLOPs of a dense GQA decoder without remat:
    6 x the matmul weights x tokens, plus the plain attention's scores
    and values products (2 b h s s hd each), forward and backward (x3)."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = d * h * hd * 2 + d * kvh * hd * 2 + 3 * d * cfg.d_ff
    weights = cfg.n_layers * per_layer + d * cfg.padded_vocab
    attention = cfg.n_layers * 3 * 2 * (2 * b * h * s * s * hd)
    return 6 * weights * b * s + attention


def test_train_flops_equal_analytic_count():
    cfg = configs.get("qwen2.5-3b").reduced()
    assert cfg.remat == "none" and not cfg.tie_embeddings
    b, s = 4, 16
    want = _dense_products(cfg, b, s)
    shape = InputShape("t", s, b, "train")
    one = dryrun.measure_cell(cfg, shape, _mesh((1, 1)),
                              skip_extrapolation=True, n_microbatches=1)
    assert one["cost_full_hlo"]["flops"] == want
    four = dryrun.measure_cell(cfg, shape, _mesh((2, 2)),
                               skip_extrapolation=True, n_microbatches=1)
    assert four["cost_full_hlo"]["flops"] * 4 == want


def test_tally_flops_equal_flop_counter_mode():
    """The Tally's FLOPs are ``FlopCounterMode``'s on the same step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(configs.get("qwen2-moe-a2.7b").reduced(),
                              remat="full")
    with dryrun.fake_mesh((1, 2), ("data", "model")) as mesh:
        plan = plan_cell(cfg, InputShape("t", 16, 4, "train"), mesh,
                         impl="torch", n_microbatches=1)
        want = dryrun.trace_step(plan)["flops"]
        with FakeTensorMode():
            args = plan.shard(*[torch.utils._pytree.tree_map(
                lambda t: torch.empty(t.shape, dtype=t.dtype), a)
                for a in plan.args])
            with FlopCounterMode(display=False) as counter:
                plan.step_fn(*args)
    assert counter.get_total_flops() == want > 0


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------

def test_memory_of_a_train_step():
    """Arguments at their dtypes, the parameters and moments written in
    place (the step counter is a new tensor), and a temp peak above the
    logits and their gradient."""
    cfg = configs.get("qwen2.5-3b").reduced()
    b, s = 4, 16
    rec = dryrun.measure_cell(cfg, InputShape("t", s, b, "train"),
                              _mesh((1, 1)), skip_extrapolation=True,
                              n_microbatches=1)
    n = build(cfg, impl="torch").param_count()
    state = 4 * n * 3                     # f32 parameters, m and v
    mem = {k: v * 2**30 for k, v in rec["memory"].items()}
    assert mem["argument_gib"] == pytest.approx(state + 4 + 2 * 4 * b * s,
                                                abs=0.5)
    assert mem["alias_gib"] == pytest.approx(state, abs=0.5)
    assert mem["output_gib"] == pytest.approx(state + 4 + 3 * 4, abs=0.5)
    # At least the logits and their gradient, f32.
    assert mem["temp_gib"] > 2 * 4 * b * s * cfg.padded_vocab


def test_memory_equals_the_reference_record():
    """A reduced one-device train cell: the arguments' bytes equal XLA's
    ``memory_analysis`` in the JAX package's record; its outputs also
    count the output tuple's table (8 bytes a leaf), and its aliases the
    step counter, which XLA writes in place and the port makes anew."""
    from repro import configs as j_configs
    from repro.configs.base import InputShape as JShape
    from repro.launch import dryrun as j_dryrun
    from repro.launch.mesh import make_mesh
    b, s = 4, 16
    j_mesh = make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    theirs = j_dryrun.measure_cell(
        j_configs.get("qwen2.5-3b").reduced(), JShape("t", s, b, "train"),
        j_mesh, skip_extrapolation=True, n_microbatches=1)["memory"]
    cfg = configs.get("qwen2.5-3b").reduced()
    mine = dryrun.measure_cell(cfg, InputShape("t", s, b, "train"),
                               _mesh((1, 1)), skip_extrapolation=True,
                               n_microbatches=1)["memory"]
    theirs, mine = ({k: round(v * 2**30) for k, v in m.items()}
                    for m in (theirs, mine))
    n_leaves = len(tree_leaves(build(cfg, impl="torch").template()))
    # Parameters, m, v, the step counter, loss, grad_norm and lr.
    outputs = 3 * n_leaves + 4
    assert mine["argument_gib"] == theirs["argument_gib"]
    assert mine["output_gib"] + 8 * outputs == theirs["output_gib"]
    assert mine["alias_gib"] + 4 == theirs["alias_gib"]


# The bytes of the inputs each reduced serving cell's step never reads
# (batch 2, 32 rows, mesh (1, 1)), which ``jax.jit`` drops from the
# executable's arguments (``keep_unused=False``, its default): the cache's
# ``len`` at prefill (it writes a new one); jamba's three Mamba layers'
# conv states (6,144 B each: the prefill writes them from its tokens);
# the mLSTM's ``m`` (the JAX package's prefill rebuilds the state from
# m = -1e30); the VLM's cross layers' ``wk`` and ``wv`` at decode (16,384
# B each: the vision keys and values are in the cache).
UNREAD = {("qwen2.5-3b", "prefill"): 8, ("qwen2.5-3b", "decode"): 0,
          ("jamba-1.5-large-398b", "prefill"): 3 * 6144 + 8,
          ("xlstm-1.3b", "prefill"): 64 + 8,
          ("llama-3.2-vision-11b", "decode"): 2 * 16384}


@pytest.mark.parametrize("arch,kind", sorted(UNREAD),
                         ids=[f"{a}-{k}" for a, k in sorted(UNREAD)])
def test_serving_arguments_equal_the_reference_record(arch, kind):
    """A reduced one-device prefill or decode cell: the port's argument
    bytes equal XLA's ``memory_analysis`` of the JAX package's same step
    compiled with every input kept, byte for byte. The JAX package's own
    record (its ``plan.lower()``, ``jax.jit``'s default) leaves out the
    inputs its step never reads (``UNREAD``); the port counts every
    argument it is handed, which the caller holds whether or not the step
    reads it. Both sides pinned."""
    from repro import configs as j_configs
    from repro.configs.base import InputShape as JShape
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import plan_cell as j_plan_cell
    b, s = 2, 32
    j_mesh = make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    plan = j_plan_cell(j_configs.get(arch).reduced(),
                       JShape("c", s, b, kind), j_mesh)

    def args_bytes(keep_unused):
        jitted = jax.jit(plan.step_fn, in_shardings=plan.in_shardings,
                         out_shardings=plan.out_shardings,
                         donate_argnums=plan.donate, keep_unused=keep_unused)
        with plan.mesh:
            compiled = jitted.lower(*plan.args).compile()
        return compiled.memory_analysis().argument_size_in_bytes
    mine = dryrun.measure_cell(configs.get(arch).reduced(),
                               InputShape("c", s, b, kind), _mesh((1, 1)),
                               skip_extrapolation=True)["memory"]
    mine = round(mine["argument_gib"] * 2**30)
    assert mine == args_bytes(True)
    assert mine - args_bytes(False) == UNREAD[(arch, kind)]


# ---------------------------------------------------------------------------
# Collectives against real gloo ranks
# ---------------------------------------------------------------------------

COUNT_CASES = {
    "train-2x2": dict(arch="qwen2.5-3b", cfg=dict(fsdp=True), mesh=[2, 2],
                      kind="train", seq=16, batch=4, microbatches=2),
    "decode-1x4-split-cache": dict(
        arch="qwen2.5-3b", mesh=[1, 4], kind="decode", seq=32, batch=2,
        overrides={"cache_seq": "model", "kv_heads": None}),
    "train-1x4-sp": dict(arch="qwen2.5-3b", mesh=[1, 4], kind="train",
                         seq=16, batch=4, microbatches=1,
                         overrides={"act_seq": "model"}),
}


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_collectives_equal_gloo_ranks(case, tmp_path):
    args = COUNT_CASES[case]
    cfg = dataclasses.replace(configs.get(args["arch"]).reduced(),
                              **args.get("cfg", {}))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (args["batch"], args["seq"])).astype(np.int32)
    outs = workers.spawn("plan_counts", 4, tmp_path, args,
                         {"tokens": toks})
    with dryrun.fake_mesh(tuple(args["mesh"]), ("data", "model")) as mesh:
        plan = plan_cell(
            cfg, InputShape("c", args["seq"], args["batch"], args["kind"]),
            mesh, impl="torch", n_microbatches=args.get("microbatches"),
            rule_overrides=args.get("overrides"))
        got = dryrun.trace_step(plan)["collectives"]
    want = {k: {"calls": int(outs[0][f"calls/{k}"]),
                "bytes": int(outs[0][f"bytes/{k}"])} for k in got}
    assert got == want
    assert sum(v["calls"] for v in got.values()) > 0
    if args["kind"] == "decode":
        # The split cache's partials are exchanged.
        assert got["all_to_all"]["calls"] > 0
    if "act_seq" in args.get("overrides", {}):
        # The stream's sequence is scattered and gathered.
        assert got["reduce_scatter"]["calls"] > 0
        assert got["all_gather"]["calls"] > 0


# ---------------------------------------------------------------------------
# The sequence-parallel residual (act_seq)
# ---------------------------------------------------------------------------

SP = {"act_seq": "model"}


def _sp_trace(seq: int, overrides=None):
    """The reduced dense train cell (4 x ``seq`` tokens) on a fake (1, 4)
    mesh under ``overrides``: (its record, the shape of every all-reduced
    tensor)."""
    from repro_torch.sharding import ctx
    cfg = configs.get("qwen2.5-3b").reduced()
    shapes = []
    count = ctx.count

    def record(kind, t):
        if kind == "all_reduce":
            shapes.append(tuple(t.shape))
        count(kind, t)
    ctx.count = record
    try:
        rec = dryrun.measure_cell(cfg, InputShape("t", seq, 4, "train"),
                                  _mesh((1, 4)), skip_extrapolation=True,
                                  n_microbatches=1, rule_overrides=overrides)
    finally:
        ctx.count = count
    return rec, shapes


def test_sp_record_splits_the_stream():
    """With ``{"act_seq": "model"}`` the arguments are the same, the temp
    bytes lower (the stream's activations a rank's block of the
    sequence), reduce-scatters and all-gathers stand where the stream's
    all-reduces were, and no [b, s, d] stream is all-reduced."""
    plain, plain_shapes = _sp_trace(16)
    sp, sp_shapes = _sp_trace(16, SP)
    stream = (4, 16, configs.get("qwen2.5-3b").reduced().d_model)
    assert stream in plain_shapes
    assert stream not in sp_shapes
    assert sp["memory"]["argument_gib"] == plain["memory"]["argument_gib"]
    assert sp["memory"]["temp_gib"] < plain["memory"]["temp_gib"]
    pc, sc = (r["collectives_full_hlo"]["counts"] for r in (plain, sp))
    assert sc["all-reduce"] < pc["all-reduce"]
    assert sc["reduce-scatter"] > pc["reduce-scatter"]
    assert sc["all-gather"] > pc["all-gather"]


def test_sp_off_where_the_axis_does_not_divide_the_sequence():
    """15 tokens on a model axis of 4: the rule resolves to replication,
    and the step's collectives are the plain plan's."""
    plain, _ = _sp_trace(15)
    sp, _ = _sp_trace(15, SP)
    for key in ("collectives_full_hlo", "memory", "cost_full_hlo"):
        assert sp[key] == plain[key]


# ---------------------------------------------------------------------------
# Token loops
# ---------------------------------------------------------------------------

S = 32


def _slstm(grad, remat="none"):
    """The sLSTM over S tokens, under ``remat`` as a period is."""
    cfg = dataclasses.replace(configs.get("xlstm-1.3b").reduced(),
                              remat=remat)
    gen = torch.Generator().manual_seed(0)
    params = init_params(xlstm.slstm_template(cfg), gen, device="cpu")
    x = torch.randn(2, S, cfg.d_model, generator=gen)
    for t in (*params.values(), x):
        t.requires_grad_(grad)
    fn = _remat(lambda x: xlstm.slstm_apply(params, x, cfg), cfg, params)
    return lambda: fn(x)


def _scan(grad, remat="none"):
    """The Mamba scan over S tokens, under ``remat``."""
    gen = torch.Generator().manual_seed(0)
    b, inner, n = 2, 16, 4
    ops = [torch.randn(b, S, inner, generator=gen),
           torch.rand(b, S, inner, generator=gen),
           -torch.rand(inner, n, generator=gen),
           torch.randn(b, S, n, generator=gen),
           torch.randn(b, S, n, generator=gen),
           torch.randn(inner, generator=gen),
           torch.randn(b, inner, n, generator=gen)]
    for t in ops:
        t.requires_grad_(grad)
    cfg = dataclasses.replace(configs.get("jamba-1.5-large-398b").reduced(),
                              remat=remat)
    fn = _remat(lambda *o: selective_scan_ref(*o)[0], cfg,
                {"A": ops[2], "D": ops[5]})
    return lambda: fn(*ops)


def _chunked(grad, remat="none"):
    """The chunked Mamba scan over S tokens in chunks of S / 4 (the hook
    runs chunks 0, 1 and 2, chunk 1 counted twice), with h0, under
    ``remat``."""
    gen = torch.Generator().manual_seed(1)
    b, inner, n = 2, 16, 4
    ops = [torch.randn(b, S, inner, generator=gen),
           torch.rand(b, S, inner, generator=gen),
           -torch.rand(inner, n, generator=gen),
           torch.randn(b, S, n, generator=gen),
           torch.randn(b, S, n, generator=gen),
           torch.randn(inner, generator=gen),
           torch.randn(b, inner, n, generator=gen)]
    for t in ops:
        t.requires_grad_(grad)
    cfg = dataclasses.replace(configs.get("jamba-1.5-large-398b").reduced(),
                              remat=remat)
    fn = _remat(lambda *o: selective_scan_chunked(*o, chunk=S // 4)[0],
                cfg, {"A": ops[2], "D": ops[5]})
    return lambda: fn(*ops)


def _count(fn, scaled: bool, grad: bool) -> dict:
    tally = dryrun.Tally()
    hook = dryrun.scaled_loop(tally) if scaled else \
        (lambda n, step: [step(t) for t in range(n)])
    with tally, token_loop.hooked(hook), torch.set_grad_enabled(grad):
        y = fn()
        fwd = dict(live=tally.live, peak=tally.peak)
        if grad:
            y.square().sum().backward()
    return dict(flops=tally.flops, bytes=tally.bytes, fwd=fwd,
                peak=tally.peak, live=tally.live)


@pytest.mark.parametrize("mode", ["serve", "train", "train-remat-full",
                                  "train-remat-dots"])
@pytest.mark.parametrize("loop", ["slstm", "scan", "chunked"])
def test_token_scaling_equals_whole_trace(loop, mode):
    """Tokens 0, 1, 2 with token 1 counted s - 2 times against all s
    tokens traced (chunks, for the chunked scan): FLOPs, bytes, the bytes
    kept for the backward pass, the forward's and the whole step's peak,
    exactly; under remat the backward pass runs the loop again (the
    recompute)."""
    grad = mode != "serve"
    remat = mode.split("-")[-1] if "remat" in mode else "none"
    make = {"slstm": _slstm, "scan": _scan, "chunked": _chunked}[loop]
    whole = _count(make(grad, remat), False, grad)
    scaled = _count(make(grad, remat), True, grad)
    assert scaled == whole
    assert whole["bytes"] > 0
    if loop != "scan":
        assert whole["flops"] > 0


def test_token_scaling_equals_whole_trace_in_a_train_step():
    """A planned train step of the xLSTM on (1, 2) with full remat: every
    count, the collectives and the temp peak equal the whole per-token
    trace's."""
    cfg = dataclasses.replace(configs.get("xlstm-1.3b").reduced(),
                              remat="full")
    with dryrun.fake_mesh((1, 2), ("data", "model")) as mesh:
        plan = plan_cell(cfg, InputShape("t", 16, 2, "train"), mesh,
                         impl="torch", n_microbatches=1)
        whole = dryrun.trace_step(plan, scale_tokens=False)
        scaled = dryrun.trace_step(plan)
    assert scaled == whole


def test_chunk_scaling_equals_whole_trace_in_a_jamba_train_step(
        monkeypatch):
    """A planned train step of reduced jamba (its Mamba layers through the
    chunked scan, plan_cell's train default) on (1, 2) at 1,024 tokens,
    four chunks of 256 a layer: every count, the collectives and the temp
    peak equal the whole trace's, chunk by chunk."""
    seen = []
    real = dryrun.scaled_loop

    def spy(tally):
        hook = real(tally)
        return lambda n, step: seen.append(n) or hook(n, step)
    monkeypatch.setattr(dryrun, "scaled_loop", spy)
    cfg = configs.get("jamba-1.5-large-398b").reduced()
    with dryrun.fake_mesh((1, 2), ("data", "model")) as mesh:
        plan = plan_cell(cfg, InputShape("t", 1024, 1, "train"), mesh,
                         n_microbatches=1)
        assert plan.model.ssm_impl == "chunked"
        whole = dryrun.trace_step(plan, scale_tokens=False)
        scaled = dryrun.trace_step(plan)
    assert seen and set(seen) == {4}
    assert scaled == whole


def test_token_hook_is_invisible_outside_the_dry_run():
    """The sLSTM and the scan give bitwise the same outputs through the
    hooked loop run whole as through ``token_loop.run``."""
    fn = _slstm(False)
    plain = fn()
    with token_loop.hooked(lambda n, step: [step(t) for t in range(n)]):
        hooked = fn()
    assert torch.equal(plain, hooked)
    with pytest.raises(RuntimeError):
        with token_loop.hooked(lambda n, step: None):
            with token_loop.hooked(lambda n, step: None):
                pass


def test_token_hook_reaches_other_threads():
    """The autograd engine runs a CUDA backward pass, and remat's
    recompute of a loop in it, on a thread of its own: the hook is the
    process's, so that thread runs the loop through it too."""
    import threading
    seen = []
    with token_loop.hooked(lambda n, step: seen.append(n) or []):
        worker = threading.Thread(target=token_loop.run,
                                  args=(5, lambda t: t))
        worker.start()
        worker.join()
    assert seen == [5]
    assert token_loop.run(3, lambda t: t) == [0, 1, 2]


# ---------------------------------------------------------------------------
# Records, the CLI and refusals
# ---------------------------------------------------------------------------

def test_record_reads_through_both_rooflines(tmp_path):
    from repro.launch import roofline as j_roofline
    cfg = configs.get("qwen2.5-3b")
    rec = dryrun.measure_cell(cfg, SHAPES["decode_32k"],
                              make_production_mesh(),
                              skip_extrapolation=True)
    rec["mesh_name"] = "single"
    rec = json.loads(json.dumps(rec))       # as build_table reads it
    assert rec["n_devices"] == 256 and rec["mesh"] == [16, 16]
    assert set(rec["collectives_full_hlo"]["bytes"]) == set(
        dryrun.COLLECTIVES)
    assert rec["collectives_full_hlo"]["bytes"]["collective-permute"] == 0
    mine, theirs = roofline.terms_from_record(rec), \
        j_roofline.terms_from_record(rec)
    # The same keys, but for the fit flag, which names each card's memory.
    assert set(mine) - {"fits_80gb_fused"} == \
        set(theirs) - {"fits_16gib_fused"}
    assert mine["model_flops"] == theirs["model_flops"]
    assert mine["hlo_flops_per_dev"] == rec["cost_full_hlo"]["flops"] > 0
    (tmp_path / "cell.json").write_text(json.dumps(rec))
    (row,) = roofline.build_table(str(tmp_path))
    assert row["arch"] == "qwen2.5-3b" and row["dominant"] in (
        "compute", "memory", "collective")


def test_cli_writes_skipped_and_error_records(tmp_path, monkeypatch):
    out = str(tmp_path)
    # long_500k is quadratic for full attention: skipped, as the JAX
    # package's CLI skips it.
    n_fail = dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                          "--mesh", "single", "--out", out])
    assert n_fail == 0
    rec = json.loads((tmp_path / "qwen2.5-3b__long_500k__single.json")
                     .read_text())
    assert rec["skipped"].startswith("full attention")

    # A cell that raises: an error record with its reason.
    def fail(cfg, shape, mesh, **kw):
        raise ValueError(f"cannot count {cfg.name}")
    monkeypatch.setattr(dryrun, "measure_cell", fail)
    n_fail = dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                          "--mesh", "single", "--out", out, "--fast"])
    assert n_fail == 1
    rec = json.loads((tmp_path / "qwen2.5-3b__decode_32k__single.json")
                     .read_text())
    assert rec["error"] == "cannot count qwen2.5-3b" and "traceback" in rec
    assert roofline.build_table(out) == []


def test_refusals():
    cfg = configs.get("qwen2.5-3b").reduced()
    shape = InputShape("d", 32, 2, "decode")
    with pytest.raises(ValueError, match="plain versions"):
        dryrun.measure_cell(cfg, shape, _mesh((1, 1)), impl="auto")
    # A real group joined: the dry run never takes it over.
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="group is joined"):
            dryrun.measure_cell(cfg, shape, _mesh((1, 1)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX package's scan over tokens, counted once (ROADMAP section 3)
# ---------------------------------------------------------------------------

def test_reference_slstm_scan_counted_once():
    """XLA's cost_analysis counts a lax.scan body once: the JAX package's
    ``slstm_apply`` costs slope x s + one cell at every s, the recurrence
    left out of the slope. The port counts every token's cell: its FLOPs
    are s x (the cell's products + the token's projections and FFN),
    with nothing left over."""
    from repro import configs as j_configs
    from repro.launch.dryrun import cost_analysis
    from repro.models import xlstm as j_xlstm
    from repro.models.common import init_params as j_init
    cfg = j_configs.get("xlstm-1.3b").reduced()
    params = j_init(j_xlstm.slstm_template(cfg), jax.random.PRNGKey(0))
    b, h = 2, cfg.n_heads
    hd = cfg.d_model // h

    def flops(fn, *a):
        return cost_analysis(jax.jit(fn).lower(*a).compile())["flops"]

    ref = {s: flops(lambda p, x: j_xlstm.slstm_apply(p, x, cfg), params,
                    jnp.zeros((b, s, cfg.d_model), jnp.float32))
           for s in (16, 64, 256)}
    state = {k: jnp.zeros((b, h, hd)) for k in ("c", "n", "h")}
    state["m"] = jnp.zeros((b, h))
    cell = flops(lambda p, xt, st: j_xlstm._slstm_cell(p, xt, st), params,
                 jnp.zeros((b, 4, h, hd)), state)
    slope = (ref[64] - ref[16]) / 48
    assert (ref[256] - ref[64]) / 192 == pytest.approx(slope, rel=1e-6)
    for s, f in ref.items():
        assert f - slope * s == pytest.approx(cell, abs=8)

    tcfg = configs.get("xlstm-1.3b").reduced()
    tparams = init_params(xlstm.slstm_template(tcfg),
                          torch.Generator().manual_seed(0), device="cpu")
    ff = xlstm._slstm_ff(tcfg)
    d = tcfg.d_model
    per_token = 2 * b * (h * hd * 4 * hd + d * 4 * d + 2 * d * ff)
    for s in (16, 64):
        got = _count(lambda: xlstm.slstm_apply(
            tparams, torch.zeros(b, s, d), tcfg), True, False)["flops"]
        assert got == s * per_token


def test_reference_chunked_scan_counted_once():
    """The JAX package's ``selective_scan_chunked`` (its models' default
    Mamba scan) under cost_analysis: the chunk body, one
    ``selective_scan_ref`` of ``chunk`` tokens from h0, counted once and
    2 FLOPs of loop counter beside it, at every length (a slope of 0 in
    s). The port counts every chunk's products: 2 x b x s x inner x n
    FLOPs (the einsum with C), linear in s."""
    from repro.kernels.selective_scan import ref as j_scan
    from repro.launch.dryrun import cost_analysis
    b, inner, n, chunk = 2, 16, 4, 32

    def zeros(s, h0):
        return ([jnp.zeros((b, s, inner))] * 2 + [jnp.zeros((inner, n))]
                + [jnp.zeros((b, s, n))] * 2 + [jnp.zeros((inner,))]
                + ([jnp.zeros((b, inner, n))] if h0 else []))

    def flops(fn, s, h0=False):
        return cost_analysis(jax.jit(fn).lower(*zeros(s, h0)).compile())[
            "flops"]

    body = flops(j_scan.selective_scan_ref, chunk, h0=True)
    ref = {s: flops(lambda *a: j_scan.selective_scan_chunked(
        *a, chunk=chunk), s) for s in (2 * chunk, 4 * chunk, 8 * chunk)}
    assert body > 0 and set(ref.values()) == {body + 2}
    # The whole-sequence associative form grows with s.
    assert flops(j_scan.selective_scan_ref, 8 * chunk) > 8 * flops(
        j_scan.selective_scan_ref, chunk)

    for s in (2 * chunk, 8 * chunk):
        ops = [torch.zeros(t.shape) for t in zeros(s, False)]
        got = _count(lambda: selective_scan_chunked(*ops, chunk=chunk),
                     True, False)["flops"]
        assert got == 2 * b * s * inner * n
