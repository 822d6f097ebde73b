"""Dry run: the per-device accounting of every (architecture x input
shape x mesh) cell (the JAX package's ``launch/dryrun.py``).

For each cell one rank's step of ``specs.plan_cell`` runs on fake tensors
(``FakeTensorMode``: shapes and dtypes, no data) over a fake default
process group of the mesh's 256 or 512 ranks (``torch.distributed``'s
"fake" backend: every collective returns at once), under a dispatch mode
that counts (``Tally``). One JSON record per cell, in the JAX package's
format, so that ``roofline.terms_from_record`` and ``build_table`` read
it unchanged:

  memory              argument_gib: the rank's input slices at their
                      dtypes (what XLA's ``memory_analysis`` reports, not
                      ``roofline.tree_device_bytes``' two bytes a leaf);
                      temp_gib: the peak of live storages beyond them;
                      output_gib: the outputs' bytes; alias_gib: the
                      outputs that are argument storages written in place
                      (the donated parameters and moments, or cache).
  cost_full_hlo       flops: ``torch.utils.flop_counter``'s formulas over
                      every op, the backward pass and remat's recompute
                      included; bytes: the input and output bytes of
                      every aten op, views and bare allocations excluded
                      (a count before fusion, as XLA's "bytes accessed").
  collectives_full_hlo
                      ``sharding.ctx.counts`` of the step, rank 0's calls
                      and result bytes counted where the model issues
                      them, under the JAX package's five kind names
                      (``all_to_all_v`` counts as all-to-all;
                      collective-permute stays 0).
  extrapolated        FLOPs, bytes and collective bytes from probes of 1
                      and 2 periods at one microbatch, as the JAX package
                      extrapolates them. The layer loop is Python, so the
                      full-depth run counts every layer and the
                      extrapolation only saves time; it equals the full
                      depth at one microbatch.
  compile_s           the seconds the full run took.

There is no HLO, so the JAX package's ``cost_analysis`` and
``collective_bytes`` (which parse XLA's objects and HLO text) have no
counterpart.

Where these records differ from the JAX package's, by design:

  * Prefill and decode plans keep the weights gathered
    (``specs.plan_cell``): their collective bytes leave out the all-gather
    of the FSDP weights that the JAX package's plan makes on every call.
  * The token recurrences (the sLSTM, the Mamba scan's chunks) are
    counted at every token and every chunk. XLA's ``cost_analysis``
    counts a ``lax.scan`` body once; the JAX package's depth
    extrapolation repairs that for the scan over layers, not for the
    scans over tokens or chunks, so its records count each token
    recurrence, and the chunked scan's chunk, once.
  * FLOPs are the products that ``FlopCounterMode`` counts (matmuls,
    convolutions, attention); XLA counts elementwise work too.
  * n_microbatches is the train plan's count (None for serving); the JAX
    package's record always holds None.

The per-token loops, and the chunked Mamba scan's loop over chunks (a
"token" of the hook below is then a chunk), run through
``token_loop.run``, hooked while a step is counted (``scaled_loop``): a
loop of n >= 3 tokens runs tokens 0, 1 and 2, and token 1 counts n - 2
times (its FLOPs, bytes and collectives, its autograd nodes' backward
work, and the storages it leaves alive, which the backward pass frees
one token's worth at a time), so the first and last tokens keep their
own work. This equals the whole per-token trace, remat's recompute of
the loop in the backward pass included. The backward pass's share reads
private autograd internals (``torch._C._current_autograd_node``,
``_sequence_nr``, ``_top_saved_tensors_default_hooks``), so its
exactness is known only for the torch versions it has been held on: 2.13
(the CPU tests) and 2.11 (``chip_smoke.py`` phase 13 (d), on the card's
tensors).

Only the plain versions run (``impl="torch"``, the counterpart of the JAX
package's ``--impl ref``): the hand-written kernels launch through
ctypes on real pointers, which a fake tensor does not have. The plain
attention materialises its scores; ``roofline.attention_score_bytes`` is
the correction, as in the JAX package.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both --out results/dryrun [--fast]
    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun \
        results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import configs, token_loop
from ..configs.base import ALL_SHAPES, shape_supported
from ..sharding import ctx as shard_ctx
from .mesh import Mesh, make_production_mesh
from .specs import plan_cell

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# ``sharding.ctx``'s kinds under the JAX package's names.
KIND_NAMES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
              "reduce_scatter": "reduce-scatter",
              "all_to_all": "all-to-all"}
# Allocations that write nothing: no bytes accessed.
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


class _Scaled:
    """A token that counts ``weight`` times: its autograd nodes' sequence
    numbers [lo, hi) (the loop's last token's end at ``end``), the
    storages it leaves alive (``infos``), the op count at which the
    loop's backward began (``started``), and the bytes whose release waits
    for the token's backward to end (``deferred``). A token run again by
    remat's recompute in the backward pass has the sequence number of the
    node that asked for it (``trigger``) and hands its storages to the
    token of the forward pass that it repeats."""

    def __init__(self, lo: int, hi: int, end: int, weight: int,
                 trigger=None):
        self.lo, self.hi, self.end, self.weight = lo, hi, end, weight
        self.trigger = trigger
        self.infos = []
        self.started = None
        self.deferred = 0


def _backward_node():
    """The autograd node whose backward runs now, or None: outside the
    backward pass, and in remat's recompute (which runs with grad on,
    under the checkpoint's saved-tensor hooks)."""
    node = torch._C._current_autograd_node()
    if node is None or torch.is_grad_enabled() or \
            torch._C._autograd._top_saved_tensors_default_hooks(True):
        return None
    return node


class Tally(TorchDispatchMode):
    """Counts the ops dispatched under it: FLOPs (``flop_registry``'s
    formulas, with ``FlopCounterMode``'s rule that an op without one runs
    decomposed where it can), bytes accessed, and the live bytes of the
    storages they allocate (each released by a weakref finaliser when its
    storage dies) and their peak.

    ``weight`` multiplies forward work (a scaled token's); ``scaled``
    holds the ``_Scaled`` tokens, whose autograd nodes' backward work is
    multiplied by their weights; storages allocated while ``fresh`` is a
    list are appended to it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.weight = 1
        self.scaled = []
        self.fresh = None
        # id(storage) -> [nbytes, weight, _Scaled, the op count at
        # allocation if the backward pass allocated it, else None]
        self._storages = {}
        self._clock = 0
        self._depth = 0

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        info = [st.nbytes(), 1, None,
                None if _backward_node() is None else self._clock]
        self._storages[key] = info
        weakref.finalize(st, self._release, key).atexit = False
        self.live += info[0]
        self.peak = max(self.peak, self.live)
        if self.fresh is not None:
            self.fresh.append((weakref.ref(st), info))

    def _release(self, key) -> None:
        nbytes, weight, token, stamp = self._storages.pop(key)
        node = _backward_node()
        if node is not None and weight > 1 and token in self.scaled:
            # Freed in the backward pass before the scaled token's own has
            # ended: the tokens it stands for free theirs one by one, each
            # in its own backward.
            self.live -= nbytes
            token.deferred += (weight - 1) * nbytes
            return
        if node is not None and weight == 1:
            seq = node._sequence_nr()
            for running in self.scaled:
                if running.lo <= seq < running.hi and \
                        None not in (running.started, stamp) and \
                        stamp < running.started:
                    # A gradient the backward pass made before the loop's
                    # (the loop's output gradient, handed to every
                    # token), freed by the scaled token's: the whole loop
                    # frees it after its last middle token.
                    running.deferred += nbytes
                    return
        self.live -= nbytes * weight

    def _settle(self, token: _Scaled) -> None:
        self.live -= token.deferred
        self.scaled.remove(token)

    def _adopt(self, rerun: list) -> None:
        """Hand the storages of tokens that a recompute ran (one trigger:
        the loops of one remat region, in forward order) to the forward
        pass's tokens they repeat: that region's, the last ones still
        open below the trigger."""
        first = [t for t in self.scaled
                 if t.trigger is None and t.lo < rerun[0].trigger]
        first = sorted(first, key=lambda t: t.lo)[-len(rerun):]
        for again, token in zip(sorted(rerun, key=lambda t: t.lo), first):
            assert again.weight == token.weight
            for info in again.infos:
                info[2] = token
            token.infos += again.infos
        for again in rerun:
            self.scaled.remove(again)

    def _weight(self) -> int:
        """The weight of the op about to run: the forward weight, else
        that of the scaled token whose backward node runs it. A scaled
        token whose backward has ended (the engine runs a node created
        before it) releases what it deferred; tokens of a recompute that
        has ended hand their storages over."""
        if self.weight != 1 or not self.scaled:
            return self.weight
        node = _backward_node()
        if node is None:
            return 1
        seq = node._sequence_nr()
        rerun = {}
        for token in self.scaled:
            if token.trigger is not None and seq < token.lo:
                rerun.setdefault(token.trigger, []).append(token)
        for group in rerun.values():
            self._adopt(group)
        w = 1
        for token in list(self.scaled):
            if token.started is None and token.lo <= seq < token.end:
                token.started = self._clock
            if token.lo <= seq < token.hi:
                w = token.weight
            elif seq < token.lo:
                self._settle(token)
        return w

    def __enter__(self):
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:             # the outer block, not a decompose
            for token in list(self.scaled):
                self._settle(token)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        self._clock += 1
        w = self._weight()
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += w * int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
        if func.namespace == "aten" and not func.is_view \
                and packet not in _ALLOCATIONS:
            self.bytes += w * sum(map(_nbytes, _tensors((args, kwargs,
                                                          out))))
        for t in _tensors(out):
            self.track(t)
        return out


def _counts_snapshot() -> dict:
    return {k: dict(v) for k, v in shard_ctx.counts.items()}


def scaled_loop(tally: Tally):
    """The token-loop hook (``token_loop.run``) of a counted step: tokens
    0, 1 and 2 run, token 1 weighted n - 2 (module docstring). The loop's
    outputs for tokens 3 .. n - 1 are detached views of token 1's (no
    work, no storage; the storages token 1 leaves alive count n - 2
    times). The peak of live bytes is that of the last token on top of
    n - 3 more tokens' survivors."""
    def hook(n, step):
        if n < 3:
            return [step(t) for t in range(n)]
        w = n - 2
        first = step(0)
        before = _counts_snapshot()
        lo = torch._C._autograd._get_sequence_nr()
        tally.weight, tally.fresh = w, []
        try:
            mid = step(1)
        finally:
            fresh, tally.weight, tally.fresh = tally.fresh, 1, None
        hi = torch._C._autograd._get_sequence_nr()
        for k, v in shard_ctx.counts.items():
            for f in ("calls", "bytes"):
                v[f] += (w - 1) * (v[f] - before[k][f])
        peak, tally.peak = tally.peak, tally.live
        try:
            last = step(2)
        finally:
            # Also when remat's recompute stops early inside token 2 (it
            # raises once it holds every tensor the backward needs).
            node = torch._C._current_autograd_node()
            token = _Scaled(lo, hi, torch._C._autograd._get_sequence_nr(),
                            w, None if node is None else node._sequence_nr())
            tally.scaled.append(token)
            kept = 0
            for ref, info in fresh:
                if ref() is not None:
                    kept += info[0]
                    info[1], info[2] = w, token
                    token.infos.append(info)
            tally.live += (w - 1) * kept
            tally.peak = max(peak, tally.peak + (w - 1) * kept)
        fill = mid.detach() if isinstance(mid, torch.Tensor) else mid
        return [first, mid] + [fill] * (n - 3) + [last]
    return hook


@contextlib.contextmanager
def fake_mesh(axis_shapes, axis_names):
    """A ``Mesh`` over a fake default group of ``prod(axis_shapes)``
    ranks, this process rank 0 (a CPU mesh): joined here and destroyed on
    exit. Raises if a group is joined already."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} group is joined: the "
                           "dry run joins a fake default group of its own")
    axis_shapes, axis_names = tuple(axis_shapes), tuple(axis_names)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(axis_shapes))
    try:
        dm = init_device_mesh("cpu", axis_shapes, mesh_dim_names=axis_names)
        yield Mesh(axis_names, axis_shapes, dm, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def trace_step(plan, *, scale_tokens: bool = True) -> dict:
    """One rank's step of ``plan`` on fake tensors: its counts (FLOPs,
    bytes, peak live bytes), the bytes of its arguments, outputs and
    in-place outputs, and ``sharding.ctx``'s collective counts. With
    ``scale_tokens=False`` the token loops run whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        full = [None if a is None else pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype), a)
            for a in plan.args]
        args = plan.shard(*full)
        del full
        leaves = _tensors(args)
        tally = Tally()
        for t in leaves:
            tally.track(t)
        shard_ctx.reset_counts()
        hook = scaled_loop(tally) if scale_tokens else \
            (lambda n, step: [step(t) for t in range(n)])
        with tally, token_loop.hooked(hook):
            out = plan.step_fn(*args)
        stored = {id(t.untyped_storage()) for t in leaves}
        outs = _tensors(out)
        arg_bytes = sum(map(_nbytes, leaves))
        return dict(
            flops=tally.flops, bytes=tally.bytes, argument=arg_bytes,
            temp=tally.peak - arg_bytes, output=sum(map(_nbytes, outs)),
            alias=sum(_nbytes(t) for t in outs
                      if id(t.untyped_storage()) in stored),
            collectives=_counts_snapshot())


def collective_record(counts: dict) -> dict:
    """``sharding.ctx.counts`` as the JAX package's
    ``collectives_full_hlo``."""
    out = {k: 0 for k in COLLECTIVES}
    calls = {k: 0 for k in COLLECTIVES}
    for kind, v in counts.items():
        out[KIND_NAMES[kind]] += v["bytes"]
        calls[KIND_NAMES[kind]] += v["calls"]
    return {"bytes": out, "counts": calls,
            "total_bytes": int(sum(out.values()))}


def _reduced_depth(cfg, n_periods: int):
    """Config with the layer stack cut to n_periods periods."""
    from ..models.transformer import layout
    period, full = layout(cfg)
    ch = {"n_layers": len(period) * n_periods}
    if cfg.enc_layers:
        ch["enc_layers"] = n_periods
        ch["n_layers"] = n_periods
    return dataclasses.replace(cfg, **ch), full


def measure_cell(cfg, shape, mesh, *, skip_extrapolation=False,
                 **plan_kwargs) -> dict:
    """Count a cell and return its record. ``plan_kwargs`` (impl,
    ssm_impl, mlstm_impl, rule_overrides, n_microbatches, ...) forward to
    ``plan_cell``. ``mesh`` gives the axes (a shape-only mesh,
    ``make_production_mesh``): a fake group of its ranks is joined for
    the cell. ``ssm_impl`` defaults to "chunked" for every kind: the dry
    run runs the plain versions, and the JAX package's records count its
    Mamba layers through the chunked scan."""
    plan_kwargs.setdefault("ssm_impl", "chunked")
    impl = plan_kwargs.setdefault("impl", "torch")
    if impl != "torch":
        raise ValueError(
            f"impl={impl!r}: the dry run runs the plain versions only "
            "(impl='torch'); the hand-written kernels launch through ctypes "
            "on real pointers, which fake tensors do not have")
    with fake_mesh(tuple(mesh.shape.values()), mesh.axis_names) as mesh:
        return _measure(cfg, shape, mesh, skip_extrapolation, plan_kwargs)


def _measure(cfg, shape, mesh, skip_extrapolation, plan_kwargs) -> dict:
    rec = {"arch": cfg.name, "shape": shape.name,
           "mesh": tuple(mesh.shape.values()), "n_devices": mesh.size}
    t0 = time.time()
    plan = plan_cell(cfg, shape, mesh, **plan_kwargs)
    got = trace_step(plan)
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["memory"] = {f"{k}_gib": got[k] / 2**30
                     for k in ("argument", "output", "temp", "alias")}
    rec["cost_full_hlo"] = {"flops": float(got["flops"]),
                            "bytes": float(got["bytes"])}
    rec["collectives_full_hlo"] = collective_record(got["collectives"])
    rec["n_microbatches"] = plan.n_microbatches

    if skip_extrapolation:
        return rec
    vals = {}
    for depth in (1, 2):
        dcfg, n_full = _reduced_depth(cfg, depth)
        probe = trace_step(plan_cell(dcfg, shape, mesh, **{
            **plan_kwargs, "n_microbatches": 1}))
        vals[depth] = {"flops": probe["flops"], "bytes": probe["bytes"],
                       "coll": collective_record(
                           probe["collectives"])["total_bytes"]}
    rec["extrapolated"] = {
        key: float(vals[1][key] + (n_full - 1) * (vals[2][key]
                                                  - vals[1][key]))
        for key in ("flops", "bytes", "coll")}
    rec["depth_probe"] = vals
    rec["n_periods"] = n_full
    return rec


def iter_cells(arch_sel, shape_sel):
    for name, cfg in configs.ARCHS.items():
        if arch_sel != "all" and name != arch_sel:
            continue
        for shape in ALL_SHAPES:
            if shape_sel != "all" and shape.name != shape_sel:
                continue
            ok, reason = shape_supported(cfg, shape)
            yield cfg, shape, None if ok else reason


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--fast", action="store_true",
                    help="skip depth extrapolation probes")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", make_production_mesh(multi_pod=True)))

    n_ok = n_skip = n_fail = 0
    t_start = time.time()
    for cfg, shape, skip_reason in iter_cells(args.arch, args.shape):
        for mesh_name, mesh in meshes:
            cell = f"{cfg.name}__{shape.name}__{mesh_name}"
            path = os.path.join(args.out, cell + ".json")
            if skip_reason:
                rec = {"arch": cfg.name, "shape": shape.name,
                       "mesh": mesh_name, "skipped": skip_reason}
                n_skip += 1
                print(f"SKIP {cell}: {skip_reason}", flush=True)
            else:
                try:
                    rec = measure_cell(cfg, shape, mesh,
                                       skip_extrapolation=args.fast)
                    rec["mesh_name"] = mesh_name
                    n_ok += 1
                    flops = rec.get("extrapolated",
                                    rec["cost_full_hlo"])["flops"]
                    print(f"OK   {cell}: trace={rec['compile_s']}s "
                          f"flops={flops:.3e} coll="
                          f"{rec['collectives_full_hlo']['total_bytes']:.3e}B"
                          f" temp={rec['memory']['temp_gib']:.1f}GiB",
                          flush=True)
                except Exception as e:
                    rec = {"arch": cfg.name, "shape": shape.name,
                           "mesh": mesh_name, "error": str(e),
                           "traceback": traceback.format_exc()}
                    n_fail += 1
                    print(f"FAIL {cell}: {e}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail} in "
          f"{time.time() - t_start:.1f} s", flush=True)
    return n_fail


if __name__ == "__main__":
    main()
