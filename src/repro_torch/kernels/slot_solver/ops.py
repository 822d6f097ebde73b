"""Wrappers of the slot-solver kernels: one entry point per kernel.

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches the CUDA kernel for tensors on a CUDA device, after checking
device, dtype, shape and contiguity; there is no fallback from the kernel
to the plain version. ``launches`` counts kernel launches per kernel (the
plain version never counts). Beside each count the wrapper bumps
``obs.count_dispatch`` with the reference's entry name and labels
(``mode`` on ``baseline_argmax`` and the single water-fills); the
reference counts at trace time, once per compiled program, the port once
per launch, so the ``obs.dispatch.count`` series of a kernel add up to its
``launches`` entry whenever obs is on.

``ServerLayout`` sorts cameras stably by server into contiguous per-server
segments; the water-fill kernels spread each segment over a team of G
CTAs (:func:`fill_plan`), given the sorted camera order and each server's
``start``/``counts``. The layout
also keeps the JAX package's lane-padded flat view and ``[S, C]`` row view
(``repro.kernels.slot_solver.ops.ServerLayout``), so the two can be
compared field by field.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import kernel, ref
from ... import obs
from ...core import allocate

_LANE = 128          # the reference's padding width (its TPU lane width)
H100_SMS = 132       # SMs of an H100 SXM, tiled_group's default
# Largest G whose CTAs meet as a cluster (16: a non-portable one); above
# it, through global memory under a cooperative launch. At G = 16 the
# cluster took 9% less than the grid where the sums set the time (a
# waterfill_pair of 10,000 cameras) and 3% more where the bisections do
# (100,000 cameras): PERF.md, section 6, PR 18.
CLUSTER_UP_TO = 16

# Kernel launches per kernel name since the last ``reset_launches()``.
launches = {"config_argmin": 0, "waterfill": 0, "waterfill_pair": 0,
            "waterfill_tiled": 0, "baseline_argmax": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"slot solver: unsupported device {t.device}")


def _check(name: str, t, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


@dataclasses.dataclass
class ServerLayout:
    """Cameras stably sorted into per-server segments.

      * ``flat_order[j]`` - original index of the j-th camera in sorted
        order, padded to a multiple of 128 with the sentinel ``N``;
        ``flat_sid`` holds each slot's server (``S`` on padding) and
        ``flat_mask`` 1.0 on real slots;
      * ``counts[s]`` / ``start[s]`` - the length and offset of server s's
        segment in that order (the kernels' view);
      * ``order`` / ``mask`` - the ``[S, C]`` row view (``C`` = capacity),
        built on demand.
    """
    counts: torch.Tensor      # [S]  int32
    start: torch.Tensor       # [S]  int32
    flat_order: torch.Tensor  # [Np] int32
    flat_sid: torch.Tensor    # [Np] int32
    flat_mask: torch.Tensor   # [Np] float32
    n_cameras: int
    capacity: int

    @property
    def n_servers(self) -> int:
        return self.counts.shape[0]

    @property
    def camera_order(self) -> torch.Tensor:
        """Sorted camera order without padding, ``[N]`` int32."""
        return self.flat_order[:self.n_cameras]

    @property
    def order(self) -> torch.Tensor:
        """``[S, C]``: the j-th camera of server s, or the sentinel ``N``
        (a server loaded past the capacity drops the overflow)."""
        n, s, cap = self.n_cameras, self.n_servers, self.capacity
        sid = self.flat_sid[:n].long()
        pos = torch.arange(n, device=sid.device) - self.start.long()[sid]
        dump = s * cap                       # one slot for the overflow
        idx = torch.where(pos < cap, sid * cap + pos,
                          torch.full_like(pos, dump))
        rows = torch.full((dump + 1,), n, dtype=torch.int32,
                          device=sid.device)
        rows.scatter_(0, idx, self.camera_order)
        return rows[:dump].reshape(s, cap)

    @property
    def mask(self) -> torch.Tensor:
        return (self.order < self.n_cameras).to(torch.float32)


def server_layout(server_id: torch.Tensor, n_servers: int,
                  capacity: int | None = None) -> ServerLayout:
    """Build a :class:`ServerLayout` from an assignment ``int[N]`` without
    synchronising with the device."""
    n = server_id.shape[0]
    dev = server_id.device
    cap = n if capacity is None else int(capacity)
    cap = max(_LANE, -(-cap // _LANE) * _LANE)
    n_pad = max(_LANE, -(-n // _LANE) * _LANE)
    sid = server_id.long()
    sort_idx = torch.argsort(sid, stable=True)
    sid_sorted = sid[sort_idx]
    counts = torch.zeros(n_servers, dtype=torch.int64, device=dev)
    counts.index_add_(0, sid, torch.ones_like(sid))
    start = torch.cumsum(counts, 0) - counts
    flat_order = torch.cat([sort_idx, torch.full((n_pad - n,), n,
                                                 dtype=torch.int64,
                                                 device=dev)])
    flat_sid = torch.cat([sid_sorted, torch.full((n_pad - n,), n_servers,
                                                 dtype=torch.int64,
                                                 device=dev)])
    return ServerLayout(counts=counts.to(torch.int32),
                        start=start.to(torch.int32),
                        flat_order=flat_order.to(torch.int32),
                        flat_sid=flat_sid.to(torch.int32),
                        flat_mask=(flat_order < n).to(torch.float32),
                        n_cameras=n, capacity=cap)


# ---------------------------------------------------------------------------
# Config selection (Algorithm 1 line 3)
# ---------------------------------------------------------------------------

def config_argmin(b, c, acc, xi, size, eff, q, v, n_total: int):
    """Per-camera ``(r_idx, m_idx, pol)`` minimizing the drift-plus-penalty
    score over the (model x resolution x policy) grid. ``v`` is a Python
    number; ``q`` a number or a one-element tensor."""
    if not _on_cuda(b):
        return ref.config_argmin_ref(b, c, acc, xi, size, eff, q, v, n_total)
    n, n_m, n_r = acc.shape
    dev = b.device
    f32 = torch.float32
    for name, t, shape in (("b", b, (n,)), ("c", c, (n,)),
                           ("eff", eff, (n,)), ("acc", acc, (n, n_m, n_r)),
                           ("xi", xi, (n_m, n_r)), ("size", size, (n_r,))):
        _check(f"config_argmin {name}", t, f32, shape, dev)
    q_t = torch.as_tensor(q, dtype=f32, device=dev).reshape(1)
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    kernel.config_argmin(b, c, eff, acc, xi, size, q_t, float(v), n_total,
                         out[0], out[1], out[2])
    launches["config_argmin"] += 1
    obs.count_dispatch("config_argmin")
    return out[0], out[1], out[2]


def baseline_argmax(b, c, acc, xi, size, eff, *, mode: str, threshold):
    """DOS/JCAB configuration scan; per camera ``(m_idx, r_idx)``
    (``ref.baseline_argmax_ref``). ``threshold`` is DOS's latency weight or
    JCAB's latency cap, a Python number."""
    if mode not in kernel.BASELINE_MODES:
        raise ValueError(f"unknown baseline scan mode {mode!r}")
    if not _on_cuda(b):
        return ref.baseline_argmax_ref(b, c, acc, xi, size, eff, mode=mode,
                                       threshold=threshold)
    n, n_m, n_r = acc.shape
    dev = b.device
    f32 = torch.float32
    for name, t, shape in (("b", b, (n,)), ("c", c, (n,)),
                           ("eff", eff, (n,)), ("acc", acc, (n, n_m, n_r)),
                           ("xi", xi, (n_m, n_r)), ("size", size, (n_r,))):
        _check(f"baseline_argmax {name}", t, f32, shape, dev)
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    kernel.baseline_argmax(b, c, eff, acc, xi, size, float(threshold), mode,
                           out[0], out[1])
    launches["baseline_argmax"] += 1
    obs.count_dispatch("baseline_argmax", mode=str(mode))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Water-filling (Algorithm 1 lines 4/5)
# ---------------------------------------------------------------------------

def _check_fill(name, vectors, pol, budgets, n_servers, layout):
    n = pol.shape[0]
    dev = pol.device
    for vname, t in vectors:
        _check(f"{name} {vname}", t, torch.float32, (n,), dev)
    _check(f"{name} pol", pol, torch.int32, (n,), dev)
    for bname, t in budgets:
        _check(f"{name} {bname}", t, torch.float32, (n_servers,), dev)
    if layout.n_servers != n_servers or layout.n_cameras != n:
        raise ValueError(f"{name}: layout is for {layout.n_cameras} cameras "
                         f"on {layout.n_servers} servers, expected {n} on "
                         f"{n_servers}")


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class FillPlan:
    """How a water-fill launch spreads each server: ``group`` CTAs of
    ``threads`` threads (both powers of two), which meet through ``sync``:
    ``"none"`` (one CTA, a plain launch), ``"cluster"`` or ``"grid"``."""
    group: int
    threads: int
    sync: str


def fill_plan(n_cameras: int, n_servers: int, n_sms: int, *,
              group: int | None = None, threads: int | None = None,
              sync: str | None = None) -> FillPlan:
    """The water-fill kernels' team, from the sizes alone (never the
    per-server counts on the device): G, the power of two that gives a
    mean segment's cameras one thread each in CTAs of ``kernel.MAX_THREADS``
    (G = 1 where it fits one CTA), at most the largest with S * G <=
    ``n_sms`` (one wave of the card) and ``kernel.MAX_GROUP``; T, the power
    of two in [32, MAX_THREADS] that holds a mean segment's share of a CTA
    at about one camera a thread. ``group``, ``threads`` and ``sync`` pin
    their part of the plan."""
    s = max(n_servers, 1)
    mean = -(-n_cameras // s)
    if group is None:
        group = 1
        while (group * kernel.MAX_THREADS < mean and 2 * group * s <= n_sms
               and group < kernel.MAX_GROUP):
            group *= 2
    if not (1 <= group <= kernel.MAX_GROUP) or group & (group - 1):
        raise ValueError(f"water-fill: group={group} is not a power of two "
                         f"in [1, {kernel.MAX_GROUP}]")
    if threads is None:
        threads = min(max(_pow2_ceil(-(-mean // group)), 32),
                      kernel.MAX_THREADS)
    if not (32 <= threads <= kernel.MAX_THREADS) or threads & (threads - 1):
        raise ValueError(f"water-fill: threads={threads} is not a power of "
                         f"two in [32, {kernel.MAX_THREADS}]")
    if sync is None:
        sync = ("none" if group == 1 else
                "cluster" if group <= CLUSTER_UP_TO else "grid")
    if (sync not in kernel.SYNC or (sync == "none") != (group == 1)
            or (sync == "cluster" and group > kernel.MAX_CLUSTER)):
        raise ValueError(f"water-fill: sync={sync!r} does not fit "
                         f"group={group}")
    return FillPlan(group, threads, sync)


def tiled_group(n_cameras: int, n_servers: int, tile_n: int | None,
                n_sms: int = H100_SMS) -> int | None:
    """CTAs per server of the tiled water-fill, or None for the untiled
    kernel. As in the reference, ``tile_n`` is rounded up to the 128-wide
    padding and the fleet is tiled when its padded width exceeds one tile;
    then G is :func:`fill_plan`'s, from the sizes alone."""
    if tile_n is None:
        return None
    tile = max(_LANE, -(-int(tile_n) // _LANE) * _LANE)
    if max(_LANE, -(-n_cameras // _LANE) * _LANE) <= tile:
        return None
    return fill_plan(n_cameras, n_servers, n_sms).group


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_on(dev: torch.device, n: int, n_servers: int, **pins) -> FillPlan:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return fill_plan(n, n_servers, _sm_count(index), **pins)


def _grid_slots(plan: FillPlan, n_servers: int, dev):
    """The grid exchange's words, zeroed: per server an arrival count, the
    total and G words of partials. None for other plans."""
    if plan.sync != "grid":
        return None
    return torch.zeros(n_servers * (2 + plan.group), dtype=torch.int64,
                       device=dev)


_FILL_MODES = {"bandwidth": kernel.MODE_BANDWIDTH,
               "compute": kernel.MODE_COMPUTE}


def _fill(mode, coef, p, pol, other, budgets, margin, server_id, n_servers,
          effort, layout, tiled, pins):
    """Check and launch one water-fill on CUDA tensors: the ``waterfill``
    kernel, or ``waterfill_tiled``; ``pins`` fix parts of the plan."""
    name = "waterfill_tiled" if tiled else "waterfill"
    n = coef.shape[0]
    plan = _plan_on(coef.device, n, n_servers, **pins)
    if layout is None:
        layout = server_layout(server_id, n_servers)
    vecs = (("k", "mu") if mode == "bandwidth" else ("inv_xi", "lam"))
    _check_fill(f"{name}({mode})",
                ((vecs[0], coef), ("p", p), (vecs[1], other)), pol,
                (("budgets", budgets),), n_servers, layout)
    out = torch.empty_like(coef)
    scratch = torch.empty((5, n), dtype=torch.float32, device=coef.device)
    kernel.waterfill(_FILL_MODES[mode], coef, p, pol, other, budgets,
                     float(margin), layout.camera_order, layout.start,
                     layout.counts, plan, effort, scratch,
                     _grid_slots(plan, n_servers, coef.device), out,
                     tiled=tiled)
    launches[name] += 1
    obs.count_dispatch(name, mode=mode)
    return out


def waterfill_bandwidth(k, p, pol, mu, server_id, budgets, n_servers: int,
                        outer_iters: int = 16, inner_iters: int = 6,
                        final_inner_iters: int = 20, *,
                        layout: ServerLayout | None = None,
                        tile_n: int | None = None, group: int | None = None,
                        threads: int | None = None, sync: str | None = None):
    """Bandwidth b[n] (Hz) per server budget; the signature of
    ``allocate.waterfill_bandwidth`` plus an optional prebuilt layout and
    ``tile_n``, which launches the ``waterfill_tiled`` kernel where
    :func:`tiled_group` says so. ``group`` launches the tiled kernel with
    that many CTAs per server (a power of two <= ``kernel.MAX_GROUP``)
    instead; ``threads`` and ``sync`` pin the rest of :func:`fill_plan`.
    On the CPU all of them only name a launch: the plain version is the
    same function."""
    if not _on_cuda(k):
        return allocate.waterfill_bandwidth(
            k, p, pol, mu, server_id, budgets, n_servers,
            outer_iters=outer_iters, inner_iters=inner_iters,
            final_inner_iters=final_inner_iters)
    return _fill("bandwidth", k, p, pol, mu, budgets, 0.0, server_id,
                 n_servers, (outer_iters, inner_iters, final_inner_iters),
                 layout, group is not None or
                 tiled_group(k.shape[0], n_servers, tile_n) is not None,
                 dict(group=group, threads=threads, sync=sync))


def waterfill_compute(inv_xi, p, pol, lam, server_id, budgets,
                      n_servers: int, stability_margin: float = 1.05,
                      outer_iters: int = 16, inner_iters: int = 6,
                      final_inner_iters: int = 20, *,
                      layout: ServerLayout | None = None,
                      tile_n: int | None = None, group: int | None = None,
                      threads: int | None = None, sync: str | None = None):
    """Computation c[n] (FLOPS) per server budget; the signature of
    ``allocate.waterfill_compute`` plus an optional prebuilt layout,
    ``tile_n``, ``group``, ``threads`` and ``sync`` (as in
    :func:`waterfill_bandwidth`)."""
    if not _on_cuda(inv_xi):
        return allocate.waterfill_compute(
            inv_xi, p, pol, lam, server_id, budgets, n_servers,
            stability_margin=stability_margin, outer_iters=outer_iters,
            inner_iters=inner_iters, final_inner_iters=final_inner_iters)
    return _fill("compute", inv_xi, p, pol, lam, budgets, stability_margin,
                 server_id, n_servers,
                 (outer_iters, inner_iters, final_inner_iters), layout,
                 group is not None or
                 tiled_group(inv_xi.shape[0], n_servers, tile_n) is not None,
                 dict(group=group, threads=threads, sync=sync))


def waterfill_pair(k, p, pol, mu, inv_xi, server_id, budgets_b, budgets_c,
                   n_servers: int, stability_margin: float = 1.05,
                   outer_iters: int = 16, inner_iters: int = 6,
                   final_inner_iters: int = 20, *,
                   layout: ServerLayout | None = None,
                   group: int | None = None, threads: int | None = None,
                   sync: str | None = None):
    """Both water-fills of a BCD pass (lines 4 and 5) in one launch:
    ``waterfill_bandwidth`` then ``waterfill_compute`` at ``lam = b * k``.
    Returns ``(b, c)`` in Hz / FLOPS. ``group``, ``threads`` and ``sync``
    pin parts of :func:`fill_plan`."""
    if not _on_cuda(k):
        return allocate.waterfill_pair(
            k, p, pol, mu, inv_xi, server_id, budgets_b, budgets_c,
            n_servers, stability_margin=stability_margin,
            outer_iters=outer_iters, inner_iters=inner_iters,
            final_inner_iters=final_inner_iters)
    n = k.shape[0]
    plan = _plan_on(k.device, n, n_servers, group=group, threads=threads,
                    sync=sync)
    if layout is None:
        layout = server_layout(server_id, n_servers)
    _check_fill("waterfill_pair",
                (("k", k), ("p", p), ("mu", mu), ("inv_xi", inv_xi)), pol,
                (("budgets_b", budgets_b), ("budgets_c", budgets_c)),
                n_servers, layout)
    out = torch.empty((2, n), dtype=torch.float32, device=k.device)
    scratch = torch.empty((5, n), dtype=torch.float32, device=k.device)
    kernel.waterfill_pair(k, p, pol, mu, inv_xi, budgets_b, budgets_c,
                          stability_margin, layout.camera_order, layout.start,
                          layout.counts, plan,
                          (outer_iters, inner_iters, final_inner_iters),
                          scratch, _grid_slots(plan, n_servers, k.device),
                          out[0], out[1])
    launches["waterfill_pair"] += 1
    obs.count_dispatch("waterfill_pair")
    return out[0], out[1]
