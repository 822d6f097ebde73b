"""Algorithm 1 — block coordinate descent over the one-slot problem (P2).

Three blocks, iterated ``n_iters`` times (paper §V-B):

  line 3: video configuration (r, x, m) - exhaustive search over the
          (model x resolution x policy) grid, per camera;
  line 4: bandwidth allocation b         - water-filling per server;
  line 5: computation allocation c       - the same.

``solver_backend`` picks who computes the blocks:

  * ``"cuda"``  - the hand-written kernels of
    ``repro_torch.kernels.slot_solver`` (``config_argmin`` and one fused
    ``waterfill_pair`` launch per BCD pass; ``"cuda:nofuse"`` launches
    ``waterfill`` twice instead; a tiled spec launches ``waterfill_tiled``
    twice, bandwidth then compute). Needs CUDA tensors.
  * ``"torch"`` - the plain PyTorch versions, on whatever device the
    tensors are on (the reference the kernels are held against).
  * ``"auto"``  - ``cuda`` for CUDA tensors, ``torch`` on the CPU.

The ``tile=<n>`` knob and the fleet-size policy that sets it are the
reference's (``resolve_spec``).

``method`` picks lines 4-5: ``"waterfill"`` (default) or the paper's own
``"interior"`` (``allocate.interior_point_*``: a log barrier with damped
Newton steps, the same in every BCD pass, with no final re-allocation).
No kernel runs the interior method, in this package or the reference: it
runs the plain versions on any device, ``"auto"`` resolves to ``"torch"``
for it, and an explicit ``"cuda"`` raises ``ValueError``. It takes no
churn mask (``ValueError``, as in the reference).

A fleet-churn mask (``active``) is taken by no kernel, in this package or
the reference, so a masked solve runs the plain versions: silently under
``"auto"``, as in the reference; an explicit ``"cuda"`` with a mask raises
``ValueError``, so that no caller believes a kernel ran.

On the card a plain solve (``"torch"``, any masked solve, any interior
solve) is ~50,000 launches of a few microseconds of work each, so it runs
as a CUDA graph, captured at the first call with its shapes, method and
knobs and replayed per call (the same kernels on the same inputs, bitwise
the eager run). The interior method's Newton steps take closed-form
derivatives (``allocate.interior_point_*``), so its graph holds no
autograd pass.

Each call opens the ``bcd.solve_slot`` obs span, labelled by the backend
that runs. The port is eager, so every call is concrete: the reference's
``bcd.solve_slot.traces`` counter (bumped for traced calls) never moves.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from . import allocate, aopi
from .. import obs
from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.slot_solver import ops, ref

SOLVER_BACKENDS = ("torch", "cuda", "auto")
METHODS = ("waterfill", "interior")

# Fleet size from which the cuda backend tiles the water-fills by default,
# and the default tile: the reference's values (repro.core.bcd), kept until
# a measurement on the card moves them.
AUTO_TILE_MIN_CAMERAS = 32768
DEFAULT_TILE_N = 16384


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Parsed ``solver_backend`` spec: backend plus tiling/fusion knobs."""
    backend: str              # "torch" | "cuda" | "auto" (pre-resolution)
    tile_n: int | None = None  # water-fill camera tile (None = untiled)
    fuse: bool = True          # one fused kernel for both water-fills


def parse_backend(solver_backend) -> SolverSpec:
    """Parse ``<backend>[:<knob>]*`` with knobs ``tile=<int>``, ``fuse``
    and ``nofuse`` (``repro.core.bcd.parse_backend``'s grammar)."""
    if isinstance(solver_backend, SolverSpec):
        return solver_backend
    parts = str(solver_backend).split(":")
    if parts[0] not in SOLVER_BACKENDS:
        raise ValueError(f"unknown solver_backend {parts[0]!r}; "
                         f"known: {SOLVER_BACKENDS}")
    tile_n = None
    fuse = True
    for tok in parts[1:]:
        if tok == "fuse":
            fuse = True
        elif tok == "nofuse":
            fuse = False
        elif tok.startswith("tile="):
            tile_n = int(tok[len("tile="):])
        else:
            raise ValueError(f"unknown solver_backend knob {tok!r} in "
                             f"{solver_backend!r}; known: tile=<int>, "
                             "fuse, nofuse")
    return SolverSpec(parts[0], tile_n, fuse)


def resolve_spec(solver_backend, device, n_cameras: int,
                 method: str = "waterfill") -> SolverSpec:
    """Resolve a spec for ``n_cameras`` cameras on ``device``.

    ``auto`` becomes ``cuda`` on a CUDA device and ``torch`` elsewhere;
    ``cuda`` on a non-CUDA device raises ``ValueError``. On ``cuda`` the
    water-fills tile with :data:`DEFAULT_TILE_N` from
    :data:`AUTO_TILE_MIN_CAMERAS` cameras unless the spec pins ``tile=``;
    ``tile=0`` pins the untiled kernels, and so does any tile the whole
    fleet fits in (``n_cameras <= tile``). ``torch`` never tiles. The
    resolved spec never carries ``auto``. ``method="interior"`` has no
    kernel: ``auto`` resolves to ``torch`` for it on every device, and
    ``cuda`` raises ``ValueError``."""
    spec = parse_backend(solver_backend)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; known: {METHODS}")
    dev = torch.device(device)
    backend = spec.backend
    if method == "interior":
        if backend == "cuda":
            raise ValueError(
                "solver_backend='cuda' runs the water-filling kernels; "
                "method='interior' only runs on the 'torch' backend")
        backend = "torch"
    if backend == "auto":
        backend = "cuda" if dev.type == "cuda" else "torch"
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(f"solver_backend='cuda' needs CUDA tensors; the "
                         f"inputs are on {dev}")
    tile_n = spec.tile_n
    if backend == "cuda":
        if tile_n is None and n_cameras >= AUTO_TILE_MIN_CAMERAS:
            tile_n = DEFAULT_TILE_N
        if tile_n == 0 or (tile_n is not None and n_cameras <= tile_n):
            tile_n = None
    else:
        tile_n = None
    return SolverSpec(backend, tile_n, spec.fuse)


@dataclasses.dataclass
class SlotDecision:
    """Output of one Algorithm-1 solve (per-camera tensors)."""
    r_idx: torch.Tensor       # resolution index into tables.size
    m_idx: torch.Tensor       # model index
    pol: torch.Tensor         # 0 FCFS / 1 LCFSP
    b: torch.Tensor           # Hz
    c: torch.Tensor           # FLOPS
    lam: torch.Tensor         # frames/s
    mu: torch.Tensor          # frames/s
    acc: torch.Tensor         # recognition accuracy p_{n,t}
    aopi: torch.Tensor        # closed-form per-camera AoPI
    score: torch.Tensor       # scalar drift-plus-penalty value

    def as_numpy(self) -> "SlotDecision":
        return SlotDecision(*(v.cpu().numpy()
                              for v in dataclasses.astuple(self)))

    @staticmethod
    def stack(decisions) -> "SlotDecision":
        """Stack per-slot decisions along a new leading axis."""
        return SlotDecision(*(torch.stack([getattr(d, f.name)
                                           for d in decisions])
                              for f in dataclasses.fields(SlotDecision)))


def _pair_fns(spec, server_id, budgets_b, budgets_c, n_servers,
              active=None):
    """``make_pair(iteration budgets) -> pair(k, p, pol, mu, inv_xi)``
    returning ``(b, c)`` for the resolved backend (a churn mask only on
    ``torch``)."""
    if spec.backend == "torch":
        def make_pair(kw):
            def pair(k, p, pol, mu, inv_xi):
                return allocate.waterfill_pair(
                    k, p, pol, mu, inv_xi, server_id, budgets_b, budgets_c,
                    n_servers, active=active, **kw)
            return pair
        return make_pair
    layout = ops.server_layout(server_id, n_servers)
    if spec.fuse and spec.tile_n is None:
        def make_pair(kw):
            def pair(k, p, pol, mu, inv_xi):
                return ops.waterfill_pair(
                    k, p, pol, mu, inv_xi, server_id, budgets_b, budgets_c,
                    n_servers, layout=layout, **kw)
            return pair
        return make_pair

    # Unfused, or tiled: there is no fused tiled pair (as in the reference).
    def make_pair(kw):
        def pair(k, p, pol, mu, inv_xi):
            b = ops.waterfill_bandwidth(k, p, pol, mu, server_id, budgets_b,
                                        n_servers, layout=layout,
                                        tile_n=spec.tile_n, **kw)
            c = ops.waterfill_compute(inv_xi, p, pol, b * k, server_id,
                                      budgets_c, n_servers, layout=layout,
                                      tile_n=spec.tile_n, **kw)
            return b, c
        return pair
    return make_pair


def solve_slot(acc, xi, size, eff, server_id, budgets_b, budgets_c, q, V,
               n_servers: int, n_iters: int = 4,
               method: Literal["waterfill", "interior"] = "waterfill",
               solver_effort: Literal["fast", "seed"] = "fast",
               solver_backend: str = "auto", active=None) -> SlotDecision:
    """Run Algorithm 1 and return a :class:`SlotDecision`.

    Args:
      acc:  [N, M, R] profiled accuracy; xi: [M, R] FLOPs per frame;
      size: [R] bits per frame; eff: [N] link efficiency (bits/s/Hz).
      server_id: int32 [N] camera -> server (Algorithm 2's output).
      budgets_b/_c: [n_servers] available Hz / FLOPS.
      q, V: Lyapunov queue value (number or 0-d tensor) and penalty weight
        (Python number).
      method: lines 4-5 by ``"waterfill"`` or the paper's ``"interior"``
        (plain versions only; see the module docstring).
      solver_effort: "fast" uses cheap water-filling inside the BCD loop
        plus one full-precision re-allocation; "seed" the flat
        high-iteration effort.
      solver_backend: ``"auto" | "cuda" | "torch"`` with ``:nofuse`` and
        ``:tile=<n>`` (see :func:`resolve_spec`).
      active: optional [N] fleet-churn mask (1 = live). Dead cameras get
        exactly zero bandwidth and compute (their share goes to the live
        cameras of their server) and drop out of the score's means, as in
        the reference. A masked solve runs the plain versions (see the
        module docstring); ``"cuda"`` with a mask raises ``ValueError``.
    """
    n = acc.shape[0]
    if active is not None:
        if method == "interior":
            raise ValueError("method='interior' does not support a fleet-"
                             "churn mask; use method='waterfill'")
        if parse_backend(solver_backend).backend == "cuda":
            raise ValueError(
                "solver_backend='cuda' with a fleet-churn mask (active): no "
                "slot-solver kernel takes the mask; 'auto' or 'torch' run "
                "a masked solve on the plain path")
        spec = resolve_spec("torch", acc.device, n, method=method)
    else:
        spec = resolve_spec(solver_backend, acc.device, n, method=method)
    args = (acc, xi, size, eff, server_id, budgets_b, budgets_c, q, active)
    kw = dict(V=V, n_servers=n_servers, n_iters=n_iters, method=method,
              solver_effort=solver_effort, spec=spec)
    if not obs.enabled():
        return _dispatch(args, kw)
    label = spec.backend if spec.tile_n is None else f"{spec.backend}:tiled"
    with obs.span("bcd.solve_slot", solver_backend=label, n_cameras=int(n)):
        return _dispatch(args, kw)


def _dispatch(args, kw) -> SlotDecision:
    """Eager, except a plain solve on the card: a replayed CUDA graph."""
    acc, q = args[0], args[7]
    if kw["spec"].backend != "torch" or acc.device.type != "cuda":
        return _solve(*args, **kw)
    q = torch.as_tensor(q, dtype=torch.float32, device=acc.device)
    active = args[8]
    tensors = args[:7] + (q,) + (() if active is None else (active,))
    kw = dict(kw, V=float(kw["V"]))

    def fn(*t):
        return _solve(*t[:8], t[8] if len(t) > 8 else None, **kw)

    key = (tuple((t.shape, t.dtype) for t in tensors), acc.device,
           kw["V"], kw["n_servers"], kw["n_iters"], kw["method"],
           kw["solver_effort"])
    return replay_graph(key, fn, tensors)


# Captured graphs by key; each holds its own memory pool until
# release_graphs().
_GRAPHS: dict = {}


def release_graphs() -> None:
    """Drop every captured graph and its memory pool."""
    _GRAPHS.clear()


def replay_graph(key, fn, tensors) -> SlotDecision:
    """``fn(*tensors)`` through a CUDA graph cached under ``key``: captured
    at the first call (after one eager warm-up run on a side stream; the
    capture synchronises the card once), then replayed with ``tensors``
    copied into its inputs. Returns copies of the graph's outputs."""
    entry = _GRAPHS.get(key)
    if entry is None:
        static = [t.clone() for t in tensors]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # Captured on the side stream of the current card: the default
        # capture stream is made once per process, on the card current at
        # the first capture, and a later capture on another card would use
        # it (the sweep's fleet runs several cards from one process).
        with torch.cuda.graph(graph, stream=side):
            out = fn(*static)
        entry = _GRAPHS[key] = (graph, static, out)
    graph, static, out = entry
    for dst, src in zip(static, tensors):
        dst.copy_(src)
    graph.replay()
    return SlotDecision(*(getattr(out, f.name).clone()
                          for f in dataclasses.fields(SlotDecision)))


def _solve(acc, xi, size, eff, server_id, budgets_b, budgets_c, q, active,
           *, V, n_servers: int, n_iters: int, method: str = "waterfill",
           solver_effort: str, spec: SolverSpec) -> SlotDecision:
    n = acc.shape[0]
    sid = server_id.long()
    if active is not None:
        act = (active > 0).to(acc.dtype)
        eff = eff * act              # lam = 0 for churned-out cameras
        counts = allocate.segment_sum(act, sid, n_servers)
        share = act * (1.0 / torch.clamp_min(counts, 1.0))[sid]
    else:
        act = None
        counts = allocate.segment_sum(
            torch.ones(n, dtype=acc.dtype, device=acc.device), sid,
            n_servers)
        share = (1.0 / torch.clamp_min(counts, 1.0))[sid]
    b = budgets_b[sid] * share
    c = budgets_c[sid] * share
    config = (ops.config_argmin if spec.backend == "cuda"
              else ref.config_argmin_ref)
    make_pair = _pair_fns(spec, server_id, budgets_b, budgets_c, n_servers,
                          active=act)

    polish = method == "waterfill" and solver_effort == "fast"
    if polish:
        # Cheap effort inside the BCD loop (it only steers the discrete
        # config choice); one accurate re-allocation afterwards.
        pair_loop = make_pair(dict(outer_iters=10, inner_iters=3,
                                   final_inner_iters=5))
        pair_full = make_pair({})
    elif method == "waterfill":
        pair_loop = make_pair(dict(outer_iters=54, inner_iters=40,
                                   final_inner_iters=40))
    else:
        def pair_loop(k, p, pol, mu, inv_xi):
            b = allocate.interior_point_bandwidth(
                k, p, pol, mu, server_id, budgets_b, n_servers)
            c = allocate.interior_point_compute(
                inv_xi, p, pol, b * k, server_id, budgets_c, n_servers)
            return b, c

    rows = torch.arange(n, device=acc.device)

    def blocks(r_idx, m_idx, pol):
        p = acc[rows, m_idx.long(), r_idx.long()]
        k = eff / size[r_idx.long()]
        xi_nm = xi[m_idx.long(), r_idx.long()]
        return p, k, xi_nm

    r_idx = m_idx = pol = torch.zeros(n, dtype=torch.int32,
                                      device=acc.device)
    for _ in range(n_iters):
        r_idx, m_idx, pol = config(b, c, acc, xi, size, eff, q, V, n)
        p, k, xi_nm = blocks(r_idx, m_idx, pol)
        # lines 4-5: bandwidth given (r, x, m, c), then compute given the
        # fresh arrival rate lam = b * k.
        b, c = pair_loop(k, p, pol, c / xi_nm, 1.0 / xi_nm)

    p, k, xi_nm = blocks(r_idx, m_idx, pol)
    if polish:
        b, c = pair_full(k, p, pol, c / xi_nm, 1.0 / xi_nm)
    lam = b * eff / size[r_idx.long()]                # Eqs. (1)-(2)
    mu = c / xi_nm                                    # Eq. (3)
    if act is not None:
        # Dead cameras give exactly 0 in every per-camera output; the means
        # run over the live count.
        a = aopi.aopi_masked(lam, mu, p, pol, active=act)
        p = p * act
        n_live = torch.clamp_min(torch.sum(act), 1.0)
        score = -q * torch.sum(p) / n_live + V * torch.sum(a) / n_live
    else:
        a = aopi.aopi(lam, mu, p, pol)
        score = -q * torch.mean(p) + V * torch.mean(a)
    return SlotDecision(r_idx, m_idx, pol, b, c, lam, mu, p, a, score)


def solve_slot_np(tables, server_id, budgets_b, budgets_c, q, V,
                  n_servers, device=DEFAULT_DEVICE, **kw) -> SlotDecision:
    """Solve one slot from a ``profiles.SlotTables``; returns numpy."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    dec = solve_slot(f32(tables.acc), f32(tables.xi), f32(tables.size),
                     f32(tables.eff),
                     torch.as_tensor(np.asarray(server_id, np.int32),
                                     device=dev),
                     f32(budgets_b), f32(budgets_c), float(np.float32(q)),
                     float(V), n_servers=int(n_servers), **kw)
    return dec.as_numpy()
