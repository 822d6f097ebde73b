"""Wrappers of the data-plane kernels: one entry point per kernel.

Each wrapper takes the plain PyTorch version (``ref``) for tensors on the
CPU and launches the CUDA kernel for tensors on a CUDA device, after
checking device, dtype, shape and contiguity; there is no fallback from
the kernel to the plain version. ``launches`` counts kernel launches per
kernel (the plain version never counts).
"""
from __future__ import annotations

import torch

from . import kernel, ref
from ...core import queues

launches = {"gi_g1_window": 0, "tick_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"dataplane: unsupported device {t.device}")


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


def gi_g1_window(lam, mu, p, pol, keys, horizon: float, n_frames: int,
                 delay_model: str, collect_samples: int = 0) -> dict:
    """One GI/G/1 window (``queues._window_sim``): ``lam``/``mu``/``p``
    ``[E, N]`` float32 or float64, ``pol`` ``[E, N]`` int32, ``keys`` the
    epoch keys ``[E, 2]`` int64. Returns tensors ``aopi``/``horizon``/
    ``n_frames``/``n_completed``/``n_accurate`` ``[E, N]`` and, with
    ``collect_samples``, ``delay_samples``."""
    if not _on_cuda(lam):
        return ref.gi_g1_window_ref(lam, mu, p, pol, keys, horizon,
                                    n_frames, delay_model, collect_samples)
    queues.validate_delay_model(delay_model)
    if lam.dim() != 2 or lam.dtype not in kernel.DTYPES:
        raise ValueError(f"gi_g1_window: lam {tuple(lam.shape)} "
                         f"{lam.dtype}, expected [E, N] float32/float64")
    e, n = lam.shape
    dev, dtype = lam.device, lam.dtype
    for name, t in (("lam", lam), ("mu", mu), ("p", p)):
        _check(f"gi_g1_window {name}", t, dtype, (e, n), dev)
    _check("gi_g1_window pol", pol, torch.int32, (e, n), dev)
    _check("gi_g1_window keys", keys, torch.int64, (e, 2), dev)
    n_frames = int(n_frames)
    if n_frames < 1:
        raise ValueError(f"gi_g1_window: n_frames={n_frames}")
    out = torch.empty((5, e * n), dtype=dtype, device=dev)
    capf = min(int(collect_samples), n_frames) if collect_samples else 0
    ns = min(n, queues.SAMPLE_STREAM_CAP) if collect_samples else 0
    samples = (torch.empty((e, ns, capf), dtype=dtype, device=dev)
               if collect_samples else None)
    kernel.gi_g1_window(delay_model, keys, lam, mu, p, pol,
                        float(horizon), n_frames, n, ns, capf, out, samples)
    launches["gi_g1_window"] += 1
    res = {name: out[i].reshape(e, n) for i, name in enumerate(
        ("aopi", "horizon", "n_frames", "n_completed", "n_accurate"))}
    if samples is not None:
        res["delay_samples"] = samples
    return res


def tick_scan(T, O, coin, p, is_lcfsp, live, epoch: float,
              collect_trace: bool = False) -> dict:
    """One engine-rung tick scan (``tick_plane._tick_scan``): the host
    draws ``T``/``O``/``coin`` ``[S, F]`` float64, ``p`` ``[S]`` float64,
    ``is_lcfsp``/``live`` ``[S]`` bool. Returns the final lane state
    ``[S]`` (``kernel.TICK_CARRY``) and, under ``collect_trace``, ``fin``
    float64 and ``done`` bool ``[F, S]``."""
    if not _on_cuda(T):
        return ref.tick_scan_ref(T, O, coin, p, is_lcfsp, live, epoch,
                                 collect_trace)
    if T.dim() != 2:
        raise ValueError(f"tick_scan: T {tuple(T.shape)}, expected [S, F]")
    s, f = T.shape
    dev = T.device
    for name, t in (("T", T), ("O", O), ("coin", coin)):
        _check(f"tick_scan {name}", t, torch.float64, (s, f), dev)
    _check("tick_scan p", p, torch.float64, (s,), dev)
    _check("tick_scan is_lcfsp", is_lcfsp, torch.bool, (s,), dev)
    _check("tick_scan live", live, torch.bool, (s,), dev)
    if f < 1:
        raise ValueError("tick_scan: no frames")
    out = torch.empty((len(kernel.TICK_CARRY), s), dtype=torch.float64,
                      device=dev)
    fin = done = None
    if collect_trace:
        fin = torch.empty((f, s), dtype=torch.float64, device=dev)
        done = torch.empty((f, s), dtype=torch.bool, device=dev)
    kernel.tick_scan(T, O, coin, p, is_lcfsp, live, float(epoch), out, fin,
                     done)
    launches["tick_scan"] += 1
    res = {name: out[i] for i, name in enumerate(kernel.TICK_CARRY)}
    if collect_trace:
        res["fin"], res["done"] = fin, done
    return res
