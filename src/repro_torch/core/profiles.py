"""Accuracy / complexity / workload profiles (paper §III + §VI-A).

The port's copy of ``repro.core.profiles``. Everything random is drawn on
the host with numpy, seeded exactly as the JAX package seeds it, so the
``HorizonTables`` built here hold the same float32 numbers as the
reference's. Only the container differs: a dataclass of torch tensors on
the chosen device.

  * ``EdgeSystem.tables(t)`` - one slot's profiles as host numpy arrays
    (the per-slot path of ``LBCDController.step``);
  * ``EdgeSystem.horizon(T)`` - the whole horizon as ``HorizonTables``
    (acc ``[T, N, M, R]``, capacity traces ``[T, S]``), moved to the device
    once and consumed by ``repro_torch.core.lbcd.rollout``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

RESOLUTIONS = (384, 512, 640, 768, 896, 1024)
ALPHA_BITS_PER_PIXEL = 1.2          # frame size = alpha * r^2 bits
REF_RESOLUTION = 640


@dataclasses.dataclass(frozen=True)
class ModelCandidate:
    """One selectable recognition model (the paper's m in M)."""
    name: str
    params_m: float          # millions of parameters
    gflops_ref: float        # GFLOPs per frame at REF_RESOLUTION
    p_max: float             # asymptotic accuracy at infinite resolution
    r_knee: float            # resolution scale of the accuracy saturation
    task: str = "detection"

    def xi(self, r: np.ndarray) -> np.ndarray:
        """FLOPs per frame, quadratic in resolution (§III-B)."""
        return self.gflops_ref * 1e9 * (np.asarray(r, np.float64) /
                                        REF_RESOLUTION) ** 2

    def zeta(self, r: np.ndarray, drift: float = 1.0) -> np.ndarray:
        """Accuracy, concave and increasing in r, scaled by content drift."""
        r = np.asarray(r, np.float64)
        base = self.p_max * (1.0 - np.exp(-r / self.r_knee))
        return np.clip(base * drift, 1e-3, 1.0)


def paper_pool() -> list[ModelCandidate]:
    """The paper's §VI-A candidates (YOLOv5n..x, FPN, U-Net, YOLACT,
    Mask R-CNN) with public FLOPs/params numbers."""
    return [
        ModelCandidate("yolov5n", 1.9, 4.5, 0.62, 190.0),
        ModelCandidate("yolov5s", 7.2, 16.5, 0.72, 200.0),
        ModelCandidate("yolov5m", 21.2, 49.0, 0.80, 210.0),
        ModelCandidate("yolov5l", 46.5, 109.1, 0.85, 220.0),
        ModelCandidate("yolov5x", 86.7, 205.7, 0.88, 230.0),
        ModelCandidate("fpn", 23.0, 90.0, 0.82, 215.0, task="segmentation"),
        ModelCandidate("unet", 31.0, 120.0, 0.84, 220.0, task="segmentation"),
        ModelCandidate("yolact", 34.7, 61.6, 0.78, 210.0, task="instance"),
        ModelCandidate("mask_rcnn", 44.2, 134.0, 0.86, 225.0, task="instance"),
    ]


def lm_pool() -> list[ModelCandidate]:
    """LM-architecture ladder: xi = 2 * N_active * (r/16)^2 patch tokens,
    folded into gflops_ref at r=640 (1600 patches)."""
    def g(n_active_b):
        return 2.0 * n_active_b * 1e9 * (640 / 16) ** 2 / 1e9

    return [
        ModelCandidate("qwen2.5-3b", 3_000, g(3.0), 0.74, 205.0, task="lm"),
        ModelCandidate("yi-6b", 6_000, g(6.0), 0.78, 210.0, task="lm"),
        ModelCandidate("minicpm3-4b", 4_000, g(4.0), 0.76, 208.0, task="lm"),
        ModelCandidate("qwen2-moe-a2.7b", 14_000, g(2.7), 0.75, 206.0,
                       task="lm"),
        ModelCandidate("llama-3.2-vision-11b", 11_000, g(11.0), 0.82, 215.0,
                       task="vlm"),
        ModelCandidate("yi-34b", 34_000, g(34.0), 0.87, 222.0, task="lm"),
        ModelCandidate("dbrx-132b", 132_000, g(36.0), 0.89, 226.0, task="lm"),
        ModelCandidate("jamba-1.5-large-398b", 398_000, g(98.0), 0.91, 230.0,
                       task="lm"),
    ]


def shannon_efficiency(snr_db: np.ndarray) -> np.ndarray:
    """bits/s/Hz from Eq. (1): log2(1 + E*G/sigma)."""
    return np.log2(1.0 + 10.0 ** (np.asarray(snr_db, np.float64) / 10.0))


def ar1_scan(u: np.ndarray, rho: float) -> np.ndarray:
    """x[t] = rho * x[t-1] + u[t], x[-1] = 0, by a stride-doubling prefix
    scan (matches the sequential loop to float64 reassociation error)."""
    t_len = u.shape[0]
    coef = np.full(u.shape, rho, dtype=np.float64)
    out = np.asarray(u, np.float64).copy()
    d = 1
    while d < t_len:
        out[d:] = out[d:] + coef[d:] * out[:-d]
        coef[d:] = coef[d:] * coef[:-d]
        d *= 2
    return out


def lognormal_ar1_trace(rng: np.random.Generator, mean: float,
                        shape: tuple[int, int], rho: float = 0.85,
                        sigma: float = 0.25) -> np.ndarray:
    """Lognormal AR(1) capacity trace (Ghent LTE / Bitbrains shape)."""
    e = rng.normal(0.0, sigma, shape)
    u = np.concatenate([e[:1], np.sqrt(1 - rho**2) * e[1:]], axis=0)
    x = ar1_scan(u, rho)
    return mean * np.exp(x - 0.5 * sigma**2)


def drift_path(seed: int, n_slots: int, n_cameras: int,
               rho: float = 0.9, pull: float = 0.1, sigma: float = 0.03,
               lo: float = 0.75, hi: float = 1.0,
               init: np.ndarray | None = None) -> np.ndarray:
    """Per-camera clipped-AR(1) content-drift path ``[T, N]``."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(0.0, sigma, (n_slots, n_cameras))
    state = np.ones(n_cameras) if init is None else np.asarray(init, float)
    out = np.empty((n_slots, n_cameras))
    for t in range(n_slots):
        state = np.clip(rho * state + pull * 1.0 + noise[t], lo, hi)
        out[t] = state
    return out


@dataclasses.dataclass
class SlotTables:
    """One slot's profiles as host numpy: acc[n, m, r], xi[m, r], size[r],
    eff[n]."""
    acc: np.ndarray
    xi: np.ndarray
    size: np.ndarray
    eff: np.ndarray

    @property
    def n_cameras(self) -> int:
        return self.acc.shape[0]


HORIZON_FIELDS = ("acc", "xi", "size", "eff", "budgets_b", "budgets_c",
                  "active")


@dataclasses.dataclass
class HorizonTables:
    """Whole-horizon profiles and capacity traces as tensors on one device.

    Shapes: T slots, N cameras, M models, R resolutions, S servers.
      acc[t, n, m, r]   profiled accuracy (drift applied per slot)
      xi[m, r]          FLOPs per frame
      size[r]           bits per frame
      eff[n] | eff[t, n]  link spectral efficiency (bits/s/Hz)
      budgets_b[t, s]   bandwidth capacity trace (Hz)
      budgets_c[t, s]   compute capacity trace (FLOPS)
      active[t, n]      optional fleet-churn mask (``None``: all live)
    A stack of horizons (``stack_horizons``) carries one more leading axis.
    """
    acc: torch.Tensor
    xi: torch.Tensor
    size: torch.Tensor
    eff: torch.Tensor
    budgets_b: torch.Tensor
    budgets_c: torch.Tensor
    active: torch.Tensor | None = None

    @property
    def n_slots(self) -> int:
        return self.acc.shape[-4]

    @property
    def n_cameras(self) -> int:
        return self.acc.shape[-3]

    @property
    def n_servers(self) -> int:
        return self.budgets_b.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.acc.device

    def to(self, device) -> "HorizonTables":
        """The same horizon on ``device`` (no copy when already there)."""
        return HorizonTables(**{
            f: None if getattr(self, f) is None else getattr(self, f).to(
                device) for f in HORIZON_FIELDS})

    def window(self, t0: int, t1: int) -> "HorizonTables":
        """Slots ``[t0, t1)`` of an (unbatched) horizon."""
        if not 0 <= t0 < t1 <= self.n_slots:
            raise ValueError(f"window [{t0}, {t1}) outside horizon of "
                             f"{self.n_slots} slots")
        return HorizonTables(
            acc=self.acc[t0:t1], xi=self.xi, size=self.size,
            eff=self.eff if self.eff.ndim == 1 else self.eff[t0:t1],
            budgets_b=self.budgets_b[t0:t1],
            budgets_c=self.budgets_c[t0:t1],
            active=None if self.active is None else self.active[t0:t1])


def eff_sequence(tables: HorizonTables) -> torch.Tensor:
    """The per-slot link-efficiency sequence ``[T, N]`` of a horizon."""
    n_slots = tables.acc.shape[0]
    if tables.eff.ndim == 1:
        return tables.eff[None, :].expand(n_slots, tables.eff.shape[0])
    return tables.eff


def stack_horizons(tables: Sequence[HorizonTables]) -> HorizonTables:
    """Stack same-shape horizons along a new leading axis. Raises
    ``ValueError`` naming the field whose shapes disagree."""
    tables = list(tables)
    if not tables:
        raise ValueError("stack_horizons: need at least one horizon")
    if any(t.active is not None for t in tables):
        tables = [
            t if t.active is not None else dataclasses.replace(
                t, active=torch.ones((t.n_slots, t.n_cameras),
                                     dtype=t.acc.dtype, device=t.device))
            for t in tables]
    ref = tables[0]
    for i, tab in enumerate(tables[1:], start=1):
        for name in HORIZON_FIELDS:
            a, b = getattr(ref, name), getattr(tab, name)
            if a is None and b is None:
                continue
            if a.shape != b.shape:
                raise ValueError(
                    f"stack_horizons: shape mismatch on field {name!r}: "
                    f"horizons[0] has {tuple(a.shape)}, horizons[{i}] has "
                    f"{tuple(b.shape)} — all stacked horizons must share "
                    f"(T, N, M, R, S) and eff rank")
    return HorizonTables(**{
        name: None if getattr(ref, name) is None else torch.stack(
            [getattr(t, name) for t in tables]) for name in HORIZON_FIELDS})


def horizon_from_numpy(fields: dict[str, np.ndarray], device,
                       dtype=torch.float32) -> HorizonTables:
    """Build ``HorizonTables`` on ``device`` from host arrays keyed by field
    name (``active`` optional). The values are cast to ``dtype`` by numpy,
    so float64 inputs round exactly as ``jnp.asarray(x, float32)`` does."""
    dev = resolve_device(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    out = {}
    for name in HORIZON_FIELDS:
        arr = fields.get(name)
        out[name] = None if arr is None else torch.from_numpy(
            np.array(arr, np_dtype, order="C")).to(dev)
    return HorizonTables(**out)


def slot_horizon(tables: SlotTables, budgets_b, budgets_c, device,
                 dtype=torch.float32) -> HorizonTables:
    """A one-slot ``HorizonTables`` on ``device`` of one slot's host
    profiles and its capacities (``budgets_b`` / ``budgets_c``: [S])."""
    return horizon_from_numpy(
        dict(acc=tables.acc[None], xi=tables.xi, size=tables.size,
             eff=tables.eff, budgets_b=np.asarray(budgets_b)[None],
             budgets_c=np.asarray(budgets_c)[None]), device, dtype=dtype)


def horizon_to_numpy(tables: HorizonTables) -> dict[str, np.ndarray]:
    """Inverse of :func:`horizon_from_numpy`: host arrays keyed by field."""
    return {name: getattr(tables, name).cpu().numpy()
            for name in HORIZON_FIELDS if getattr(tables, name) is not None}


@dataclasses.dataclass
class EdgeSystem:
    """Scenario container: cameras, servers, traces, profiles (§VI-A)."""
    n_cameras: int = 30
    n_servers: int = 3
    n_slots: int = 200
    mean_bandwidth_hz: float = 30e6          # per server
    mean_compute_flops: float = 50e12        # per server
    pool: Sequence[ModelCandidate] = dataclasses.field(
        default_factory=paper_pool)
    resolutions: Sequence[int] = RESOLUTIONS
    alpha: float = ALPHA_BITS_PER_PIXEL
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.snr_db = rng.uniform(12.0, 22.0, size=self.n_cameras)
        self._difficulty = rng.uniform(0.88, 1.0, size=self.n_cameras)
        self._drift_state = np.ones(self.n_cameras)
        self._drift_rng = np.random.default_rng(self.seed + 1)
        self.bandwidth_trace = lognormal_ar1_trace(
            rng, self.mean_bandwidth_hz, (self.n_slots, self.n_servers))
        self.compute_trace = lognormal_ar1_trace(
            rng, self.mean_compute_flops, (self.n_slots, self.n_servers))

    def reset(self) -> "EdgeSystem":
        """Restore the per-slot drift RNG/state to the post-construction
        point."""
        self._drift_state = np.ones(self.n_cameras)
        self._drift_rng = np.random.default_rng(self.seed + 1)
        return self

    def advance_drift(self) -> np.ndarray:
        """One AR(1) step of per-camera content drift in [0.75, 1.0]."""
        noise = self._drift_rng.normal(0.0, 0.03, self.n_cameras)
        self._drift_state = np.clip(
            0.9 * self._drift_state + 0.1 * 1.0 + noise, 0.75, 1.0)
        return self._drift_state

    def tables(self, t: int, drift: np.ndarray | None = None) -> SlotTables:
        """Profile zeta/xi for slot t (Algorithm 3 line 3)."""
        if drift is None:
            drift = self.advance_drift()
        res = np.asarray(self.resolutions, np.float64)
        m_count = len(self.pool)
        acc = np.zeros((self.n_cameras, m_count, len(res)))
        xi = np.zeros((m_count, len(res)))
        for j, m in enumerate(self.pool):
            xi[j] = m.xi(res)
            zr = m.zeta(res)
            acc[:, j, :] = (self._difficulty * drift)[:, None] * zr[None, :]
        size = self.alpha * res**2
        eff = shannon_efficiency(self.snr_db)
        return SlotTables(acc=np.clip(acc, 1e-3, 1.0), xi=xi, size=size,
                          eff=eff)

    def capacities(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        t = t % self.n_slots
        return self.bandwidth_trace[t], self.compute_trace[t]

    def horizon_numpy(self, n_slots: int | None = None
                      ) -> dict[str, np.ndarray]:
        """The horizon's float64 host arrays, keyed by field name."""
        n_slots = self.n_slots if n_slots is None else n_slots
        drift = drift_path(self.seed + 1, n_slots, self.n_cameras)  # [T, N]
        res = np.asarray(self.resolutions, np.float64)
        zr = np.stack([m.zeta(res) for m in self.pool])        # [M, R]
        xi = np.stack([m.xi(res) for m in self.pool])          # [M, R]
        acc = (self._difficulty[None, :] * drift)[:, :, None, None] * \
            zr[None, None, :, :]                               # [T, N, M, R]
        idx = np.arange(n_slots) % self.n_slots
        return dict(acc=np.clip(acc, 1e-3, 1.0), xi=xi,
                    size=self.alpha * res**2,
                    eff=shannon_efficiency(self.snr_db),
                    budgets_b=self.bandwidth_trace[idx],
                    budgets_c=self.compute_trace[idx])

    def horizon(self, n_slots: int | None = None, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> HorizonTables:
        """Pregenerate ``n_slots`` of profiles and capacities on ``device``.

        Deterministic in ``(self.seed, n_slots)`` and bitwise equal to the
        JAX package's ``EdgeSystem.horizon`` cast to the same dtype.
        """
        return horizon_from_numpy(self.horizon_numpy(n_slots), device,
                                  dtype=dtype)
