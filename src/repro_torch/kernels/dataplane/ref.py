"""Plain PyTorch versions of the data-plane kernels: the loops of
``core.queues._window_sim`` (the GI/G/1 window) and
``serving.tick_plane._tick_scan`` (the engine rung's tick scan), which
the wrappers in ``ops`` take for tensors on the CPU and the tests and
``chip_smoke.py`` hold the kernels against on the card. They live beside
the code that calls them and are imported here at call time."""
from __future__ import annotations


def gi_g1_window_ref(lam, mu, p, pol, keys, horizon: float, n_frames: int,
                     delay_model: str, collect_samples: int = 0) -> dict:
    """``core.queues._window_sim``."""
    from ...core import queues
    return queues._window_sim(lam, mu, p, pol, keys, horizon, n_frames,
                              delay_model, collect_samples)


def tick_scan_ref(T, O, coin, p, is_lcfsp, live, epoch: float,
                  collect_trace: bool = False) -> dict:
    """``serving.tick_plane._tick_scan``."""
    from ...serving import tick_plane
    return tick_plane._tick_scan(T, O, coin, p, is_lcfsp, live, epoch,
                                 collect_trace)
