"""PyTorch/CUDA port of the LBCD edge video analytics system.

Mirrors the layout of the JAX package ``repro``: ``core`` holds the AoPI
closed forms, profiles, allocators and Algorithms 1-3; ``configs``,
``models`` and ``serving`` hold the LM serving path (the continuous-
batching ``serving.Engine`` over ``models.build(cfg)``); ``kernels`` holds
the hand-written CUDA kernels (slot solver, flash attention, flash decode,
the chunkwise mLSTM) beside their plain PyTorch versions; ``training``
holds the optimizer, the train step and island failover; ``sharding`` and
``launch.{mesh,specs}`` run the models over meshes of ranks
(``torch.distributed``); ``launch.serve`` and ``launch.train`` are the
launchers. Importing this package imports neither JAX nor ``repro``.
"""
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
