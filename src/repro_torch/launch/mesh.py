"""Meshes of ranks over ``torch.distributed`` (the JAX package's
``launch/mesh.py``).

A :class:`Mesh` names its axes and their extents, as a JAX mesh's
``shape`` does, and holds one process group per axis
(``torch.distributed.device_mesh.init_device_mesh``) and this rank's
device. The port's SPMD is explicit: every rank holds its own slice of
each tensor, and the model code issues the collectives over an axis's
group (``sharding.ctx``).

Backends: NCCL on the card (each rank on ``cuda:LOCAL_RANK``, set before
the group is made, so every ``device="cuda"`` of the port and every
kernel launch lands on that rank's card), gloo on the CPU, asked for by
name as everywhere in the port. A mesh of more ranks than the world, or
than the cards of this host, raises; none runs on fewer.

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve_device


class Mesh:
    """Named mesh axes over the ranks of the default group.

    ``shape`` maps axis name -> extent (row-major over ``axis_names``, the
    last axis fastest, as ``init_device_mesh`` lays ranks out). A
    shape-only mesh (``device_mesh`` None) serves the accounting
    (``make_production_mesh``) and runs nothing."""

    def __init__(self, axis_names, axis_shapes, device_mesh=None,
                 device=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, map(int, axis_shapes)))
        self.device_mesh = device_mesh
        self.device = device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        if self.device_mesh is None:
            raise RuntimeError("a shape-only mesh has no process groups")
        return self.device_mesh.get_group(axis)

    def extent(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def coord(self, axes) -> int:
        """This rank's index along ``axes`` (one name, or a tuple read
        row-major: the first axis major, as a JAX ``PartitionSpec`` entry
        of several axes splits a dim)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            local = self.device_mesh.get_local_rank(a) if a in self.shape \
                else 0
            idx = idx * self.shape.get(a, 1) + local
        return idx

    def __repr__(self) -> str:
        kind = "shape-only" if self.device_mesh is None else str(self.device)
        return f"Mesh({self.shape}, {kind})"


def init_distributed(device=DEFAULT_DEVICE, *, rank: int | None = None,
                     world_size: int | None = None, store=None,
                     init_method: str | None = None,
                     local_rank: int | None = None) -> torch.device:
    """Join the default process group (NCCL for ``cuda``, gloo for the
    CPU) and return this rank's device. Rank and world come from the
    arguments, else from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, rendezvous ``env://``), else a world of
    one (an in-process store). On the card, ``torch.cuda.set_device``
    runs first; a local rank without a card raises."""
    dev = resolve_device(device)
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None \
        else local_rank
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} (local {local_rank}) has no card: "
                f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    if dist.is_initialized():
        return dev
    if store is None and init_method is None:
        if world_size == 1 and "MASTER_ADDR" not in env:
            store = dist.HashStore()
        else:
            init_method = "env://"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


def make_mesh(axis_shapes, axis_names, *, device=DEFAULT_DEVICE) -> Mesh:
    """A mesh of ``axis_shapes`` over the default group's ranks, which
    must number exactly ``prod(axis_shapes)`` (a mesh of one rank forms
    the group itself if none is joined yet). Raises on a mesh larger than
    the cards of this host, on a CUDA mesh over a gloo group, and on a
    world of another size."""
    dev = resolve_device(device)
    axis_shapes, axis_names = tuple(axis_shapes), tuple(axis_names)
    n = math.prod(axis_shapes)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"a mesh of {n} ranks needs {n} cards; "
                           f"{torch.cuda.device_count()} visible")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a process group: run under "
                "torchrun, or call launch.mesh.init_distributed first")
        dev = init_distributed(dev)
    elif dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {dict(zip(axis_names, axis_shapes))} has "
                         f"{n} ranks; the group has {world}")
    backend = dist.get_backend()
    if dev.type == "cuda" and backend != "nccl":
        raise RuntimeError(f"a CUDA mesh needs NCCL; the group runs "
                           f"{backend}")
    if dev.type == "cpu" and backend != "gloo":
        raise RuntimeError(f"a CPU mesh needs gloo; the group runs "
                           f"{backend}")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(dev.type, axis_shapes, mesh_dim_names=axis_names)
    return Mesh(axis_names, axis_shapes, dm, dev)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 ranks, or 2x16x16 = 512 with ``multi_pod``: a
    shape-only mesh for the accounting (placements, bytes per device)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(model: int = 1, *, device=DEFAULT_DEVICE) -> Mesh:
    """A (data, model) mesh over the default group's world (a world of
    one, formed here, when no group is joined): data = world // model."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = max(n // model, 1)
    return make_mesh((data, model), ("data", "model"), device=device)
