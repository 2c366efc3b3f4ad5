"""Device mesh for the port (counterpart of ``repro/compat.py:43``).

The reference builds a ``jax.sharding.Mesh`` over its devices and runs
each decomposition inside ``shard_map``. In the port every rank is one
process running the same program on its own block, so a mesh here is
the named shape, this rank's coordinate along each axis (the
counterpart of ``jax.lax.axis_index``), one process group per axis (a
``torch.distributed`` DeviceMesh's dimension groups), and the
``torch.device`` every stage allocates on.

A mesh of one device needs no process group. A larger mesh needs an
initialised default process group of exactly its size; the caller names
the backend there (NCCL with one GPU a rank; gloo moves CUDA tensors
through host memory, which is how several ranks share one card). Ranks
are laid out row-major: rank r sits at ``np.unravel_index(r, shape)``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named mesh axes: ``shape[name]`` is the axis extent, as on a
    ``jax.sharding.Mesh``; ``coordinate[name]`` is this rank's index
    along it; ``group(name)`` is the axis's process group (None on a
    one-device mesh)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    device: torch.device
    coordinate: Dict[str, int]
    device_mesh: Optional[object] = None        # torch DeviceMesh
    hosts: Tuple[str, ...] = ()                 # hostname of each rank

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, name: str):
        """The process group of axis ``name``: the ranks that differ from
        this one only along it, in coordinate order."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(name)


def _default_device() -> torch.device:
    """``cuda:{LOCAL_RANK}``; raises where that device does not exist."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    if local >= count:
        raise ValueError(
            f"the default device cuda:{local} (LOCAL_RANK={local}) does not "
            f"exist: this process sees {count} CUDA device(s); name one, or "
            f"device='cpu'")
    return torch.device("cuda", local)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None) -> Mesh:
    """A mesh over ``device`` (default ``cuda:{LOCAL_RANK}``; the CPU only
    when asked for). More than one device needs the default process
    group initialised with world size ``prod(axis_shapes)``; every rank
    must build its meshes in the same order (building one is
    collective)."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    axis_names = tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis extents for "
                         f"{len(axis_names)} axis names")
    device = _default_device() if device is None else torch.device(device)
    shape = dict(zip(axis_names, axis_shapes))
    size = math.prod(axis_shapes)
    if size == 1:
        return Mesh(axis_names, shape, device, dict.fromkeys(axis_names, 0))
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"mesh {shape} spans {size} ranks but no default process group "
            f"is initialised: call torch.distributed.init_process_group "
            f"(backend, rank and world size {size}) first")
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"mesh {shape} spans {size} ranks but the default "
                         f"process group has {world}")
    if device.type == "cuda":
        # DeviceMesh would otherwise pick the device itself
        torch.cuda.set_device(device)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, axis_shapes, mesh_dim_names=axis_names)
    coord = np.unravel_index(dist.get_rank(), axis_shapes)
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    return Mesh(axis_names, shape, device,
                {n: int(c) for n, c in zip(axis_names, coord)}, dm,
                tuple(hosts))


def axis_crosses_processes(mesh: Mesh, axis_name: str) -> bool:
    """True when a collective over ``axis_name`` leaves one node.

    The reference asks whether moving along the axis changes the owning
    *process* (``Device.process_index``): there one process drives every
    device of a host, so a process boundary is a host boundary. In the
    port every rank is its own process, so that question would be true
    for every axis of more than one rank. The counterpart asked here is
    the one the reference means: whether some ring of the axis spans more
    than one node, from the hostnames the ranks exchanged when the mesh
    was built."""
    if mesh.size == 1:
        return False
    shape = tuple(mesh.shape[n] for n in mesh.axis_names)
    hosts = np.asarray(mesh.hosts, dtype=object).reshape(shape)
    ax = mesh.axis_names.index(axis_name)
    rings = np.moveaxis(hosts, ax, 0).reshape(shape[ax], -1)
    return any(len(set(rings[:, j])) > 1 for j in range(rings.shape[1]))
