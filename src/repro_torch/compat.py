"""Device mesh for the port (counterpart of ``repro/compat.py:43``).

The reference builds a ``jax.sharding.Mesh`` over its devices and runs
each decomposition inside ``shard_map``. In the port every rank is one
process running the same program on its own block, so a mesh here is
the named shape, the global ranks it spans (row-major: mesh position p
is rank ``ranks[p]``), this rank's coordinate along each axis (the
counterpart of ``jax.lax.axis_index``; None on a rank outside the mesh,
which does no device work on it), one process group per axis, a group
over the whole mesh, and the ``torch.device`` every stage allocates on.

A mesh of one device needs no process group. A larger mesh needs an
initialised default process group; the caller names the backend there
(NCCL with one GPU a rank; gloo moves CUDA tensors through host memory,
which is how several ranks share one card). ``make_mesh`` spans the
whole world; ``make_mesh(..., ranks=...)`` and ``make_explicit_mesh``
span a subset of it, as the reference's ``make_explicit_mesh`` does
over a device array. ``dist.new_group`` must be called by every rank of
the default group, members or not, in one order, so building a mesh of
more than one rank is collective on EVERY rank of the world.

Each mesh of more than one rank also makes a gloo group over its ranks
(``host_group``) for a pipelined chain's host tail (``chain.py``): a
group made later, by the mesh's members alone, would need the other
ranks to take part too. ``dist.new_group`` orders a group's ranks
ascending, so along every axis the ranks must ascend with the
coordinate (an exchange sends chunk j to the ring's group rank j); the
mesh-wide gathers map group ranks back to mesh positions.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named mesh axes: ``shape[name]`` is the axis extent, as on a
    ``jax.sharding.Mesh``; ``coordinate[name]`` is this rank's index
    along it (None: this rank is outside the mesh); ``group(name)`` is
    the axis's process group (None on a one-device mesh and off it);
    ``ranks`` are the global ranks at the mesh positions, row-major
    (empty: ranks 0..size-1)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    device: torch.device
    coordinate: Optional[Dict[str, int]]
    hosts: Tuple[str, ...] = ()                 # hostname of each position
    ranks: Tuple[int, ...] = ()
    axis_groups: Dict[str, object] = dataclasses.field(default_factory=dict)
    # every rank of the mesh, for its reductions and gathers (None: the
    # world's default group, which the mesh then spans)
    mesh_group: Optional[object] = None
    # gloo, over the mesh's ranks: the pipelined chain's host tail
    host_group: Optional[object] = None
    # the pipelined chain holding host_group, weakly (one at a time)
    _host_claim: List[object] = dataclasses.field(default_factory=list,
                                                  repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def members(self) -> Tuple[int, ...]:
        """The global rank at each mesh position, row-major."""
        return self.ranks or tuple(range(self.size))

    @property
    def first_rank(self) -> int:
        """The global rank at mesh position 0 (the writer's rank)."""
        return self.members[0]

    @property
    def is_member(self) -> bool:
        """Whether this rank holds a position of the mesh."""
        return self.coordinate is not None

    def group(self, name: str):
        """The process group of axis ``name``: the ranks that differ from
        this one only along it, in coordinate order."""
        return self.axis_groups.get(name)

    def claim_host_group(self, owner) -> None:
        """Give ``host_group`` to ``owner`` (a pipelined chain). Two
        pipelined chains gathering on one group from two workers would
        pair one chain's gather with the other's on different ranks, so
        a second live claim raises."""
        with _CLAIM_LOCK:
            held = self._host_claim[0]() if self._host_claim else None
            if held is not None and held is not owner:
                raise ValueError(
                    f"mesh {dict(self.shape)} over ranks {self.members} "
                    f"already runs a pipelined chain; its host group serves "
                    f"one at a time: finalize that chain, or build a second "
                    f"mesh (collectively) for this one")
            self._host_claim[:] = [weakref.ref(owner)]

    def release_host_group(self, owner) -> None:
        with _CLAIM_LOCK:
            if self._host_claim and self._host_claim[0]() is owner:
                self._host_claim.clear()


_CLAIM_LOCK = threading.Lock()


def _current_cuda() -> int:
    """The current CUDA device's index (``runtime.cluster.init_cluster``
    sets it); 0 before CUDA is initialised."""
    return torch.cuda.current_device() if torch.cuda.is_initialized() else 0


def _default_device() -> torch.device:
    """``cuda:{LOCAL_RANK}`` (without ``LOCAL_RANK``, the current CUDA
    device); raises where that device does not exist."""
    count = torch.cuda.device_count()
    env = os.environ.get("LOCAL_RANK")
    local = _current_cuda() if env is None else int(env)
    if local >= count:
        raise ValueError(
            f"the default device cuda:{local} (LOCAL_RANK={local}) does not "
            f"exist: this process sees {count} CUDA device(s); name one, or "
            f"device='cpu'")
    return torch.device("cuda", local)


def _hostname() -> str:
    return socket.gethostname()


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_hosts() -> List[str]:
    """The hostname of every global rank, by rank (collective over the
    world; this host alone without a process group)."""
    if not _initialized():
        return [_hostname()]
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, _hostname())
    return hosts


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over ``device`` (default ``cuda:{LOCAL_RANK}``; the CPU only
    when asked for). Without ``ranks`` it spans the world: more than one
    device then needs the default process group initialised with world
    size ``prod(axis_shapes)``. ``ranks`` (row-major, one per position)
    spans those global ranks only; a rank outside them gets the mesh with
    ``coordinate=None``. Every rank of the world must build its meshes of
    more than one rank in the same order (building one is collective)."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    axis_names = tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis extents for "
                         f"{len(axis_names)} axis names")
    device = _default_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _current_cuda())
    shape = dict(zip(axis_names, axis_shapes))
    size = math.prod(axis_shapes)
    me = dist.get_rank() if _initialized() else 0
    if ranks is None and size == 1:
        return Mesh(axis_names, shape, device, dict.fromkeys(axis_names, 0),
                    ranks=(me,))
    if not _initialized() and (size > 1 or tuple(ranks) != (0,)):
        raise ValueError(
            f"mesh {shape} spans {size} ranks but no default process group "
            f"is initialised: call torch.distributed.init_process_group "
            f"(backend, rank and world size {size}) first")
    world = dist.get_world_size() if _initialized() else 1
    if ranks is None:
        if world != size:
            raise ValueError(f"mesh {shape} spans {size} ranks but the "
                             f"default process group has {world}")
        ranks = range(world)
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != size or len(set(ranks)) != size:
        raise ValueError(f"mesh {shape} needs {size} distinct ranks, got "
                         f"{ranks}")
    if not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} outside the world of {world}")
    pos = ranks.index(me) if me in ranks else None
    coord = (None if pos is None else
             {n: int(c) for n, c in
              zip(axis_names, np.unravel_index(pos, axis_shapes))})
    if size == 1:
        return Mesh(axis_names, shape, device, coord, ranks=ranks)
    grid = np.asarray(ranks).reshape(axis_shapes)
    for ax, name in enumerate(axis_names):
        rings = np.moveaxis(grid, ax, -1).reshape(-1, axis_shapes[ax])
        if (np.diff(rings, axis=1) <= 0).any():
            raise ValueError(
                f"mesh {shape} over ranks {ranks}: along axis {name!r} the "
                f"ranks must ascend with the coordinate (process groups "
                f"order their ranks ascending)")
    hosts = world_hosts()
    groups = {}
    whole = ranks == tuple(range(world))
    for ax, name in enumerate(axis_names):       # every rank, one order
        for ring in np.moveaxis(grid, ax, -1).reshape(-1, axis_shapes[ax]):
            # an axis over the whole world is the default group, as on
            # a DeviceMesh (meshes sharing it share their plans)
            g = (dist.group.WORLD if len(ring) == world
                 else dist.new_group([int(r) for r in ring]))
            if me in ring:
                groups[name] = g
    mesh_group = None if whole else dist.new_group(sorted(ranks))
    # the host tail's group is gloo's; a world of the "fake" backend
    # (one process standing in for every rank: the dry run) has no gloo
    # store, so its host group is a fake one too
    host_group = dist.new_group(
        sorted(ranks),
        backend="fake" if dist.get_backend() == "fake" else "gloo")
    if pos is None:
        groups, mesh_group, host_group = {}, None, None
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(axis_names, shape, device, coord,
                hosts=tuple(hosts[r] for r in ranks), ranks=ranks,
                axis_groups=groups, mesh_group=mesh_group,
                host_group=host_group)


def make_explicit_mesh(ranks, axis_names: Sequence[str], *,
                       device=None) -> Mesh:
    """A mesh over an exactly placed array of global ranks (counterpart
    of the reference's ``make_explicit_mesh`` over a device array): the
    array's shape is the mesh's, its row-major order the positions'."""
    arr = np.asarray(ranks)
    return make_mesh(arr.shape, axis_names, device=device,
                     ranks=arr.ravel().tolist())


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


def mesh_process_topology(mesh: Mesh) -> Dict[str, bool]:
    """Axis name → crosses-hosts, for every axis of ``mesh``."""
    return {n: axis_crosses_processes(mesh, n) for n in mesh.axis_names}


def mesh_process_span(mesh: Mesh) -> List[int]:
    """The global ranks the mesh spans, ascending (the reference's
    process indices: one process a rank here)."""
    return sorted(mesh.members)
