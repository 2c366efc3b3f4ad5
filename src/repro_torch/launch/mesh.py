"""Mesh construction — host, production, multi-host DCN × ICI, and the
M→N transit split (counterpart of ``repro/launch/mesh.py``).

Everything here is a function, so importing this module touches no
process group. In the port one process drives one device, so a mesh's
positions are global ranks (``compat.make_mesh`` / ``make_explicit_mesh``),
and building a mesh of more than one rank is collective on every rank of
the world.

* ``make_host_mesh`` — the mesh over the world's ranks ((2, 2)
  ``("data", "model")`` on four), every axis extent 1 in one process,
  on the CUDA device unless the caller asks for the CPU (the entry
  points, the examples, the FFT serving engine's lazy default).
* ``make_production_mesh`` — the full-fleet shapes, (16, 16) or
  (2, 16, 16): it needs a world of that many ranks.
* ``make_multihost_mesh`` — explicit **DCN axes** (outer, crossing
  hosts) × **ICI axes** (inner, within one host), over the ranks ordered
  host-major (hosts in the order of their first rank), so the DCN axes
  really cross nodes; ``describe_mesh`` shows which axes do.
* ``make_transit_meshes`` / ``make_transit_setup`` — disjoint producer
  and consumer meshes (the first m ranks produce, the last n consume)
  and the ``TransitBridge`` between them (``core/insitu/transit.py``).
* ``make_elastic_setup`` — the same split with the consumer side owned
  by a ``runtime.elastic.ElasticController``, which rebuilds the
  consumer mesh (``make_consumer_mesh``) when a consumer rank dies or
  rejoins.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.compat import (Mesh, make_explicit_mesh, make_mesh,
                                mesh_process_span, mesh_process_topology,
                                world_hosts)


def _world() -> int:
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def make_host_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device=None) -> Mesh:
    """The mesh over the world's ranks (tests, examples, the entry
    points, the serving engine's default), as the reference's is over
    its devices.

    A world of exactly ``prod(shape)`` ranks gets ``shape``. As in the
    reference, a shape that does not fit falls back to a layout over
    however many ranks there are, so callers get *a* mesh, not an
    error: a smaller world of more than one rank spans its first axis
    (the others of extent 1), one process gets every extent 1. A world
    larger than ``shape`` raises. Building a mesh of more than one rank
    is collective on every rank. ``device`` defaults to
    ``cuda:{LOCAL_RANK}`` and raises where that device does not exist;
    ``device="cpu"`` builds the mesh on the CPU."""
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} axis extents for {len(axes)} axis "
                         f"names")
    world, need = _world(), math.prod(shape)
    if world == 1:
        return make_mesh((1,) * len(axes), axes, device=device)
    if world > need:
        raise ValueError(f"host mesh {dict(zip(axes, shape))} spans {need} "
                         f"ranks; the world has {world}")
    if world < need:
        shape = (world,) + (1,) * (len(axes) - 1)
    return make_mesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The full-fleet shapes the reference's dry-run compiles the big
    configs against: (data, model) = (16, 16), with a leading pod axis
    when ``multi_pod``. Needs a world of exactly that many ranks (one
    device each)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = math.prod(shape), _world()
    if world != need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {need} "
            f"ranks, one device each; the world has {world}")
    return make_mesh(shape, axes, device=device)


def _host_major_ranks() -> Tuple[list, int]:
    """Every global rank ordered host-major (hosts in the order of their
    first rank, ranks ascending within a host), and the host count
    (collective)."""
    hosts = world_hosts()
    order: Dict[str, list] = {}
    for rank, host in enumerate(hosts):
        order.setdefault(host, []).append(rank)
    return [r for ranks in order.values() for r in ranks], len(order)


def make_multihost_mesh(dcn_axes: Optional[Dict[str, int]] = None,
                        ici_axes: Optional[Dict[str, int]] = None, *,
                        device=None) -> Mesh:
    """A mesh with explicit DCN × ICI axis splits over the world's ranks.

    ``dcn_axes``/``ici_axes`` are ordered ``{axis_name: size}`` dicts;
    the mesh's axis order is DCN axes first (outermost, cross-host),
    then ICI axes. Defaults: one DCN axis ``"dcn"`` over the hosts and
    one ICI axis ``"data"`` over the ranks a host — the natural (hosts ×
    local ranks) grid. The product of the sizes must equal the world
    size. One process works too (a one-rank mesh)."""
    order, nhosts = _host_major_ranks()
    world = len(order)
    if dcn_axes is None:
        dcn_axes = {"dcn": nhosts}
    if ici_axes is None:
        ici_axes = {"data": world // max(1, math.prod(dcn_axes.values()))}
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    total = math.prod(shape)
    if total != world:
        raise ValueError(
            f"mesh shape {dict(zip(names, shape))} needs {total} ranks, "
            f"cluster has {world} ({nhosts} host(s) × "
            f"{world // max(nhosts, 1)} local)")
    return make_explicit_mesh(np.asarray(order).reshape(shape), names,
                              device=device)


def _transit_ranks(m: int, n: int, exclude_ids) -> Tuple[list, list]:
    """The producer ranks (the first ``m`` of the pool) and the consumer
    ranks (its last ``n``), the pool being the world's ranks less
    ``exclude_ids``."""
    ranks = list(range(_world()))
    if exclude_ids:
        dead = {int(i) for i in exclude_ids}
        ranks = [r for r in ranks if r not in dead]
    if m + n > len(ranks):
        raise ValueError(f"transit split {m}+{n} exceeds "
                         f"{len(ranks)} available ranks")
    if m < 1 or n < 1:
        raise ValueError("both meshes need at least one rank")
    return ranks[:m], ranks[-n:]


def _line_mesh(ranks, axes, device) -> Mesh:
    """A mesh whose first axis runs over ``ranks`` (the others of extent
    1)."""
    shape = (len(ranks),) + (1,) * (len(axes) - 1)
    return make_explicit_mesh(np.asarray(ranks).reshape(shape), tuple(axes),
                              device=device)


def make_transit_meshes(m: int, n: int, *,
                        producer_axes: Sequence[str] = ("data",),
                        consumer_axes: Sequence[str] = ("data",),
                        exclude_ids: Optional[Sequence[int]] = None,
                        device=None) -> Tuple[Mesh, Mesh]:
    """Disjoint producer/consumer meshes for the M→N in-transit path:
    the first ``m`` ranks produce, the last ``n`` consume, each a mesh
    with its first axis over them (the others of extent 1). Requires
    ``m + n <=`` the ranks available: producer and consumer must not
    share ranks, that is the whole point.

    ``exclude_ids`` (global ranks) removes ranks from the pool before
    the split — the elastic rescale rebuilds the consumer mesh over the
    survivors of a failure with it (``make_consumer_mesh``), while the
    producer prefix stays as it was. Collective on every rank."""
    pranks, cranks = _transit_ranks(m, n, exclude_ids)
    return (_line_mesh(pranks, producer_axes, device),
            _line_mesh(cranks, consumer_axes, device))


def make_consumer_mesh(m: int, n: int, *,
                       consumer_axes: Sequence[str] = ("data",),
                       exclude_ids: Optional[Sequence[int]] = None,
                       device=None) -> Mesh:
    """The consumer mesh of ``make_transit_meshes(m, n, ...)`` alone: an
    elastic rescale keeps its producer mesh and rebuilds only this one
    (a producer mesh built again would make process groups nobody uses).
    Collective on every rank."""
    _, cranks = _transit_ranks(m, n, exclude_ids)
    return _line_mesh(cranks, consumer_axes, device)


def make_transit_setup(n_consumers: int, *,
                       producer_axes: Sequence[str] = ("data", "model"),
                       consumer_axes: Sequence[str] = ("data",),
                       noun: str = "producer",
                       flag: str = "--transit-consumers", device=None):
    """The entry points' shared ``--transit-consumers`` bring-up: split the
    world into a (world - N)-rank producer mesh and an N-rank consumer
    mesh, check that every rank has a role
    (``transit.require_producer_spans_cluster``), and build the bridge.
    Returns ``(producer_mesh, TransitBridge)``; invalid splits raise
    ``SystemExit`` with an operator-facing message naming ``flag``
    (``noun`` is the entry point's word for producer ranks, e.g.
    "decode"). Collective on every rank."""
    from repro_torch.core.insitu.transit import (
        TransitBridge, require_producer_spans_cluster)
    world = _world()
    if n_consumers >= world:
        raise SystemExit(
            f"{flag} {n_consumers} leaves no {noun} ranks (have {world})")
    producer_mesh, consumer_mesh = make_transit_meshes(
        world - n_consumers, n_consumers, producer_axes=producer_axes,
        consumer_axes=consumer_axes, device=device)
    try:
        require_producer_spans_cluster(producer_mesh, flag,
                                       consumer_mesh=consumer_mesh)
    except ValueError as err:
        raise SystemExit(str(err)) from None
    return producer_mesh, TransitBridge(producer_mesh, consumer_mesh)


def make_elastic_setup(n_consumers: int, *,
                       producer_axes: Sequence[str] = ("data", "model"),
                       consumer_axes: Sequence[str] = ("data",),
                       noun: str = "producer",
                       flag: str = "--elastic", device=None,
                       **controller_kwargs):
    """The entry points' ``--elastic`` bring-up: like ``make_transit_setup``
    but the consumer side is owned by a
    ``runtime.elastic.ElasticController`` that can rescale it at run
    time (failure-driven shrink, operator grow) while the producer mesh
    stays untouched. Returns ``(producer_mesh, controller)``; the
    controller duck-types the bridge (``send``/``is_consumer``/...), so
    entry points pass it anywhere a ``TransitBridge`` goes and sends
    route to the newest bridge. Invalid splits raise ``SystemExit``
    naming ``flag``. ``controller_kwargs`` go to ``ElasticController``
    (``lease=``, ``max_misses=``, ``clock=``, ``plan_kwargs=``, ...).
    Collective on every rank."""
    from repro_torch.runtime.elastic import ElasticController
    world = _world()
    if n_consumers >= world:
        raise SystemExit(
            f"{flag} with {n_consumers} consumers leaves no {noun} "
            f"ranks (have {world})")
    try:
        controller = ElasticController(
            n_consumers, producer_axes=producer_axes,
            consumer_axes=consumer_axes, flag=flag, device=device,
            **controller_kwargs)
    except ValueError as err:
        raise SystemExit(str(err)) from None
    return controller.producer_mesh, controller


def describe_mesh(mesh: Mesh) -> Dict[str, object]:
    """Operator-facing mesh summary: shape, axis → crosses-hosts, and
    the global ranks it spans."""
    return {
        "shape": dict(mesh.shape),
        "axis_crosses_hosts": mesh_process_topology(mesh),
        "processes": mesh_process_span(mesh),
        "devices": int(mesh.size),
    }
