"""Elastic consumer-mesh rescaling — N→M at run time, producer intact
(counterpart of ``repro/runtime/elastic.py``).

An :class:`ElasticController` owns the consumer side of an M→N transit
split (``launch/mesh.make_transit_meshes``) and rescales it — shrink
when the :class:`~repro_torch.runtime.fault.FailureDetector` declares a
consumer rank dead, grow when capacity rejoins — while the producer
mesh, and the producers' loop built against it, never change.

The rank model: in the reference a pool position is a device, and one
process may hold several. Here a process is one rank driving one
device, so a pool position is a **global rank**: the world's ranks split
into a fixed producer prefix (the first ``world - n_consumers``) and a
consumer pool (the rest), and pool position r is forever global rank
``producer_ranks + r``, alive or dead. A rescale excludes dead ranks
from the pool and rebuilds the consumer mesh over the last ``n``
survivors (``launch.mesh.make_consumer_mesh`` with ``exclude_ids``,
global ranks); exclusions never reach the producer prefix, so the
producer mesh is the same object across generations.

One rescale walks the state machine ``serving → draining →
rebuilding → serving``:

1. **draining** — an attached
   :class:`~repro_torch.serve.fft_engine.FFTServeEngine` either drains
   (graceful, operator-driven) or fail-contains its pending requests
   (failure-driven: the old mesh is not trustworthy; each un-launched
   request fails alone with ``MeshRescaled``) and swaps onto the new
   mesh.
2. **rebuilding** — the old bridge's async hop is drained and closed
   first (``TransitBridge.close_async``), so no in-flight
   ``send_async`` work interleaves with the new mesh; then cached plans
   keyed on the old *and* new consumer meshes are evicted
   (``plan.plan_cache_evict``, on every rank): the bring-up of the new
   mesh is a plan-cache miss → **wisdom** read-through. The wisdom
   fingerprint holds no group or device id, so a rescaled mesh with the
   shape and placement of an earlier generation warm-starts from the
   wisdom that generation recorded — ``plan_stats()`` shows
   ``wisdom_hits > 0`` with ``sweep_candidates_timed == 0`` after a
   grow. (A rejoined rank's cache kept no gen-0 plan: its plans were
   evicted with the mesh it left, and a new mesh has new process groups,
   which the plan key holds.)
3. A fresh :class:`~repro_torch.core.insitu.transit.TransitBridge` is
   built over the new mesh; later ``send``\\ s route through it.

**Collective contract.** ``tick()`` and ``rescale()`` are collectives on
EVERY rank of the world — producers, consumers, and an excluded pool
rank alike — called at the same point of each rank's loop:

* ``tick()`` runs one ``dist.broadcast`` of a fixed-size int32 rank
  bitmask from rank 0 on the world group, unconditionally, so rank 0's
  death verdict wins everywhere and collective counts never diverge
  (one process: the identity).
* ``rescale()`` builds the new consumer mesh and bridge, and
  ``dist.new_group`` must be called by every rank of the world in one
  order. A rank "declared dead" therefore still takes part in the
  bring-up. The chaos harness injects a death by dropping heartbeats, so
  the dead rank's process lives and this holds; **a rank whose process
  has really died would hang the rebuild** (a process group cannot be
  made without it; recovering from that needs a new world, i.e. a
  restart through checkpoints, ``fault.run_with_restarts``).

The controller duck-types the ``TransitBridge`` surface (``send`` /
``send_async`` / ``drain_async`` / ``close_async`` / ``is_producer`` /
``is_consumer`` / ``reset_stats``), so entry points pass it anywhere a
bridge goes and sends target the newest generation.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.compat import mesh_process_span
from repro_torch.core.fft.plan import (FORWARD, plan_cache_evict,
                                       plan_cache_stats, plan_dft)
from repro_torch.core.insitu.transit import (TransitBridge,
                                             require_producer_spans_cluster)
from repro_torch.runtime.fault import FailureDetector

# plan_stats() reports these as deltas since the current generation's
# bring-up — the warm-rescale acceptance reads wisdom_hits > 0 with
# sweep_candidates_timed == 0
_GEN_STAT_KEYS = ("hits", "misses", "sweep_candidates_timed",
                  "wisdom_hits", "wisdom_misses", "wisdom_stale")


def _world() -> int:
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


class ElasticController:
    """Rescale the consumer mesh N→M at run time (module docstring).

    Parameters:

    * ``n_consumers`` — initial consumer-mesh size; the producer mesh
      takes every other rank and is fixed for the controller's lifetime.
    * ``producer_axes`` / ``consumer_axes`` — mesh axis names, as in
      ``make_transit_meshes``.
    * ``lease`` / ``max_misses`` / ``clock`` — forwarded to the
      :class:`FailureDetector` (ignored when ``detector`` is given).
      ``clock`` may be a step counter for cross-process determinism.
    * ``plan_kwargs`` — defaults for :meth:`plan` (``backend=``, ...).
    * ``engine`` — optional :class:`FFTServeEngine` to carry across
      rescales (also settable later via :meth:`attach_engine`).
    * ``flag`` — the entry-point flag named in operator-facing errors.
    * ``device`` — the meshes' device (default ``cuda:{LOCAL_RANK}``).

    Construction is collective on every rank (it builds both meshes and
    the bridge).
    """

    def __init__(self, n_consumers: int, *,
                 producer_axes=("data", "model"),
                 consumer_axes=("data",),
                 lease: float = 1.0, max_misses: int = 3,
                 clock: Optional[Callable[[], float]] = None,
                 detector: Optional[FailureDetector] = None,
                 plan_kwargs: Optional[dict] = None,
                 engine=None, flag: str = "--elastic", device=None):
        from repro_torch.launch.mesh import (make_consumer_mesh,
                                             make_transit_meshes)
        self._make_consumer_mesh = make_consumer_mesh
        world = _world()
        if not 1 <= n_consumers < world:
            raise ValueError(
                f"{flag}: need 1 <= n_consumers < {world} global ranks, "
                f"got {n_consumers}")
        self.flag = flag
        self._m = world - n_consumers
        self._consumer_axes = tuple(consumer_axes)
        self._device = device
        self.plan_kwargs = dict(plan_kwargs or {})
        self.detector = detector or FailureDetector(
            lease=lease, max_misses=max_misses,
            clock=clock or time.monotonic)
        self.producer_mesh, cmesh = make_transit_meshes(
            self._m, n_consumers, producer_axes=tuple(producer_axes),
            consumer_axes=self._consumer_axes, device=device)
        require_producer_spans_cluster(self.producer_mesh, flag,
                                       consumer_mesh=cmesh)
        # pool position r <-> global rank m + r, for the lifetime
        self._pool = list(range(self._m, world))
        self._excluded: set = set()          # dead global ranks
        self._n = int(n_consumers)
        self._bridge = TransitBridge(self.producer_mesh, cmesh)
        self._engine = engine
        self.generation = 0
        self.state = "serving"
        self.events: List[Dict[str, Any]] = []
        for rank in self.active_ranks():
            self.detector.register(rank)
        self._stats0 = plan_cache_stats()

    # -- topology views -------------------------------------------------------
    @property
    def consumer_mesh(self):
        return self._bridge.consumer_mesh

    @property
    def bridge(self) -> TransitBridge:
        """The current generation's bridge (rebuilt on every rescale)."""
        return self._bridge

    def _alive_pool(self) -> List[int]:
        return [g for g in self._pool if g not in self._excluded]

    def active_ranks(self) -> List[int]:
        """Pool positions whose rank sits in the CURRENT consumer mesh
        (the last ``n`` survivors — the ranks expected to heartbeat)."""
        active = set(self.consumer_mesh.members)
        return [r for r, g in enumerate(self._pool) if g in active]

    def consumer_ranks(self) -> Dict[int, Dict[str, Any]]:
        """Operator view of the whole pool: every position's global rank
        (its process: one a rank), liveness, and current-mesh
        membership."""
        dead = set(self.detector.dead_ranks())
        active = set(self.active_ranks())
        return {r: {"rank": g, "process": g, "alive": r not in dead,
                    "active": r in active}
                for r, g in enumerate(self._pool)}

    # -- heartbeats -----------------------------------------------------------
    def heartbeat(self, rank: int, now: Optional[float] = None) -> None:
        self.detector.heartbeat(rank, now)

    def heartbeat_all(self, now: Optional[float] = None, *,
                      drop: Iterable[int] = ()) -> None:
        """Renew every active position's lease except ``drop`` — the
        entry points' convenience (and the chaos harness's
        heartbeat-drop injection point)."""
        dropped = set(drop)
        dead = set(self.detector.dead_ranks())
        for rank in self.active_ranks():
            if rank not in dropped and rank not in dead:
                self.detector.heartbeat(rank, now)

    # -- failure-driven rescale ----------------------------------------------
    def tick(self, now: Optional[float] = None, *,
             straggler_report: Optional[dict] = None) -> Optional[dict]:
        """One monitoring tick: poll leases, fold in an optional
        ``StragglerMonitor.rank_report`` (persistent slow ranks are
        evicted), agree the verdict across the world, and rescale away
        any newly dead positions. Returns the rescale event, or ``None``.

        **Collective** on every rank of the world (the verdict broadcast
        runs unconditionally so collective counts never diverge)."""
        verdict = self.detector.poll(now)
        local_dead = list(verdict["new_dead"])
        if straggler_report is not None:
            local_dead += self.detector.consume_straggler_report(
                straggler_report)
        dead = self._agree_dead(local_dead)
        if not dead:
            return None
        # failure-driven: the old mesh lost a member — never wait on it
        return self.rescale(exclude_ranks=dead, drain=False,
                            reason=f"failure: rank(s) {dead} declared dead")

    def _agree_dead(self, local_dead: List[int]) -> List[int]:
        """The world's death verdict: rank 0's view wins, shipped as a
        fixed-size position bitmask so the collective payload never
        depends on the verdict. One process: the identity."""
        if _world() <= 1:
            return sorted(set(local_dead))
        # the default group carries CPU tensors unless it is NCCL's
        device = (self.producer_mesh.device if dist.get_backend() == "nccl"
                  else torch.device("cpu"))
        mask = torch.zeros(len(self._pool), dtype=torch.int32,
                           device=device)
        for r in local_dead:
            mask[r] = 1
        dist.broadcast(mask, src=0)
        dead = [int(r) for r in torch.nonzero(mask.cpu()).flatten()]
        for r in dead:           # the other ranks adopt the verdict
            self.detector.declare_dead(r, "agreed verdict (rank 0)")
        return dead

    # -- the rescale ----------------------------------------------------------
    def rescale(self, n: Optional[int] = None, *,
                exclude_ranks: Iterable[int] = (),
                rejoin_ranks: Iterable[int] = (),
                drain: bool = True,
                reason: str = "operator") -> Dict[str, Any]:
        """Rebuild the consumer side over the surviving/joined pool.

        ``exclude_ranks`` (pool positions) leave the pool (their leases
        are revoked); ``rejoin_ranks`` return (fresh leases). ``n`` is the
        new mesh size (default: the old size, capped to the survivors).
        ``drain`` picks the engine's old-mesh semantics — complete
        everything (True) or fail-contain pending (False, the failure
        path). Returns (and logs) the rescale event.

        **Collective** on every rank of the world, like :meth:`tick`.
        """
        t0 = time.perf_counter()
        old_n = self._n
        old_mesh = self.consumer_mesh
        self.state = "draining"
        for rank in exclude_ranks:
            self._excluded.add(self._pool[rank])
            self.detector.declare_dead(rank, reason)
        for rank in rejoin_ranks:
            self._excluded.discard(self._pool[rank])
            self.detector.register(rank)
        alive = self._alive_pool()
        if n is None:
            n = min(old_n, len(alive))
        n = int(n)
        if not 1 <= n <= len(alive):
            self.state = "serving"
            raise ValueError(
                f"{self.flag}: cannot rescale to {n} consumers — "
                f"{len(alive)} of {len(self._pool)} pool ranks alive")
        self.state = "rebuilding"
        new_mesh = self._make_consumer_mesh(
            self._m, n, exclude_ids=sorted(self._excluded),
            consumer_axes=self._consumer_axes, device=self._device)
        engine_info = None
        if self._engine is not None:
            engine_info = self._engine.rescale_mesh(new_mesh, drain=drain)
        # retire the old bridge's async hop FIRST: in-flight send_async
        # work still targets the old consumer mesh, and a send issued
        # after the swap must never interleave with it. close_async
        # drains without raising (a failure-path rescale must not die on
        # a contained transit error) and stops the worker.
        self._bridge.close_async()
        # drop plans pinned to BOTH meshes, on every rank: the old one is
        # retired, and the new one must bring up fresh (miss -> wisdom
        # read-through), even when its topology matches an earlier
        # generation's
        evicted = plan_cache_evict(old_mesh) + plan_cache_evict(new_mesh)
        self._bridge = TransitBridge(self.producer_mesh, new_mesh)
        self._n = n
        self.generation += 1
        self.state = "serving"
        self._stats0 = plan_cache_stats()
        event = {
            "event": "rescale", "generation": self.generation,
            "reason": reason, "drain": bool(drain),
            "from_devices": old_n, "to_devices": n,
            "excluded_ids": sorted(self._excluded),
            "consumer_span": mesh_process_span(new_mesh),
            "plans_evicted": evicted, "engine": engine_info,
            "wall_s": round(time.perf_counter() - t0, 6),
        }
        self.events.append(event)
        return event

    # -- serving plumbing ------------------------------------------------------
    def attach_engine(self, engine) -> Any:
        """Adopt a serving engine: from now on every rescale drains or
        fail-contains it and swaps its mesh. The engine should already
        target :attr:`consumer_mesh` (pass ``mesh=ctl.consumer_mesh``
        at construction), and be attached on every rank."""
        self._engine = engine
        return engine

    def plan(self, shape, direction: str = FORWARD, **kwargs):
        """Plan on the CURRENT consumer mesh with the controller's
        ``plan_kwargs`` defaults — consumer code's generation-safe
        planning entry (collective over the consumer mesh's ranks)."""
        merged = dict(self.plan_kwargs)
        merged.update(kwargs)
        return plan_dft(shape, direction, self.consumer_mesh, **merged)

    def plan_stats(self) -> Dict[str, int]:
        """Planner counter deltas since this generation's bring-up — the
        warm-rescale acceptance surface (``wisdom_hits > 0`` and
        ``sweep_candidates_timed == 0`` after a grow with recorded
        wisdom)."""
        now = plan_cache_stats()
        return {k: now.get(k, 0) - self._stats0.get(k, 0)
                for k in _GEN_STAT_KEYS}

    # -- TransitBridge duck-type: sends route to the newest bridge -------------
    def send(self, data):
        return self._bridge.send(data)

    def send_async(self, data, **kw):
        return self._bridge.send_async(data, **kw)

    def drain_async(self, **kw):
        return self._bridge.drain_async(**kw)

    def close_async(self) -> None:
        self._bridge.close_async()

    def is_producer(self) -> bool:
        return self._bridge.is_producer()

    def is_consumer(self) -> bool:
        return self._bridge.is_consumer()

    def reset_stats(self) -> None:
        self._bridge.reset_stats()

    # -- introspection ---------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Controller + detector + current-bridge view, JSON-ready."""
        return {
            "state": self.state,
            "generation": self.generation,
            "producer_devices": self._m,
            "consumer_devices": self._n,
            "pool": {str(r): v for r, v in self.consumer_ranks().items()},
            "plan_stats": self.plan_stats(),
            "detector": self.detector.report(),
            "events": list(self.events),
            "bridge": self._bridge.report(),
        }
