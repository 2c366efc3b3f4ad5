"""M→N in-transit bridge — distinct producer and consumer meshes
(counterpart of ``repro/core/insitu/transit.py``).

The paper's in-transit deployment separates the M processes producing
data from the N processes analysing it. A ``TransitBridge`` takes each
field of a ``BridgeData`` placed over a **producer** mesh (each producer
rank holds its block, under ``data.spec``) and delivers it placed over a
disjoint **consumer** mesh, where the FFT chain (or any consumer-side
computation) runs without touching producer ranks.
``launch/mesh.make_transit_meshes`` builds the two meshes.

**Transports.** ``via`` takes the reference's values. ``"host"`` is the
port's transport, and ``"auto"`` resolves to it always: disjoint meshes
span two ranks or more, and a process here is one rank driving one
device, so no process addresses both meshes. ``"device_put"`` (the
reference's one-process resharding, valid only where one process
addresses every device of both meshes) can therefore never apply, and
asking for it raises ``ValueError``.

**The host transport** (reference ``transit.py:311-392``):

* Every rank of the world joins each gather, on the bridge's own gloo
  process group over every rank, built when the bridge is (collectively
  on every rank). A bridge group of its own keeps ``send_async``'s
  worker from pairing its gathers with the producer's own exchanges,
  which run on the meshes' groups (the hazard ``chain.py`` describes).
* One ``all_gather_object`` per ``send`` exchanges a header from every
  rank: the send's sequence number, each leaf's name, global shape and
  dtype, and on producer ranks the bounds of the block they own (and the
  first producer's step, grid, domain and layout, which every rank
  delivers). Every rank checks that all headers agree and raises the
  same ``ValueError`` on every rank where they do not (a rank that sends
  another field, or is a send ahead). A rank that never calls ``send``
  leaves the others in the gather until the group's timeout
  (``timeout_s``), which then raises: a mismatch cannot hang silently.
* Producer ranks contribute their block as flat bytes, padded to the
  largest block, and every rank ``all_gather``s them as **uint8** (bit
  exact, whatever dtype list a backend takes).
* Consumers rebuild the global field, the lowest-ranked contributor
  winning element-wise where blocks overlap (ranks along an axis the
  producer's spec does not name hold copies); every rank checks coverage
  with a bool mask and raises ``ValueError`` on a gap.
* Consumers take their block under the consumer spec onto their device
  (default: the leading axis split over the consumer mesh's first axis
  where it divides, else the whole array); non-consumers get ``None``
  leaves. The payload's ``spec`` is the primary array's consumer spec
  (None on a one-rank consumer mesh).

The producer's ``data.spec`` places every array leaf of at least as many
dims as the spec has entries (the ``distributed.shard`` rule); smaller
leaves (scalars, summary vectors) count as whole on every producer rank.

The call contract is every collective's: ALL ranks call ``send`` per
field, producer ranks passing their blocks, every other rank passing
placeholders of the global shape and dtype (a ``device="meta"`` tensor
or a numpy array: only ``shape`` and ``dtype`` are read). A producer rank
that passes a placeholder contributes nothing, as in the reference, and
the coverage check then names the gap. ``report()`` accounts
fields, logical bytes moved (one copy of every delivered array's
global bytes), wall seconds, and both meshes' spans.

``send`` blocks for the whole hop; ``send_async`` does not: a field with
CUDA tensors gets a CUDA event (``pipeline.record_ready``) and goes on a
bounded single-worker queue; the worker waits on that event, copies the
blocks into pinned memory on a stream of its own and runs the hop, in
submission order, with backpressure at ``depth``, and a failure comes
back as ``PipelineError(step, "transit", ...)`` on the next
``send_async``/``drain_async`` (``report()["async"]``).

``require_producer_spans_cluster`` keeps the reference guard's purpose
(no rank may enter a collective it is not part of) for one process a
rank: see its docstring.
"""
from __future__ import annotations

import datetime
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import Mesh
from repro_torch.core.fft import distributed
from repro_torch.core.insitu.bridge import BridgeData, GridMeta
from repro_torch.core.insitu.pipeline import (HOST_GROUP, READY_EVENT,
                                              PipelineError, materialize,
                                              record_ready)

VIAS = ("auto", "device_put", "host")
# how long a rank waits in a send for the others
TIMEOUT_S = 600.0

_STOP = object()


class _AsyncHop:
    """The async transit executor: one bounded queue, ONE ordered
    worker running the bridge's (collective) hop off the producer's
    critical path — the ``HostPipeline`` discipline applied to transit.

    ``submit`` takes the field by reference, with a CUDA event recorded
    on the producer's stream; the worker waits on that event alone, so
    the producer's next steps keep running. One worker a rank and
    submission order mean every rank runs the Nth send's gathers as its
    Nth hop.

    Failure containment mirrors ``HostPipeline``: a hop failure is
    captured as :class:`PipelineError`, re-raised to the producer on the
    next ``submit``/``drain``; queued fields behind it are dropped and
    counted, and the producer never deadlocks on a dead consumer."""

    def __init__(self, bridge: "TransitBridge", depth: int,
                 on_result: Optional[Callable[[BridgeData], Any]]):
        if depth < 1:
            raise ValueError(f"transit async depth must be >= 1, "
                             f"got {depth}")
        self.bridge = bridge
        self.depth = depth
        self.on_result = on_result
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._error: Optional[PipelineError] = None
        self._closed = False
        self._submitted = 0
        self._completed = 0
        self._dropped = 0
        self._backpressure_s = 0.0    # producer blocked on the full queue
        self._drain_wait_s = 0.0      # producer blocked in drain()
        self._hop_busy_s = 0.0        # worker inside the collective hop
        self._results: List[BridgeData] = []
        self._thread = threading.Thread(target=self._work,
                                        name="transit-async", daemon=True)
        self._thread.start()

    def submit(self, data: BridgeData) -> None:
        if self._error is not None:
            raise self._error
        if self._closed:
            raise RuntimeError("async transit hop is closed")
        if READY_EVENT not in data.meta:
            data = record_ready(data)
        t0 = time.perf_counter()
        self._q.put(data)
        with self._lock:
            self._backpressure_s += time.perf_counter() - t0
            self._submitted += 1

    def drain(self, *, raise_error: bool = True) -> List[BridgeData]:
        t0 = time.perf_counter()
        self._q.join()
        with self._lock:
            self._drain_wait_s += time.perf_counter() - t0
            out, self._results = self._results, []
        if raise_error and self._error is not None:
            raise self._error
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        self._thread.join()

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def _work(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                if self._error is not None:
                    with self._lock:
                        self._dropped += 1
                    continue
                t0 = time.perf_counter()
                step = _step_of(item)
                try:
                    out = self.bridge.send(materialize(item, self._stream))
                    step = out.step       # the producer's, on every rank
                    if self.on_result is not None:
                        self.on_result(out)
                except Exception as err:  # noqa: BLE001 — re-raised at submit
                    with self._lock:
                        if self._error is None:
                            self._error = PipelineError(step, "transit",
                                                        err)
                        self._dropped += 1
                        self._hop_busy_s += time.perf_counter() - t0
                    continue
                with self._lock:
                    self._hop_busy_s += time.perf_counter() - t0
                    self._completed += 1
                    if self.on_result is None:
                        # delivery-by-drain mode: kept for the caller
                        self._results.append(out)
            finally:
                self._q.task_done()

    def report(self) -> Dict[str, Any]:
        """Async accounting incl. ``overlap_efficiency``: the fraction
        of the hop's busy time hidden from the producer —
        ``1 - producer_blocked_s / hop_busy_s`` (clamped to [0, 1]),
        where the producer only blocks on backpressure and drain. A
        blocking ``send`` loop scores ~0; a fully overlapped run
        approaches 1."""
        with self._lock:
            blocked = self._backpressure_s + self._drain_wait_s
            busy = self._hop_busy_s
            eff = 0.0
            if busy > 0.0:
                eff = min(1.0, max(0.0, 1.0 - blocked / busy))
            return {
                "depth": self.depth,
                "submitted": self._submitted,
                "completed": self._completed,
                "dropped": self._dropped,
                "backpressure_s": self._backpressure_s,
                "drain_wait_s": self._drain_wait_s,
                "hop_busy_s": busy,
                "producer_blocked_s": blocked,
                "overlap_efficiency": eff,
                "error": str(self._error) if self._error else None,
            }


def _step_of(data) -> Any:
    try:
        return int(data.step)
    except (TypeError, ValueError, AttributeError):
        return "?"


def _world() -> int:
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def require_producer_spans_cluster(producer_mesh: Mesh,
                                   flag: str = "--transit-consumers", *,
                                   consumer_mesh: Optional[Mesh] = None
                                   ) -> None:
    """Guard for entry points whose main loop runs on the producer mesh.

    The reference refuses a producer mesh that leaves out a process:
    that process would hang at the jitted loop's first collective. Here
    a process is one rank, so the letter of that check would refuse
    every M→N split. Its purpose is kept: no rank may enter a collective
    it is not part of. Every rank outside ``consumer_mesh`` runs the
    main loop, so each must be a rank of the producer mesh; a rank
    in neither (say, one that ``exclude_ids`` left out) would enter the
    producer's collectives without a place in them. Without
    ``consumer_mesh`` the producer mesh must span every rank. Raises
    ``ValueError`` naming ``flag``; a one-process run always passes."""
    world = _world()
    if world <= 1:
        return
    spanned = set(producer_mesh.members)
    excused = set(consumer_mesh.members) if consumer_mesh is not None \
        else set()
    idle = sorted(set(range(world)) - spanned - excused)
    if idle:
        raise ValueError(
            f"{flag}: ranks {idle} of a {world}-rank cluster are in "
            f"neither the producer mesh (ranks {sorted(spanned)}) nor the "
            f"consumer mesh (ranks {sorted(excused)}) — they would enter "
            f"the main loop's collectives on a mesh they are not part of. "
            f"Pick a split that gives every rank a role.")


def _leaves(v):
    return v if isinstance(v, tuple) else (v,)


def _dtype(name: str) -> torch.dtype:
    """The torch dtype a header names (``str(torch.float32)``)."""
    return getattr(torch, name.split(".")[-1])


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


class TransitBridge:
    """Move fields from a producer mesh onto a disjoint consumer mesh.

    ``spec_map`` overrides the consumer-side spec (a tuple over the
    array's dims, as ``BridgeData.spec``) per array name;
    ``default_spec`` covers the rest (default: split the leading axis
    over the consumer mesh's first axis where it divides, else the whole
    array on every consumer rank — small monitor products stay whole,
    big fields split). The meshes must share no rank: sharing would make
    "in transit" a no-op and the accounting a lie. Construction is
    collective on every rank of the world (the bridge's process group).
    """

    def __init__(self, producer_mesh: Mesh, consumer_mesh: Mesh, *,
                 spec_map: Optional[Dict[str, tuple]] = None,
                 default_spec: Optional[tuple] = None, via: str = "auto",
                 timeout_s: float = TIMEOUT_S):
        if via not in VIAS:
            raise ValueError(f"via must be one of {VIAS}, got {via!r}")
        overlap = set(producer_mesh.members) & set(consumer_mesh.members)
        if overlap:
            raise ValueError(
                f"producer and consumer meshes share ranks {sorted(overlap)}"
                f" — transit requires disjoint meshes")
        if via == "device_put":
            raise ValueError(
                "via='device_put' needs one process addressing every device "
                "of both meshes; in the port a process is one rank on one "
                "device, and disjoint meshes span two ranks or more: use "
                "via='host' (or 'auto')")
        self.producer_mesh = producer_mesh
        self.consumer_mesh = consumer_mesh
        self.spec_map = dict(spec_map or {})
        self.default_spec = default_spec
        self.via = "host"
        self.timeout_s = timeout_s
        self._world = _world()
        self._group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
        self._sends = 0
        self._fields = 0
        self._bytes = 0
        self._wall_s = 0.0
        self._per_array: Dict[str, int] = {}
        self._async: Optional[_AsyncHop] = None

    # -- participation ------------------------------------------------------
    def is_producer(self) -> bool:
        """True when this rank holds a position of the producer mesh."""
        return self.producer_mesh.is_member

    def is_consumer(self) -> bool:
        """True when this rank holds a position of the consumer mesh —
        i.e. whether ``send``'s outputs are usable here."""
        return self.consumer_mesh.is_member

    # -- spec resolution ----------------------------------------------------
    def _consumer_spec(self, name: str, shape) -> Optional[tuple]:
        spec = self.spec_map.get(name, self.default_spec)
        if spec is None and shape:
            ax0 = self.consumer_mesh.axis_names[0]
            if shape[0] % self.consumer_mesh.shape[ax0] == 0:
                spec = (ax0,) + (None,) * (len(shape) - 1)
        return spec

    # -- the host transport -------------------------------------------------
    def _describe(self, x, spec) -> tuple:
        """(global shape, dtype name, owned bounds or None, host block or
        None) of one leaf on this rank."""
        if not (self.is_producer() and torch.is_tensor(x)
                and x.device.type != "meta"):
            return tuple(x.shape), str(_torch_dtype(x.dtype)), None, None
        mesh = self.producer_mesh
        shape = list(x.shape)
        if spec is not None and x.dim() >= len(spec):
            lead = x.dim() - len(spec)
            for i, entry in enumerate(spec):
                shape[lead + i] *= distributed.shard_count(mesh, entry)
            cut = distributed._slices(mesh, spec, tuple(shape),
                                      mesh.coordinate)
        else:
            cut = tuple(slice(None) for _ in shape)
        bounds = tuple((sl.start or 0, n if sl.stop is None else sl.stop)
                       for sl, n in zip(cut, shape))
        block = x.detach().contiguous().cpu()
        return tuple(shape), str(x.dtype), bounds, block

    def _header(self, data: BridgeData, leaves) -> tuple:
        tags = None
        if self.is_producer() and \
                dist.get_rank() == self.producer_mesh.first_rank:
            g = data.grid
            tags = (data.step, data.time, data.domain, data.layout,
                    data.meta.get("primary"),
                    None if g is None else (g.dims, g.spacing, g.origin))
        return (self._sends, tags,
                [(name, i, shape, dtype, bounds,
                  0 if block is None else block.numel()
                  * block.element_size())
                 for name, i, (shape, dtype, bounds, block) in leaves])

    def _exchange_headers(self, header) -> list:
        heads = [None] * self._world
        try:
            dist.all_gather_object(heads, header, group=self._group)
        except RuntimeError as err:
            raise RuntimeError(
                f"transit send {header[0]}: the ranks did not all reach "
                f"it within {self.timeout_s}s — every rank must call send "
                f"(or send_async) for the same fields in the same order "
                f"({type(err).__name__}: {err})") from err
        want = [(h[0], [leaf[:4] for leaf in h[2]]) for h in heads]
        if any(w != want[0] for w in want):
            raise ValueError(
                "transit send: the ranks disagree on the field (send "
                "number, then (array, leaf, global shape, dtype) per "
                "leaf): " + "; ".join(f"rank {r}: {w}"
                                      for r, w in enumerate(want)))
        return heads

    def _move(self, k: int, name: str, heads: list, block):
        """Leaf ``k`` of the gathered headers: gather every rank's owned
        bytes, check coverage, and rebuild this consumer's block."""
        shape, dtype = heads[0][2][k][2], _dtype(heads[0][2][k][3])
        sizes = [h[2][k][5] for h in heads]
        buf = torch.zeros(max(sizes), dtype=torch.uint8)
        if block is not None:
            buf[:sizes[dist.get_rank()]] = block.reshape(-1).view(torch.uint8)
        bufs = [torch.empty_like(buf) for _ in heads]
        dist.all_gather(bufs, buf, group=self._group)
        consumer = self.is_consumer()
        full = torch.zeros(shape, dtype=dtype) if consumer else None
        filled = torch.zeros(shape, dtype=torch.bool)
        for h, got in zip(heads, bufs):         # lowest rank first
            bounds = h[2][k][4]
            if bounds is None:
                continue
            idx = tuple(slice(lo, hi) for lo, hi in bounds)
            if consumer:
                part = got[:h[2][k][5]].view(dtype).reshape(
                    [hi - lo for lo, hi in bounds])
                seen = filled[idx]
                if not seen.any():
                    full[idx] = part
                elif not seen.all():            # the lower rank wins
                    full[idx] = torch.where(seen, full[idx], part)
            filled[idx] = True
        if not filled.all():
            raise ValueError(
                f"transit array {name!r}: no rank contributed "
                f"{int((~filled).sum())} of {filled.numel()} elements — was "
                f"send() called with its block on every producer rank?")
        if not consumer:
            return None
        mesh = self.consumer_mesh
        spec = self._consumer_spec(name, shape)
        if mesh.size > 1 and spec is not None:
            full = full[distributed._slices(mesh, spec, tuple(shape),
                                            mesh.coordinate)]
        return full.to(mesh.device, copy=True).contiguous()

    # -- the hop ------------------------------------------------------------
    def send(self, data: BridgeData) -> BridgeData:
        """Deliver one field's arrays onto the consumer mesh (collective
        on every rank; see the module docstring for what each rank
        passes).

        Returns a ``BridgeData`` with the same keys and structure whose
        leaves live on this consumer rank's device (``None`` leaves on
        other ranks). The first producer rank's step, time, grid, domain,
        layout and primary array pass through untouched — transit moves
        bytes, it does not reinterpret them."""
        t0 = time.perf_counter()
        leaves = [(name, i, self._describe(x, data.spec))
                  for name, v in data.arrays.items()
                  for i, x in enumerate(_leaves(v))]
        heads = self._exchange_headers(self._header(data, leaves))
        self._sends += 1
        moved: Dict[str, list] = {}
        shapes: Dict[str, tuple] = {}
        for k, (name, _, (shape, dtype, _, block)) in enumerate(leaves):
            moved.setdefault(name, []).append(
                self._move(k, name, heads, block))
            shapes[name] = shape
            n = math.prod(shape) * _dtype(dtype).itemsize
            self._per_array[name] = self._per_array.get(name, 0) + n
            self._bytes += n
        out = {name: tuple(vals) if isinstance(data.arrays[name], tuple)
               else vals[0] for name, vals in moved.items()}
        self._fields += 1
        self._wall_s += time.perf_counter() - t0
        tags = next(h[1] for h in heads if h[1] is not None)
        step, when, domain, layout, primary, grid = tags
        meta = {k: v for k, v in data.meta.items()
                if k not in (READY_EVENT, HOST_GROUP)}
        if primary is not None:
            meta["primary"] = primary
        meta["transit_via"] = self.via
        spec = None
        if self.consumer_mesh.size > 1:
            pname = meta.get("primary", next(iter(data.arrays)))
            spec = self._consumer_spec(pname, shapes[pname])
        return data.replace(
            arrays=out, step=step, time=when, domain=domain, layout=layout,
            grid=None if grid is None else GridMeta(*grid), meta=meta,
            spec=spec)

    # -- async hop ----------------------------------------------------------
    def send_async(self, data: BridgeData, *,
                   on_result: Optional[Callable[[BridgeData], Any]] = None,
                   depth: int = 2) -> None:
        """Enqueue one field for the bounded background hop and return —
        the producer's next step overlaps the gather and rebuild.

        Delivery is in submission order. ``on_result`` (fixed at the
        first call, like ``depth``) runs on the worker with each
        delivered ``BridgeData`` — the consumer-side chain hook; without
        it, delivered fields are kept and returned by ``drain_async``.
        Blocks only when ``depth`` fields are already in flight
        (backpressure). Raises the contained :class:`PipelineError` of an
        earlier failed hop. The call contract is ``send``'s, one level
        up: every rank calls ``send_async`` for the same fields in the
        same order."""
        if self._async is None:
            self._async = _AsyncHop(self, depth, on_result)
        self._async.submit(data)

    def drain_async(self, *, raise_error: bool = True) -> List[BridgeData]:
        """Block until every async send completed; return the delivered
        fields kept since the last drain (empty when ``on_result``
        consumes them). Re-raises a contained hop failure unless
        ``raise_error=False``. No-op without pending async sends."""
        if self._async is None:
            return []
        return self._async.drain(raise_error=raise_error)

    def close_async(self) -> None:
        """Drain (never raising) and stop the async worker, so no
        orphaned worker runs a stale bridge's collectives."""
        if self._async is not None:
            self._async.drain(raise_error=False)
            self._async.close()

    # -- accounting ---------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the accounting (fields/bytes/wall) without touching
        configuration — call after warm-up so ``report()`` covers the
        steady state, as ``InSituChain.reset_stats()`` does."""
        self._fields = 0
        self._bytes = 0
        self._wall_s = 0.0
        self._per_array.clear()

    def report(self) -> Dict[str, Any]:
        """Transit accounting: fields/bytes/seconds moved, transport,
        and both meshes' spans (global ranks)."""
        def span(mesh):
            return {"shape": dict(mesh.shape),
                    "processes": sorted(mesh.members)}
        rep = {
            "via": self.via,
            "fields": self._fields,
            "bytes_moved": self._bytes,
            "bytes_per_array": dict(self._per_array),
            "wall_s": self._wall_s,
            "producer": span(self.producer_mesh),
            "consumer": span(self.consumer_mesh),
        }
        if self._async is not None:
            rep["async"] = self._async.report()
        return rep
