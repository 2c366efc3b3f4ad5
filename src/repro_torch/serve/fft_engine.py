"""FFT serving engine — concurrent admission, continuous shape-batched
execution, SLO accounting (counterpart of ``repro/serve/fft_engine.py``).

The multi-request engine behind ``launch/serve.py``'s in-situ monitor
and the serving load harness. It reuses three idioms of this package:

* **Slot/tick scheduling** (``serve/engine.py``'s ``ContinuousBatcher``):
  requests join a queue, a scheduler *tick* (``step()``) admits them and
  launches work, and completions free capacity at once — here the "slot
  pool" is per-bucket batch capacity, and one tick turns every ready
  bucket into ONE batched plan execute.
* **Batched leading-dim plans** (``core/fft/plan.py``): requests that
  agree on (op, shape, real/complex, direction, keep_frac) — a *bucket*
  — are stacked along a leading batch dim and transformed under one
  cached ``batch_ndim=1`` plan (``plan_dft``/``plan_rfft``). The plan
  cache is thread-safe and single-flight: the first request of a bucket
  plans, every later one — from any thread — hits. On a CUDA mesh every
  c2c and r2c transform there runs the hand-written four-step and
  Stockham kernels (the planner's default backend on CUDA tensors).
* **Bounded host offload** (``core/insitu/pipeline.py``'s
  ``HostPipeline``): a batched execute returns tensors still being
  computed on the device; the completion worker waits on the batch's
  ready event, copies it to pinned host memory on its own stream, and
  resolves the per-request futures, off the scheduler's critical path,
  in submission order.

The request lifecycle::

    submit() ──bounded admission──▶ bucket pending ──tick──▶ ONE
      batched plan execute (padded to the next pow-2 row count, so the
      plan and allocator working set per bucket is O(log max_batch))
      ──HostPipeline──▶ per-row slicing ──▶ FFTFuture.result()

Each batch is assembled on the host (pinned memory when the mesh is on
a CUDA device) and moves to the device as one ``non_blocking`` copy.

Admission is **bounded**: at most ``max_pending`` requests may sit
un-launched; past that ``submit`` blocks (backpressure, accounted) or
raises :class:`AdmissionFull` with ``block=False``. Buckets never mix.
A bucket executes when it reaches ``flush_at`` pending requests or when
its oldest request has lingered ``linger_s`` (the continuous-batching
window); ``flush()`` force-runs every partial bucket — the ONE
trailing-flush helper (``launch/serve.py`` uses it for both the in-loop
monitor submits and the end-of-run partial batch).

Failure containment: a batch whose launch fails is retried request by
request on the same path (the same kernels), so one poisoned payload
fails only its own future. Per-row completion errors likewise land on
the owning future alone. No failure is answered by a plain version.

``report()`` is the SLO surface: p50/p95/p99/mean/max latency,
throughput, queue-depth and backpressure accounting, batched-execute
ratio (executes / requests — the continuous-batching win), per-bucket
breakdowns, and the planner's shared-cache counters.

**Across ranks.** A mesh of more than one rank (an elastic
controller's consumer mesh, say) runs every batched plan collectively,
so every member rank must form the same batches in the same order, and
a linger window read on each rank's own clock cannot promise that. So:

* callers submit the same requests in the same order on every member
  rank (SPMD), and each request takes the next number of a sequence the
  engine restarts at every mesh swap;
* ``step()`` is collective over the mesh's ranks: the mesh's first rank
  decides the tick (which buckets run, with which requests, whether a
  linger or ``force`` fired) and broadcasts that decision on the mesh's
  group (``broadcast_object_list``, as the planner agrees a measured
  winner); the others take the same requests by number, and a rank
  missing one fails them on every rank (an agreed ``all_reduce``) with
  a ``RuntimeError`` instead of hanging the mesh;
* each batch's output blocks are gathered to the global result on the
  stepping thread (``FFTPlan.unplace``) before the completion worker
  copies them to the host, so no collective runs off that thread;
* ``drain()`` (hence ``flush``, ``stop``, ``prewarm`` and
  ``rescale_mesh(drain=True)``) is collective too: one forced step
  launches everything pending, then each rank waits for its own
  completions;
* there is no scheduler thread: ``start()`` raises ``ValueError`` on
  such a mesh, because the thread's collectives would interleave with
  the caller's own on the same process groups. Drive the engine by
  collective ``step()`` calls.

A rank outside the engine's current mesh (a rank that a shrink
excluded, or a producer) neither plans nor executes: a plan-op
``submit`` there raises ``ValueError`` at once, and ``step``/``drain``
there only run its custom buckets. ``rescale_mesh(drain=False)`` fails
the same pending requests with :class:`MeshRescaled` on every member
rank, since every member holds the same pending requests.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.fft import distributed
from repro_torch.core.fft import rfft as rfft_mod
from repro_torch.core.fft.filters import (lowpass_mask, mask_pencil_tf_3d,
                                          mask_pencil_tf_3d_r2c, mask_r2c)
# the planner's agreement helpers: the mesh's first rank's object on every
# rank, and an ok flag every rank of the mesh must share
from repro_torch.core.fft.plan import (BACKWARD, FORWARD, _broadcast,
                                       _sweep_ok, plan_cache_stats,
                                       plan_dft, plan_rfft)
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint
from repro_torch.core.insitu.pipeline import HostPipeline, PipelineError

OPS = ("fft", "bandpass")


class AdmissionFull(RuntimeError):
    """The bounded admission queue is full (and ``block=False``, or the
    blocking wait timed out) — shed load upstream."""


class MeshRescaled(RuntimeError):
    """The engine's mesh was swapped out from under this request
    (``rescale_mesh(..., drain=False)``): it was admitted against a mesh
    that no longer exists and was never launched. Resubmit — the retry
    routes to the new mesh. Failure is per-request (contained), never
    engine-wide."""


class FFTFuture:
    """Per-request completion handle (one per ``submit``)."""

    def __init__(self, rid: int, bucket: tuple):
        self.rid = rid
        self.bucket = bucket
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        self._ev = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the response; raises the request's failure (and
        ``TimeoutError`` if the engine doesn't resolve in time)."""
        if not self._ev.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done after "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done after "
                               f"{timeout}s")
        return self._error

    # engine-side (exactly one of these fires, once)
    def _resolve(self, value) -> None:
        self._result = value
        self.t_done = time.perf_counter()
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self.t_done = time.perf_counter()
        self._ev.set()


@dataclasses.dataclass
class _Request:
    rid: int
    payload: Any
    future: FFTFuture
    t_admit: float
    seq: int = 0            # number since the last mesh swap (SPMD agreement)


@dataclasses.dataclass
class _Bucket:
    """One (op, shape, real/complex, direction, keep_frac) request class.
    ``spec`` is set for plan-op buckets, ``custom_fn`` for registered
    executors; ``state`` lazily caches the bucket's plans and mask."""
    key: tuple
    flush_at: int
    spec: Optional[dict] = None
    custom_fn: Optional[Callable] = None
    pending: List[_Request] = dataclasses.field(default_factory=list)
    state: dict = dataclasses.field(default_factory=dict)
    requests: int = 0
    executes: int = 0
    rows: int = 0
    failed: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)


def _pad_rows(n: int, cap: int) -> int:
    """Next power of two ≥ n, capped at the bucket's flush size — keeps
    the batch sizes a bucket ever runs at O(log cap)."""
    p = 1
    while p < n:
        p <<= 1
    return max(n, min(p, cap))


# planner counters report()/prewarm() surface as deltas: the shared
# plan-cache traffic plus the persistent-wisdom read-through (a
# wisdom-warm engine shows wisdom_hits > 0 with misses near zero)
_PLAN_DELTA_KEYS = ("hits", "misses", "thread_waits",
                    "wisdom_hits", "wisdom_misses", "wisdom_stale")


def _pair(out) -> tuple:
    """A plan's output as a tuple (a real backward plan returns one
    block)."""
    return out if isinstance(out, tuple) else (out,)


def _percentiles(lat_ms: Sequence[float]) -> Dict[str, float]:
    if not lat_ms:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0,
                "max": 0.0, "count": 0}
    a = np.asarray(lat_ms, np.float64)
    return {"p50": round(float(np.percentile(a, 50)), 3),
            "p95": round(float(np.percentile(a, 95)), 3),
            "p99": round(float(np.percentile(a, 99)), 3),
            "mean": round(float(a.mean()), 3),
            "max": round(float(a.max()), 3),
            "count": int(a.size)}


class _CompletionEndpoint(Endpoint):
    """HostPipeline tail that turns one materialized batch into N
    resolved futures. ``execute`` never raises: per-row errors land on
    the owning future (failure containment), so the pipeline stays
    clean for the batches behind."""

    name = "serve_complete"
    host = True
    ordered = True          # responses complete in submission order
    thread_safe = False

    def __init__(self, engine: "FFTServeEngine"):
        super().__init__()
        self._engine = engine

    def execute(self, data: BridgeData) -> BridgeData:
        self._engine._complete_batch(data)
        return data


class FFTServeEngine:
    """Multi-request FFT/bandpass serving engine (module docstring).

    Drive it either threaded — ``with engine: ...`` or
    ``start()``/``stop()`` spawn the scheduler thread — or manually by
    calling ``step()`` from your own loop (tests do both). On a mesh of
    more than one rank only the manual, collective way works (module
    docstring).

    Parameters:

    * ``mesh`` — the mesh the batched plans run on (default: a host mesh
      on the CUDA device, ``launch.mesh.make_host_mesh``, built lazily on
      first plan-op submit; it raises where there is no card).
    * ``max_pending`` — admission bound: max un-launched requests.
    * ``max_batch`` — default bucket flush size = max rows per batched
      execute.
    * ``linger_s`` — continuous-batching window: a partial bucket
      executes once its oldest request has waited this long.
    * ``completion_depth`` — HostPipeline queue bound for in-flight
      batched results awaiting materialization.
    * ``plan_kwargs`` — forwarded to ``plan_dft``/``plan_rfft``
      (``backend=``, ``decomp=``, ...).
    """

    def __init__(self, mesh=None, *, max_pending: int = 128,
                 max_batch: int = 8, linger_s: float = 0.002,
                 completion_depth: int = 2,
                 plan_kwargs: Optional[dict] = None):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._mesh = mesh
        self.max_pending = max_pending
        self.max_batch = max_batch
        self.linger_s = linger_s
        self.plan_kwargs = dict(plan_kwargs or {})
        self._cond = threading.Condition()      # admission + buckets
        self._done_cond = threading.Condition() # resolution accounting
        self._buckets: Dict[tuple, _Bucket] = {}
        self._rids = itertools.count()
        self._seq = 0                           # restarts at a mesh swap
        self._steps = itertools.count()
        self._unlaunched = 0
        self._force = False
        self._stop = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._inflight: Dict[int, List[_Request]] = {}
        self._completion_depth = completion_depth
        self._completion = HostPipeline([_CompletionEndpoint(self)],
                                        depth=completion_depth)
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "rejected": 0, "executes": 0, "batched_rows": 0,
                       "padded_rows": 0, "single_retries": 0,
                       "completion_resets": 0, "backpressure_s": 0.0,
                       "queue_depth_max": 0, "rescales": 0}
        self._resolved = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._plan_stats0 = plan_cache_stats()

    # -- mesh (lazy: custom-bucket-only engines never build one) -----------
    @property
    def mesh(self):
        if self._mesh is None:
            from repro_torch.launch.mesh import make_host_mesh
            self._mesh = make_host_mesh()
        return self._mesh

    # -- bucket registry -----------------------------------------------------
    def register_bucket(self, name: str, execute_batch: Callable, *,
                        flush_at: Optional[int] = None) -> str:
        """Custom-executor bucket: coalesced submissions are handed to
        ``execute_batch(payloads, step)`` — one call per batch — which
        returns a per-request result sequence, or ``None`` to resolve
        every future with ``None`` (fire-and-forget sinks like the
        serve monitor). Payloads are passed through untouched (they may
        be device tensors still being computed)."""
        key = ("custom", name)
        with self._cond:
            if key in self._buckets:
                raise ValueError(f"bucket {name!r} already registered")
            self._buckets[key] = _Bucket(
                key=key, flush_at=int(flush_at or self.max_batch),
                custom_fn=execute_batch)
        return name

    # -- admission -------------------------------------------------------------
    def submit(self, payload, *, op: str = "fft",
               direction: str = FORWARD, real: bool = False,
               keep_frac: float = 0.25, bucket: Optional[str] = None,
               block: bool = True,
               timeout: Optional[float] = None) -> FFTFuture:
        """Admit one request; returns its :class:`FFTFuture`.

        Plan ops (``bucket=None``): ``op="fft"`` transforms the payload
        (complex c2c both directions; ``real=True`` r2c forward —
        result trimmed to the ``rfftn`` half-spectrum); ``op="bandpass"``
        runs the forward transform, a ``keep_frac`` low-pass mask, and
        the backward transform, returning the filtered field.
        ``bucket=<name>`` routes to a registered custom executor
        instead. Invalid requests are rejected synchronously
        (``ValueError``) — they never consume batch capacity — and so is
        a plan op on a rank outside the engine's mesh, which neither
        plans nor executes."""
        if bucket is not None:
            key = ("custom", bucket)
            with self._cond:
                if key not in self._buckets:
                    raise ValueError(f"unknown bucket {bucket!r}; "
                                     f"register_bucket() it first")
        else:
            payload, key = self._validate(payload, op, direction, real,
                                          keep_frac)
            mesh = self.mesh
            if not mesh.is_member:
                raise ValueError(
                    f"this rank is outside the engine's mesh (ranks "
                    f"{list(mesh.members)}): it neither plans nor executes "
                    f"plan ops; submit them on the mesh's ranks")
        fut = FFTFuture(next(self._rids), key)
        req = _Request(rid=fut.rid, payload=payload, future=fut,
                       t_admit=fut.t_submit)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is stopped")
            t0 = time.perf_counter()
            while self._unlaunched >= self.max_pending:
                if not block:
                    self._stats["rejected"] += 1
                    raise AdmissionFull(
                        f"admission queue full ({self.max_pending} "
                        f"un-launched requests)")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self._stats["rejected"] += 1
                    raise AdmissionFull(
                        f"admission queue still full after {timeout}s")
                self._cond.wait(0.05 if remaining is None
                                else min(0.05, remaining))
                if self._closed:
                    raise RuntimeError("engine is stopped")
            self._stats["backpressure_s"] += time.perf_counter() - t0
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = _Bucket(
                    key=key, flush_at=self.max_batch,
                    spec=self._spec_of(key))
            req.seq = self._seq
            self._seq += 1
            b.pending.append(req)
            b.requests += 1
            self._unlaunched += 1
            self._stats["submitted"] += 1
            self._stats["queue_depth_max"] = max(
                self._stats["queue_depth_max"], self._unlaunched)
            if self._t_first is None:
                self._t_first = fut.t_submit
            req.t_admit = time.perf_counter()
            self._cond.notify_all()
        return fut

    def _validate(self, payload, op, direction, real, keep_frac):
        if op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
        if direction not in (FORWARD, BACKWARD):
            raise ValueError(f"bad direction {direction!r}")
        arr = np.asarray(payload)
        if arr.ndim < 2 or arr.size == 0:
            # rank-1 grids decompose as fourstep1d — cyclic input
            # layout, digit-permuted spectrum, no r2c — none of which
            # fit shape-batched serving; route those through a custom
            # bucket instead
            raise ValueError(f"plan ops serve rank >= 2 grids, got "
                             f"shape {arr.shape}")
        if np.iscomplexobj(arr):
            if real:
                raise ValueError("real=True takes a real field, got a "
                                 "complex payload")
            arr = arr.astype(np.complex64)
        else:
            arr = arr.astype(np.float32)
        if op == "fft" and real and direction == BACKWARD:
            raise ValueError("r2c op='fft' serves the forward transform "
                             "only; use op='bandpass' for real "
                             "round-trips")
        if op == "bandpass" and direction == BACKWARD:
            raise ValueError("op='bandpass' is a forward+backward "
                             "round-trip; direction must be forward")
        kind = "r2c" if real else "c2c"
        extra = round(float(keep_frac), 6) if op == "bandpass" else None
        key = (op, tuple(arr.shape), kind, direction, extra)
        return arr, key

    @staticmethod
    def _spec_of(key: tuple) -> dict:
        op, shape, kind, direction, extra = key
        return {"op": op, "shape": tuple(shape), "kind": kind,
                "direction": direction, "keep_frac": extra}

    # -- warm start -------------------------------------------------------------
    def prewarm(self, signatures: Sequence[dict], *, ladder: bool = True,
                timeout: float = 300.0) -> Dict[str, Any]:
        """Plan, and run once, every batch a list of request signatures
        will need BEFORE the first real request arrives, moving plan
        building (and a measured plan's sweep, or its wisdom lookup) and
        the allocator's first growth out of first-request latency.

        ``signatures`` is a list of dicts: ``{"shape": (64, 64)}`` plus
        any ``submit()`` plan-op kwargs (``op``, ``direction``,
        ``real``, ``keep_frac``). Each signature is exercised with
        synthetic zero payloads through the REAL serving path (submit →
        batch → execute → complete), so bucket state, batched plans,
        and masks are all hot. ``ladder=True`` warms every power-of-two
        padded batch size up to ``max_batch``; ``ladder=False`` warms
        size 1 only.

        Call it while the engine is otherwise idle (typically right
        after construction, before ``start()``; a started engine works
        too). The SLO window is reset afterwards — prewarm traffic never
        pollutes ``report()``'s latency/throughput numbers — but the
        plan-cache baseline from construction is kept, so the
        wisdom/miss deltas prewarm generated stay visible in
        ``report()["plan_cache"]``. Returns a summary dict."""
        t0 = time.perf_counter()
        plan0 = plan_cache_stats()
        sizes_all = []
        n = 1
        while n < self.max_batch:
            sizes_all.append(n)
            n <<= 1
        sizes_all.append(self.max_batch)
        sizes = sizes_all if ladder else [1]
        # a rung can never exceed what admission lets us enqueue from
        # this one thread without a consumer
        sizes = sorted({min(s, self.max_pending) for s in sizes})
        futs = []
        for sig in signatures:
            sig = dict(sig)
            shape = tuple(int(s) for s in sig.pop("shape"))
            real = bool(sig.get("real", False))
            zero = (np.zeros(shape, np.float32) if real
                    else np.zeros(shape, np.complex64))
            for size in sizes:
                for _ in range(size):
                    futs.append(self.submit(zero, **sig))
                # flush each rung as ONE batch so exactly the padded
                # sizes the ladder targets run
                self.flush()
                self.drain(timeout=timeout)
        errors = [repr(f.exception()) for f in futs
                  if f.exception() is not None]
        plan1 = plan_cache_stats()
        summary = {
            "signatures": len(list(signatures)),
            "requests": len(futs),
            "errors": errors,
            "batch_sizes": sizes,
            "wall_s": round(time.perf_counter() - t0, 3),
            "plan_cache": {k: plan1.get(k, 0) - plan0.get(k, 0)
                           for k in _PLAN_DELTA_KEYS},
        }
        self._reset_slo_window()
        return summary

    def _reset_slo_window(self) -> None:
        """Zero the SLO accounting (request/latency/throughput state)
        while KEEPING bucket plan state and the construction-time
        plan-cache baseline. Only safe while no requests are in flight
        — ``prewarm`` drains before calling."""
        with self._cond:
            for k in self._stats:
                self._stats[k] = 0.0 if k == "backpressure_s" else 0
            for b in self._buckets.values():
                b.requests = b.executes = b.rows = b.failed = 0
                b.latencies_ms.clear()
            self._t_first = self._t_last = None
        with self._done_cond:
            self._resolved = 0

    # -- scheduling ------------------------------------------------------------
    def _across(self) -> bool:
        """Whether this rank is a member of a mesh of several ranks (its
        ticks are then collective over the mesh)."""
        m = self._mesh
        return m is not None and m.size > 1 and m.is_member

    def step(self, *, force: bool = False) -> int:
        """One scheduler tick: turn every ready bucket into batched
        executes (full buckets always; partial buckets when their
        oldest request out-waited ``linger_s``, or under ``force``).
        Returns the number of batched executes launched. On a mesh of
        several ranks it is collective, and the mesh's first rank
        decides the tick (module docstring)."""
        with self._cond:
            force = force or self._force
            self._force = False
            across = self._across()
            ready = [] if across else self._take_ready(force)
        if across:
            ready = self._agree_ready(force)
        for b, reqs in ready:
            self._execute_batch(b, reqs)
        return len(ready)

    def _take_ready(self, force: bool) -> List[Tuple[_Bucket,
                                                     List[_Request]]]:
        """Pop every batch due now (caller holds ``_cond``)."""
        ready: List[Tuple[_Bucket, List[_Request]]] = []
        now = time.perf_counter()
        for b in self._buckets.values():
            while len(b.pending) >= b.flush_at:
                ready.append((b, b.pending[:b.flush_at]))
                del b.pending[:b.flush_at]
            if b.pending and (force or
                              now - b.pending[0].t_admit >= self.linger_s):
                ready.append((b, b.pending[:]))
                b.pending.clear()
        if ready:
            self._unlaunched -= sum(len(r) for _, r in ready)
            self._cond.notify_all()       # free admission waiters
        return ready

    def _agree_ready(self, force: bool) -> List[Tuple[_Bucket,
                                                      List[_Request]]]:
        """The mesh's first rank's tick on every member rank: it pops its
        due batches and broadcasts them as (bucket key, request numbers);
        the others pop the same requests. All ranks then agree that each
        found its requests, else fail what they took and raise."""
        mesh = self._mesh
        first = dist.get_rank() == mesh.first_rank
        with self._cond:
            ready = self._take_ready(force) if first else []
        decision = _broadcast([(b.key, [r.seq for r in reqs])
                               for b, reqs in ready], mesh)
        found = True
        if not first:
            with self._cond:
                for key, seqs in decision:
                    b = self._buckets.get(key)
                    mine = {r.seq: r for r in b.pending} if b else {}
                    reqs = [mine[q] for q in seqs if q in mine]
                    found = found and len(reqs) == len(seqs)
                    if reqs:
                        b.pending[:] = [r for r in b.pending
                                        if r not in reqs]
                        ready.append((b, reqs))
                self._unlaunched -= sum(len(r) for _, r in ready)
                self._cond.notify_all()
        if not _sweep_ok(found, mesh):
            err = RuntimeError(
                f"the ranks of mesh {list(mesh.members)} hold different "
                f"pending requests: submit the same requests in the same "
                f"order on every rank of the engine's mesh")
            for b, reqs in ready:
                for req in reqs:
                    self._finish(b, req, error=err)
            raise err
        return ready

    def flush(self) -> None:
        """Force-run every partially-filled bucket — the single
        trailing-flush path (in-loop monitor submits and end-of-run
        partial batches both land here)."""
        if self._thread is not None:
            with self._cond:
                self._force = True
                self._cond.notify_all()
        else:
            self.step(force=True)

    def drain(self, timeout: float = 300.0) -> None:
        """Block until every submitted request resolved (flushing
        partial buckets as needed) and the completion pipeline is
        idle; ``TimeoutError`` after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        across = self._across()
        if across:
            # collective: one agreed forced tick launches everything
            # pending on every rank; the rest is this rank's own wait
            self.step(force=True)
        while True:
            if not across:
                self.flush()
                if self._thread is None:
                    self.step(force=True)
            with self._done_cond:
                if self._resolved >= self._stats["submitted"]:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{self._stats['submitted'] - self._resolved} "
                        f"request(s) unresolved after {timeout}s")
                self._done_cond.wait(min(0.05, remaining))
        self._completion.drain(
            raise_error=False, timeout=max(0.0, deadline - time.monotonic()))

    # -- threaded mode ---------------------------------------------------------
    def start(self) -> "FFTServeEngine":
        if self._thread is not None:
            return self
        if self._across():
            raise ValueError(self._no_thread(self._mesh))
        self._stop = False
        self._thread = threading.Thread(target=self._loop,
                                        name="fft-serve-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _no_thread(mesh) -> str:
        return (f"an engine on mesh {dict(mesh.shape)} over ranks "
                f"{list(mesh.members)} runs no scheduler thread: its ticks "
                f"are collective, and a thread's collectives would "
                f"interleave with the caller's own on the same process "
                f"groups; drive it by collective step() calls")

    def _loop(self) -> None:
        while True:
            n = self.step()
            with self._cond:
                if self._stop and self._unlaunched == 0:
                    return
                if n == 0 and not self._force:
                    pending = any(b.pending
                                  for b in self._buckets.values())
                    self._cond.wait(self.linger_s if pending else 0.05)

    def stop(self, *, drain: bool = True) -> None:
        """Drain (optionally), stop the scheduler thread, and close the
        completion pipeline. The engine rejects submits afterwards."""
        if self._closed:
            return
        if drain:
            self.drain()
        with self._cond:
            self._stop = True
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._completion.close()

    # -- elastic rescale --------------------------------------------------------
    def rescale_mesh(self, new_mesh, *, drain: bool = True,
                     timeout: float = 300.0) -> Dict[str, Any]:
        """Swap the engine onto ``new_mesh`` — the serving half of an
        elastic rescale (``runtime/elastic.py`` calls it on every rank).

        ``drain=True`` (graceful): every admitted request completes on
        the old mesh first, then the swap. ``drain=False`` (the old mesh
        is unusable): un-launched pending requests fail at once with
        :class:`MeshRescaled`, each on its own future (contained,
        exactly like a poisoned payload); in-flight batches are failed
        through the completion-reset path. Either way every bucket's
        plan ``state`` is dropped — plans are bound to the old mesh's
        device and groups — so the next request per bucket re-plans on
        ``new_mesh``. Submissions after return route to the new mesh.
        On a mesh of several ranks both the drain and the swap are
        collective over the old mesh's ranks, and every member fails the
        same pending requests; a threaded engine cannot move onto such a
        mesh (``ValueError``). The request numbering restarts on the new
        mesh. Returns ``{"drained", "failed_pending", "buckets_reset"}``."""
        if (self._thread is not None and new_mesh.size > 1
                and new_mesh.is_member):
            raise ValueError(self._no_thread(new_mesh))
        failed = 0
        if drain:
            self.drain(timeout=timeout)
        else:
            with self._cond:
                doomed = [(b, r) for b in self._buckets.values()
                          for r in b.pending]
                for b in self._buckets.values():
                    b.pending.clear()
                self._unlaunched -= len(doomed)
                self._cond.notify_all()       # free admission waiters
            err = MeshRescaled(
                "engine mesh rescaled before this request launched — "
                "resubmit to run on the new mesh")
            for b, req in doomed:
                self._finish(b, req, error=err)
            failed = len(doomed)
            with self._cond:
                stranded = any(not r.future.done()
                               for reqs in self._inflight.values()
                               for r in reqs)
            if stranded:
                self._recover_completion(MeshRescaled(
                    "engine mesh rescaled mid-batch — request failed "
                    "contained; resubmit to run on the new mesh"))
            else:
                self._completion.drain(raise_error=False, timeout=timeout)
        with self._cond:
            reset = sum(1 for b in self._buckets.values() if b.state)
            for b in self._buckets.values():
                b.state.clear()
            self._mesh = new_mesh
            self._seq = 0
            self._stats["rescales"] += 1
        return {"drained": bool(drain), "failed_pending": failed,
                "buckets_reset": reset}

    def __enter__(self) -> "FFTServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # -- batched execution ------------------------------------------------------
    def _execute_batch(self, bucket: _Bucket, reqs: List[_Request]) -> None:
        step_id = next(self._steps)
        with self._cond:
            bucket.executes += 1
            bucket.rows += len(reqs)
            self._stats["executes"] += 1
            self._stats["batched_rows"] += len(reqs)
        try:
            if bucket.custom_fn is not None:
                self._run_custom(bucket, reqs, step_id)
            else:
                self._launch_plan_batch(bucket, reqs, step_id)
        except Exception as err:  # noqa: BLE001 — contained below
            # failure containment: the batch launch failed as a whole —
            # retry each request ALONE so a poisoned payload takes down
            # only its own future, never its batch-mates
            self._retry_singles(bucket, reqs, step_id, err)

    def _run_custom(self, bucket: _Bucket, reqs: List[_Request],
                    step_id: int) -> None:
        results = bucket.custom_fn([r.payload for r in reqs], step_id)
        if results is None:
            results = [None] * len(reqs)
        for req, val in zip(reqs, results):
            self._finish(bucket, req, value=val)

    def _retry_singles(self, bucket: _Bucket, reqs: List[_Request],
                       step_id: int, batch_err: Exception) -> None:
        if len(reqs) == 1:
            self._finish(bucket, reqs[0], error=batch_err)
            return
        with self._cond:
            self._stats["single_retries"] += len(reqs)
        for req in reqs:
            try:
                if bucket.custom_fn is not None:
                    out = bucket.custom_fn([req.payload], step_id)
                    self._finish(bucket, req,
                                 value=None if out is None else out[0])
                else:
                    self._launch_plan_batch(bucket, [req], step_id,
                                            allow_retry=False)
            except Exception as err:  # noqa: BLE001 — this request only
                self._finish(bucket, req, error=err)

    def _launch_plan_batch(self, bucket: _Bucket, reqs: List[_Request],
                           step_id: int, *,
                           allow_retry: bool = True) -> None:
        spec = bucket.spec
        shape = spec["shape"]
        n = len(reqs)
        pad = _pad_rows(n, bucket.flush_at)
        with self._cond:
            self._stats["padded_rows"] += pad - n
        c2c = spec["kind"] == "c2c"
        dtype = np.complex64 if c2c else np.float32
        # the batch is assembled in pinned memory when it is bound for a
        # CUDA device, so it moves there as one non_blocking copy
        batch = torch.zeros((pad,) + shape,
                            dtype=torch.complex64 if c2c else torch.float32,
                            pin_memory=self.mesh.device.type == "cuda")
        good: List[Tuple[int, _Request]] = []
        for i, req in enumerate(reqs):
            try:
                batch[i] = torch.from_numpy(
                    np.asarray(req.payload, dtype).reshape(shape))
                good.append((i, req))
            except Exception as err:  # noqa: BLE001 — this row only
                self._finish(bucket, req, error=err)
        if not good:
            return
        arrays, finish = self._dispatch(bucket, batch)
        data = BridgeData(arrays=arrays, step=step_id,
                          meta={"bucket": bucket, "rows": good,
                                "finish": finish})
        with self._cond:
            self._inflight[step_id] = [r for _, r in good]
        try:
            self._completion.submit(data)
        except PipelineError as err:
            self._recover_completion(err)
            if allow_retry:
                raise  # _execute_batch retries the requests singly

    def _dispatch(self, bucket: _Bucket, batch: torch.Tensor):
        """Launch the bucket's (cached) plans on one padded host batch.
        Returns the output tensors (still being computed on a CUDA
        device) plus a ``finish(arrays, row)`` slicer the completion
        endpoint applies per request to the host copies."""
        spec, state = bucket.spec, bucket.state
        shape, kind = spec["shape"], spec["kind"]
        planner = plan_rfft if kind == "r2c" else plan_dft
        mesh = self.mesh
        if "fwd" not in state:
            direction = spec["direction"]
            state["fwd"] = planner(shape, direction, mesh,
                                   batch_ndim=1, **self.plan_kwargs)
            if spec["op"] == "bandpass":
                # pin the roundtrip to the forward winner: with
                # decomp="measure" the two directions could tune to
                # different decomps, whose spectral layouts don't match
                bk = dict(self.plan_kwargs,
                          decomp=state["fwd"].decomp,
                          axis_names=state["fwd"].axis_names)
                state["bwd"] = planner(shape, BACKWARD, mesh,
                                       batch_ndim=1, **bk)
        fwd = state["fwd"]
        x = batch.to(mesh.device, non_blocking=True)

        if spec["op"] == "fft":
            # unplace: the global result from every rank's block (the
            # block itself on a one-rank mesh)
            re, im = fwd.unplace(*fwd.execute(*fwd.place(x)))
            if kind == "r2c":
                h = rfft_mod.half_bins(shape[-1])
                finish = lambda a, i: (a["re"][i, ..., :h].numpy()
                                       + 1j * a["im"][i, ..., :h].numpy())
            else:
                finish = lambda a, i: (a["re"][i].numpy()
                                       + 1j * a["im"][i].numpy())
            return {"re": re, "im": im}, finish

        # bandpass: forward → low-pass mask (plain PyTorch, as the
        # reference's is plain jnp) → backward, one batch
        re, im = fwd.execute(*fwd.place(x))
        if "mask" not in state:
            # the global mask in the spectral layout, cut to this rank's
            # block of the forward plan's output
            mask = self._bucket_mask(spec, fwd,
                                     hp=state["bwd"].in_shape()[-1])
            state["mask"] = distributed.shard(
                mask, mesh, fwd.schedule().out_spec).to(re.dtype)
        mask = state["mask"]
        out = state["bwd"].unplace(*_pair(state["bwd"].execute(re * mask,
                                                               im * mask)))
        if kind == "r2c":
            return {"field": out}, (lambda a, i: a["field"][i].numpy())
        return ({"re": out[0], "im": out[1]},
                lambda a, i: a["re"][i].numpy() + 1j * a["im"][i].numpy())

    def _bucket_mask(self, spec: dict, fwd, *, hp: int) -> torch.Tensor:
        """Low-pass mask in the fwd plan's *spectral layout*. Every
        rank>=2 decomp keeps natural frequency order except the
        transpose-free pencil, whose axis 0 is digit-permuted; r2c
        layouts carry the padded half extent ``hp`` on the last axis."""
        shape, kind, kf = spec["shape"], spec["kind"], spec["keep_frac"]
        if fwd.decomp == "pencil_tf":
            p0 = self.mesh.shape[fwd.axis_names[0]]
            if kind == "r2c":
                return mask_pencil_tf_3d_r2c(shape, p0, hp=hp,
                                             keep_frac=kf)
            return mask_pencil_tf_3d(shape, p0, keep_frac=kf)
        if kind == "r2c":
            return mask_r2c(shape, hp=hp, keep_frac=kf)
        return lowpass_mask(shape, kf)

    # -- completion (HostPipeline worker side) ----------------------------------
    def _complete_batch(self, data: BridgeData) -> None:
        """Resolve one materialized batch's futures. Never raises:
        per-row errors fail the owning future only."""
        bucket = data.meta["bucket"]
        finish = data.meta["finish"]
        for i, req in data.meta["rows"]:
            try:
                self._finish(bucket, req,
                             value=finish(data.arrays, i))
            except Exception as err:  # noqa: BLE001 — this row only
                self._finish(bucket, req, error=err)
        with self._cond:
            self._inflight.pop(data.step, None)

    def _recover_completion(self, err: PipelineError) -> None:
        """The completion pipeline died materializing a batch (a device
        error surfaced at its event or copy): fail every still-unresolved
        in-flight request with the pipeline error, then rebuild the
        pipeline so later batches complete normally."""
        with self._cond:
            stranded = [r for reqs in self._inflight.values()
                        for r in reqs if not r.future.done()]
            self._inflight.clear()
            self._stats["completion_resets"] += 1
        for req in stranded:
            self._finish(None, req, error=err)
        old, self._completion = self._completion, HostPipeline(
            [_CompletionEndpoint(self)], depth=self._completion_depth)
        old.close(drain=False)

    def _finish(self, bucket: Optional[_Bucket], req: _Request, *,
                value=None, error: Optional[BaseException] = None) -> None:
        if req.future.done():
            return
        if error is not None:
            req.future._fail(error)
        else:
            req.future._resolve(value)
        lat_ms = (req.future.t_done - req.future.t_submit) * 1e3
        with self._done_cond:
            self._resolved += 1
            self._t_last = req.future.t_done
            self._done_cond.notify_all()
        with self._cond:
            self._stats["failed" if error is not None
                        else "completed"] += 1
            if bucket is not None:
                if error is not None:
                    bucket.failed += 1
                bucket.latencies_ms.append(lat_ms)

    # -- SLO reporting -----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Raw counters snapshot (cheap; ``report()`` derives the SLO
        view)."""
        with self._cond:
            s = dict(self._stats)
            s["unlaunched"] = self._unlaunched
            s["buckets"] = len(self._buckets)
        return s

    def report(self) -> Dict[str, Any]:
        """The SLO report: latency percentiles over the full
        submit→resolve span, throughput over the first-submit→last-resolve
        wall, continuous-batching efficiency (``batched_execute_ratio`` =
        executes / requests — 1.0 means no coalescing at all), queue
        accounting, per-bucket breakdowns, and the planner's
        shared-cache counter deltas since engine construction."""
        with self._cond:
            stats = dict(self._stats)
            buckets = {
                "|".join(map(str, b.key)): {
                    "requests": b.requests, "executes": b.executes,
                    "rows": b.rows, "failed": b.failed,
                    "latency_ms": _percentiles(b.latencies_ms)}
                for b in self._buckets.values()}
            lat = [ms for b in self._buckets.values()
                   for ms in b.latencies_ms]
            t_first, t_last = self._t_first, self._t_last
        resolved = stats["completed"] + stats["failed"]
        wall = ((t_last - t_first)
                if (t_first is not None and t_last is not None) else 0.0)
        rows = stats["batched_rows"]
        execs = stats["executes"]
        plan_now = plan_cache_stats()
        plan_delta = {k: plan_now.get(k, 0) - self._plan_stats0.get(k, 0)
                      for k in _PLAN_DELTA_KEYS}
        return {
            "requests": {"submitted": stats["submitted"],
                         "completed": stats["completed"],
                         "failed": stats["failed"],
                         "rejected": stats["rejected"]},
            "latency_ms": _percentiles(lat),
            "throughput_rps": round(resolved / wall, 2) if wall > 0
            else 0.0,
            "batching": {
                "executes": execs,
                "rows": rows,
                "padded_rows": stats["padded_rows"],
                "mean_batch": round(rows / execs, 3) if execs else 0.0,
                "batched_execute_ratio": round(execs / rows, 4)
                if rows else 0.0,
                "single_retries": stats["single_retries"]},
            "queue": {"max_pending": self.max_pending,
                      "depth_max": stats["queue_depth_max"],
                      "backpressure_s": round(stats["backpressure_s"], 6),
                      "completion": self._completion.report(),
                      "completion_resets": stats["completion_resets"]},
            "rescales": stats["rescales"],
            "plan_cache": plan_delta,
            "buckets": buckets,
        }
