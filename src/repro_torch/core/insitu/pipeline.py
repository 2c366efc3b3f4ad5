"""Pipelined chain execution — bounded host offload + overlap accounting
(counterpart of ``repro/core/insitu/pipeline.py``).

Serial chain modes leave wall-clock on the table in two places: host
endpoints (writer, visualization) block the next device step, and
consecutive fields serialize through one pipeline even though CUDA
launches are asynchronous. ``InSituChain(mode="pipelined")`` closes
both gaps; this module is the host half of that mode:

* The chain launches field N+1's device stages **without waiting** on
  field N: every kernel goes onto the producer's current CUDA stream
  and the host returns at once. Right after a field's device stages the
  chain records a ``torch.cuda.Event`` on that stream
  (:func:`record_ready`); the event rides with the field in
  ``meta[READY_EVENT]``. It takes the place of JAX's in-flight array.
* Each launched field is handed to a :class:`HostPipeline`, a bounded
  background executor. Its worker materializes the field (the
  reference's ``jax.device_get``): it waits on the field's event
  (``Event.synchronize`` releases the GIL, so the producer runs on), then
  copies the field's tensors into pinned host memory on a CUDA stream of
  its own, made to wait on the same event, and runs the chain's host
  tail on the host tensors, in submission order by default. Waiting on
  the field's own event, not on a device-wide synchronize or on the
  default stream, means the worker waits for exactly that field's work
  and never for the next field's, or for work queued behind it. Each
  tensor it reads is marked used on the worker's stream
  (``record_stream``), so the caching allocator cannot hand its memory
  to the producer before the copy ends. The worker enters the field's
  device explicitly (a new thread starts on ``cuda:0``). CPU tensors
  are host data already: the worker takes them as they are, with no
  event and no copy.
* The queue bound is the **backpressure**: when host endpoints fall
  more than ``depth`` fields behind, ``submit`` blocks the producer
  instead of buffering without bound (each queued field keeps its
  device output alive).
* Everything is accounted: per-endpoint host timings, the
  materialization wait (event wait plus copy), backpressure stalls,
  queue-depth stats, and completed/dropped field counts feed
  ``chain.marshaling_report()``'s overlap-efficiency numbers.

Ordering and failure semantics, as in the reference:

* One worker (the default) preserves submission order end to end —
  required by endpoints declaring ``ordered = True`` (the writer's file
  list, any streaming reducer). ``workers > 1`` is allowed only when
  every host endpoint declares ``thread_safe = True`` and
  ``ordered = False``.
* A host-endpoint exception, or a CUDA error raised while the worker
  waits on a field or copies it, is captured as :class:`PipelineError`
  and re-raised to the producer on the next ``submit``/``drain``; fields
  already queued behind the failure are dropped (counted, not silently
  lost) so ``close``/``finalize`` always completes cleanly.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint

_STOP = object()
# meta keys a pipelined field carries: the event recorded right after its
# device stages, and the process group its host tail's collectives use
READY_EVENT = "ready_event"
HOST_GROUP = "host_group"


def _tensors(data: BridgeData):
    for v in data.arrays.values():
        for t in (v if isinstance(v, tuple) else (v,)):
            if torch.is_tensor(t):
                yield t


def _cuda_device(data: BridgeData) -> Optional[torch.device]:
    """The one CUDA device of the payload's tensors (None: host data)."""
    devices = {t.device for t in _tensors(data) if t.is_cuda}
    if len(devices) > 1:
        raise ValueError(f"a field's tensors span {sorted(map(str, devices))};"
                         f" one field lives on one device")
    return devices.pop() if devices else None


def record_ready(data: BridgeData) -> BridgeData:
    """``data`` with a CUDA event, recorded now on its device's current
    stream, in ``meta[READY_EVENT]``: the event completes when the work
    queued so far on that stream (the field's device stages) has. A
    payload with no CUDA tensor comes back as it is."""
    dev = _cuda_device(data)
    if dev is None:
        return data
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return data.replace(meta={**data.meta, READY_EVENT: ev})


class PipelineError(RuntimeError):
    """A host endpoint (or the field's materialization) failed inside the
    pipeline worker.

    Carries the failing step, endpoint name, and original exception
    (``cause``); raised to the producer on the next ``submit`` or
    ``drain`` so asynchronous failures cannot pass silently.
    """

    def __init__(self, step, endpoint: str, cause: BaseException):
        super().__init__(
            f"host endpoint {endpoint!r} failed at step {step}: "
            f"{type(cause).__name__}: {cause}")
        self.step = step
        self.endpoint = endpoint
        self.cause = cause


class HostPipeline:
    """Bounded background executor for a chain's host endpoint tail.

    ``submit(data)`` enqueues one field's device-stage output (blocking
    when ``depth`` fields are already queued — the backpressure); worker
    threads materialize the tensors on the host and run ``host_eps`` on
    them. ``drain()`` blocks until every submitted field completed;
    ``close()`` drains and joins the workers. ``report()`` returns the
    accounting snapshot at any time, including after ``close``.
    """

    def __init__(self, host_eps: Sequence[Endpoint], *, depth: int = 2,
                 workers: int = 1):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        if workers < 1:
            raise ValueError(f"pipeline workers must be >= 1, got {workers}")
        if workers > 1:
            for ep in host_eps:
                if ep.ordered or not ep.thread_safe:
                    raise ValueError(
                        f"endpoint {ep.name!r} declares ordered="
                        f"{ep.ordered}/thread_safe={ep.thread_safe}; "
                        f"workers={workers} needs every host endpoint "
                        f"ordered=False and thread_safe=True")
        self.host_eps = list(host_eps)
        self.depth = depth
        self.workers = workers
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._local = threading.local()       # each worker's copy streams
        self._error: Optional[PipelineError] = None
        self._closed = False
        self._submitted = 0
        self._done = 0
        self._dropped = 0
        self._wait_s = 0.0            # blocked materializing device results
        self._host_s: Dict[str, float] = {}   # per-endpoint busy time
        self._backpressure_s = 0.0    # producer blocked on the full queue
        self._depth_max = 0
        self._depth_sum = 0
        self._last_out: Optional[BridgeData] = None
        self._threads = [threading.Thread(target=self._work,
                                          name=f"insitu-host-{i}",
                                          daemon=True)
                         for i in range(workers)]
        for t in self._threads:
            t.start()

    # -- producer side ---------------------------------------------------------
    def submit(self, data: BridgeData) -> None:
        """Enqueue one field's device output for host processing.

        A field with CUDA tensors and no ready event gets one here, on
        the calling thread's current stream. Blocks while ``depth``
        fields are in flight (backpressure). Raises the stored
        :class:`PipelineError` if a previous field failed, and
        ``RuntimeError`` after ``close``.
        """
        if self._error is not None:
            raise self._error
        if self._closed:
            raise RuntimeError("pipeline is closed; re-initialize the chain")
        if READY_EVENT not in data.meta:
            data = record_ready(data)
        t0 = time.perf_counter()
        self._q.put(data)
        self._backpressure_s += time.perf_counter() - t0
        with self._lock:
            self._submitted += 1
            d = self._q.qsize()
            self._depth_max = max(self._depth_max, d)
            self._depth_sum += d

    def drain(self, *, raise_error: bool = True,
              timeout: Optional[float] = None) -> Optional[BridgeData]:
        """Block until every submitted field's host work completed
        (``TimeoutError`` after ``timeout`` seconds, if given).

        Returns the last completed host-side ``BridgeData`` (or None).
        With ``raise_error`` (default) re-raises a worker failure.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"{self._q.unfinished_tasks} field(s) still in the "
                        f"host pipeline after {timeout}s")
                self._q.all_tasks_done.wait(remaining)
        if raise_error and self._error is not None:
            raise self._error
        return self._last_out

    def close(self, *, drain: bool = True) -> None:
        """Drain (optionally) and join the workers. Never raises for a
        worker failure — ``report()['error']`` keeps the record — so
        ``finalize()`` stays clean after mid-pipeline exceptions."""
        if self._closed:
            return
        if drain:
            self.drain(raise_error=False)
        self._closed = True
        for _ in self._threads:
            self._q.put(_STOP)
        for t in self._threads:
            t.join()

    # -- worker side -----------------------------------------------------------
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
                self._run_one(item)
            finally:
                self._q.task_done()

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        streams = getattr(self._local, "streams", None)
        if streams is None:
            streams = self._local.streams = {}
        if device not in streams:
            streams[device] = torch.cuda.Stream(device)
        return streams[device]

    def _materialize(self, data: BridgeData) -> BridgeData:
        """The field with its CUDA tensors copied into pinned host
        memory, once its device stages are done (the reference's
        ``jax.device_get``); host data as it is."""
        device = _cuda_device(data)
        if device is None:
            return data
        ready = data.meta[READY_EVENT]
        with torch.cuda.device(device):
            ready.synchronize()           # this field's work, nothing else
            stream = self._stream(device)
            stream.wait_event(ready)

            def host(t):
                if not (torch.is_tensor(t) and t.is_cuda):
                    return t
                t.record_stream(stream)
                out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                return out.copy_(t, non_blocking=True)

            with torch.cuda.stream(stream):
                arrays = {k: tuple(host(x) for x in v)
                          if isinstance(v, tuple) else host(v)
                          for k, v in data.arrays.items()}
            stream.synchronize()
        return data.replace(arrays=arrays)

    def _run_one(self, data: BridgeData) -> None:
        ep_name = "<device_get>"
        try:
            t0 = time.perf_counter()
            data = self._materialize(data)
            with self._lock:
                self._wait_s += time.perf_counter() - t0
            for ep in self.host_eps:
                ep_name = ep.name
                t0 = time.perf_counter()
                data = ep.execute(data)
                dt = time.perf_counter() - t0
                with self._lock:
                    self._host_s[ep.name] = self._host_s.get(ep.name, 0.0) + dt
            with self._lock:
                self._done += 1
                self._last_out = data
        except Exception as err:  # noqa: BLE001 — recorded, re-raised at submit
            with self._lock:
                if self._error is None:
                    self._error = PipelineError(_step_of(data), ep_name, err)
                self._dropped += 1

    # -- accounting ------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Accounting snapshot: field counts, waits, queue-depth stats,
        per-endpoint host busy time, and any captured error."""
        with self._lock:
            subs = self._submitted
            rep = {
                "depth": self.depth,
                "workers": self.workers,
                "submitted": subs,
                "completed": self._done,
                "dropped": self._dropped,
                "wait_s": self._wait_s,
                "backpressure_s": self._backpressure_s,
                "host_timings_s": dict(self._host_s),
                "queue_depth_max": self._depth_max,
                "queue_depth_mean": (self._depth_sum / subs) if subs else 0.0,
                "error": str(self._error) if self._error else None,
            }
        return rep

    def reset_stats(self) -> None:
        """Zero the accounting (counts, waits, timings) without touching
        queued work — call after warm-up so reports cover the steady
        state only."""
        with self._lock:
            self._submitted = self._done = self._dropped = 0
            self._wait_s = self._backpressure_s = 0.0
            self._host_s.clear()
            self._depth_max = self._depth_sum = 0


def _step_of(data) -> Any:
    """Best-effort step id for error messages."""
    try:
        return int(data.step)
    except (TypeError, ValueError, AttributeError):
        return "?"


def overlap_stats(*, wall_s: float, dispatch_s: float,
                  device_probe_s: float,
                  pipeline_report: Dict[str, Any]) -> Dict[str, Any]:
    """Derive the overlap-efficiency numbers for ``marshaling_report``.

    In-pipeline measurements alone cannot price the overlap: the
    worker's materialization wait is small exactly *because* the device
    work it waited on ran during earlier fields' host work. The chain
    therefore calibrates ``device_probe_s`` — the synchronous (launch +
    device compute) cost of ONE field, measured by waiting on a single
    early field's ready event — and estimates

        serialized_s = completed × device_probe_s + host_busy_s

    i.e. what the same fields would cost with no overlap at all.
    ``overlap_efficiency = 1 - wall_s / serialized_s`` (clamped to
    [0, 1]) is then the fraction of that serial cost the pipeline hid:
    ~0 for a serial run, 0.5 when the pipeline halved the wall-clock. It
    is an *estimate* — the probe rides one field and assumes per-field
    device cost is stable."""
    host_busy = sum(pipeline_report.get("host_timings_s", {}).values())
    fields = pipeline_report.get("completed", 0)
    serialized = fields * device_probe_s + host_busy
    eff = 0.0
    if serialized > 0.0 and wall_s > 0.0:
        eff = min(1.0, max(0.0, 1.0 - wall_s / serialized))
    return {"wall_s": wall_s, "dispatch_s": dispatch_s,
            "device_probe_s": device_probe_s,
            "host_busy_s": host_busy, "serialized_s": serialized,
            "overlap_efficiency": eff}
