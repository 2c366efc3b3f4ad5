"""In-situ chain composition — the paper's multi-stage daisy-chain
(counterpart of ``repro/core/insitu/chain.py``).

Three execution modes of the reference. Across the ranks of a mesh every
rank runs the same chain on its block of the field; the exchanges
happen inside the planned FFT endpoints, the bandpass energies are
all-reduced, and the writer gathers to the mesh's first rank.

* **in-situ** — the device endpoints run back to back on the device
  tensors (the handoff between stages is the tensor itself), then the
  chain waits for the device once and runs the host endpoints (writer,
  visualization) on the results.
* **in-transit (staged)** — the chain waits for the device after every
  device stage and keeps a timing per stage. Every stage keeps the
  layout the previous one left (no endpoint names another sharding, as
  in the reference, so no stage calls ``distributed.reshard``; the M→N
  hop between programs' meshes is ``transit.TransitBridge``), so
  ``reshard_bytes`` stays 0.
* **pipelined** — the device stages of a field are launched onto the
  producer's CUDA stream and never waited on: field N+1's kernels queue
  behind field N's while field N's results are still in flight, and the
  host tail (writer, visualization, reductions) runs on a bounded
  background executor (``pipeline.HostPipeline``) with backpressure and
  ordered finalize/flush semantics. ``execute`` returns the device-stage
  output at once, stamped with the CUDA event that completes with its
  device work (``meta[pipeline.READY_EVENT]``); ``drain()`` (or
  ``finalize()``) waits for the host side. ``donate_buffers`` is
  accepted for the reference's configs and changes nothing: PyTorch has
  no buffer donation, and the caching allocator already reuses a
  field's memory once nothing holds it. The serial modes remain the
  correctness oracle.

Across ranks the pipelined host tail needs collectives of its own (the
writer gathers each field to one rank) while the producer thread runs the
next field's exchanges. Two threads issuing collectives on the same
process groups would interleave them in an order that can differ from
rank to rank, and the ranks would pair one field's gather with
another's exchange. So the pipeline gathers on a process group of its
own: the mesh's ``host_group``, a gloo group over the mesh's ranks that
``make_mesh`` builds collectively on every rank of the world (a group
made later, by the mesh's ranks alone, would leave out the ranks a
transit consumer mesh excludes, which ``dist.new_group`` needs too).
``initialize`` claims it (one pipelined chain a mesh at a time:
``finalize`` releases it), and each submitted field names it in
``meta[pipeline.HOST_GROUP]``; host endpoints gather on it. The worker's
collectives then keep the one order the single ordered worker gives
them, apart from the producer's. The group is gloo, because the worker
gathers host tensors. The other design, gathering on the producer
thread before ``submit``, would make the producer wait for every
field's device work at each gather, which is what this mode is there to
avoid.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint
from repro_torch.core.insitu.pipeline import (HOST_GROUP, READY_EVENT,
                                              HostPipeline, overlap_stats,
                                              record_ready)

MODES = ("insitu", "intransit", "pipelined")


def _wait_for_device(data: BridgeData) -> None:
    """Block until the device has finished the work behind ``data``."""
    def tensors(v):
        return v if isinstance(v, tuple) else (v,)
    if any(torch.is_tensor(t) and t.is_cuda
           for v in data.arrays.values() for t in tensors(v)):
        torch.cuda.synchronize()


class InSituChain:
    """An ordered list of endpoints run as one processing chain.

    ``mode`` picks the execution strategy (see the module docstring);
    ``pipeline_depth``/``pipeline_workers``/``donate_buffers`` only
    apply to ``mode="pipelined"``.
    """

    def __init__(self, endpoints: List[Endpoint], mesh=None, *,
                 mode: str = "insitu", pipeline_depth: int = 2,
                 pipeline_workers: int = 1, donate_buffers: bool = False):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.endpoints = endpoints
        self.mesh = mesh
        self.mode = mode
        self.pipeline_depth = pipeline_depth
        self.pipeline_workers = pipeline_workers
        self.donate_buffers = donate_buffers   # no-op: see module docstring
        self._timings: Dict[str, float] = {}
        self._pipeline: Optional[HostPipeline] = None
        self._host_group = None                 # pipelined, across ranks
        self._pipe_t0: Optional[float] = None   # pipelined wall-clock origin
        self._pipe_wall = 0.0
        self._pipe_report: Optional[Dict[str, Any]] = None  # kept post-close
        self._dispatch_s = 0.0
        self._pipe_calls = 0
        self._device_probe_s: Optional[float] = None  # calibration, see below
        self._probe_prev = None     # field 0's ready event, until the probe
        self._pipe_finalized = False

    # -- lifecycle -------------------------------------------------------------
    def initialize(self, grid=None):
        """(Re-)initialize every endpoint; drains the pipeline and drops
        ALL pipelined state first (fields may still be in flight against
        the old endpoint state). A pipelined chain over a mesh of more
        than one rank claims the mesh's host group here."""
        self._shutdown_pipeline()
        self._timings.clear()
        self._dispatch_s = 0.0
        self._pipe_t0 = None
        self._pipe_wall = 0.0
        self._pipe_report = None
        self._pipe_calls = 0
        self._device_probe_s = None
        self._probe_prev = None
        self._pipe_finalized = False
        if (self.mode == "pipelined" and self.mesh is not None
                and self.mesh.host_group is not None):
            self.mesh.claim_host_group(self)
            self._host_group = self.mesh.host_group
        for ep in self.endpoints:
            ep.initialize(self.mesh, grid)
        return self

    def finalize(self) -> Dict[str, Any]:
        """Drain any pipelined work, then finalize every endpoint.

        Returns ``{endpoint_name: finalize_summary}``; repeated endpoint
        names get ``name#idx`` keys for the later occurrences. Never
        raises for a pipeline worker failure — that surfaced on
        ``execute``/``drain`` and stays visible in
        ``marshaling_report()``."""
        self._shutdown_pipeline()
        self._pipe_finalized = True
        if self._host_group is not None:
            self.mesh.release_host_group(self)
            self._host_group = None
        out: Dict[str, Any] = {}
        for idx, ep in enumerate(self.endpoints):
            key = ep.name if ep.name not in out else f"{ep.name}#{idx}"
            out[key] = ep.finalize()
        return out

    def drain(self, timeout: Optional[float] = None) -> Optional[BridgeData]:
        """Pipelined mode: block until every submitted field's host work
        completed (``TimeoutError`` after ``timeout`` s, if given);
        re-raises a host-endpoint failure. Returns the last host-side
        ``BridgeData`` (None in the serial modes, which have nothing in
        flight)."""
        if self._pipeline is None:
            return None
        try:
            return self._pipeline.drain(timeout=timeout)
        finally:
            # freeze even when re-raising a worker failure — otherwise
            # post-failure idle time leaks into wall_s
            self._freeze_wall()

    def _freeze_wall(self) -> None:
        """Record the pipelined wall-clock at the end of a batch (drain/
        shutdown). Only when submits happened since the last freeze —
        idle time between a drain and a later report/finalize must not
        count into wall_s (it would corrupt overlap_efficiency)."""
        if self._pipe_t0 is not None and self._pipe_wall == 0.0:
            self._pipe_wall = time.perf_counter() - self._pipe_t0

    def _shutdown_pipeline(self) -> None:
        if self._pipeline is None:
            return
        self._pipeline.close(drain=True)
        self._freeze_wall()
        self._pipe_report = self._pipeline.report()
        self._pipeline = None

    # -- execution ---------------------------------------------------------------
    def _device_prefix(self) -> List[Endpoint]:
        """The maximal leading run of device endpoints."""
        out = []
        for ep in self.endpoints:
            if ep.host:
                break
            out.append(ep)
        return out

    def execute(self, data: BridgeData) -> BridgeData:
        """Run one field through the chain.

        Serial modes return the fully-processed ``BridgeData``. The
        pipelined mode returns the (possibly still in-flight) device
        output at once and hands the host tail to the background
        pipeline — call ``drain()``/``finalize()`` for its effects."""
        if self.mode == "insitu":
            return self._execute_fused(data)
        if self.mode == "pipelined":
            return self._execute_pipelined(data)
        return self._execute_staged(data)

    def _execute_fused(self, data: BridgeData) -> BridgeData:
        """The device prefix back to back, one wait, host tail inline."""
        device_eps = self._device_prefix()
        out = data
        t0 = time.perf_counter()
        for ep in device_eps:
            out = ep.execute(out)
        _wait_for_device(out)
        self._timings["device"] = time.perf_counter() - t0
        for ep in self.endpoints[len(device_eps):]:
            t0 = time.perf_counter()
            out = ep.execute(out)
            self._timings[ep.name] = time.perf_counter() - t0
        return out

    def _execute_pipelined(self, data: BridgeData) -> BridgeData:
        """Launch the device prefix without waiting; offload the host
        tail. Field N+1's device stages queue while field N's results
        are still materializing on the pipeline worker."""
        if self._pipe_finalized:
            # finalize() happened (with or without a host pipeline):
            # silently restarting would run finalized endpoints and drop
            # any captured failure from the accounting
            raise RuntimeError(
                "pipelined chain was finalized; call initialize() before "
                "executing again")
        device_eps = self._device_prefix()
        host_eps = self.endpoints[len(device_eps):]

        if self._pipeline is None and host_eps:
            self._pipeline = HostPipeline(host_eps,
                                          depth=self.pipeline_depth,
                                          workers=self.pipeline_workers)
        now = time.perf_counter()
        if self._pipe_t0 is None:
            self._pipe_t0 = now
        elif self._pipe_wall != 0.0:
            # resuming after a frozen batch: shift the origin so wall_s
            # accumulates active batch windows only — idle time between
            # a drain and the next execute must not count
            self._pipe_t0 = now - self._pipe_wall
            self._pipe_wall = 0.0

        probing = (device_eps and self._pipe_calls == 1
                   and self._device_probe_s is None)
        if probing and self._probe_prev is not None:
            # overlap-efficiency calibration, part 2: first let field 0
            # clear the device (untimed) — its kernels, and the worker's
            # copy of it, whose first pinned host allocations stall
            # kernel launches — so the probe below times ONE field, not
            # the backlog
            self._probe_prev.synchronize()
            self._probe_prev = None
            if self._pipeline is not None:
                self._pipeline.drain(raise_error=False)
        t0 = time.perf_counter()
        out = data
        for ep in device_eps:
            out = ep.execute(out)
        out = record_ready(out)
        # the kernels are queued, not run: this measures LAUNCH cost
        self._dispatch_s += time.perf_counter() - t0
        ready = out.meta.get(READY_EVENT)
        if probing:
            # calibration, part 3: wait on exactly this one field's event
            # (the SECOND — the first call pays plan and allocator
            # warm-up) to learn the synchronous per-field device cost;
            # every other field stays asynchronous. See
            # pipeline.overlap_stats.
            if ready is not None:
                ready.synchronize()
            self._device_probe_s = time.perf_counter() - t0
        elif device_eps and self._pipe_calls == 0 \
                and self._device_probe_s is None:
            # calibration, part 1: keep field 0's event so the next call
            # can wait for it before probing (None for host tensors,
            # whose stages ran synchronously)
            self._probe_prev = ready
        self._pipe_calls += 1
        if self._host_group is not None:
            out = out.replace(meta={**out.meta, HOST_GROUP: self._host_group})
        if self._pipeline is not None:
            self._pipeline.submit(out)          # backpressure lives here
        return out

    def _execute_staged(self, data: BridgeData) -> BridgeData:
        """Every endpoint timed on its own; waits after every device
        stage."""
        out = data
        for ep in self.endpoints:
            t0 = time.perf_counter()
            out = ep.execute(out)
            if not ep.host:
                _wait_for_device(out)
            self._timings[ep.name] = (self._timings.get(ep.name, 0.0)
                                      + time.perf_counter() - t0)
        return out

    # -- reporting ------------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero all timing/accounting state (including the pipelined
        wall-clock origin) without touching queued work — call after
        warm-up so reports cover steady state."""
        self._timings.clear()
        self._dispatch_s = 0.0
        self._pipe_t0 = None
        self._pipe_wall = 0.0
        self._pipe_report = None
        if self._pipeline is not None:
            self._pipeline.reset_stats()

    def marshaling_report(self) -> Dict[str, Any]:
        """Mode, reshard bytes (0: no stage moves data between meshes),
        per-stage timings in seconds, plus (pipelined) queue/backpressure
        stats and the derived overlap-efficiency numbers — see
        ``pipeline.overlap_stats`` for their exact definitions."""
        rep = {"mode": self.mode, "reshard_bytes": 0,
               "timings_s": dict(self._timings)}
        pr = (self._pipeline.report() if self._pipeline is not None
              else self._pipe_report)
        if pr is not None:
            # frozen batch wall (set at drain/shutdown) when available;
            # the live clock only while work may still be in flight
            wall = self._pipe_wall
            if wall == 0.0 and self._pipe_t0 is not None \
                    and self._pipeline is not None:
                wall = time.perf_counter() - self._pipe_t0
            pipe = dict(pr)
            pipe.update(overlap_stats(
                wall_s=wall, dispatch_s=self._dispatch_s,
                device_probe_s=self._device_probe_s or 0.0,
                pipeline_report=pr))
            rep["pipeline"] = pipe
            rep["timings_s"].update(pr.get("host_timings_s", {}))
        return rep

    # -- training integration ---------------------------------------------------
    def as_step_hook(self):
        """A callable over training tensors that runs the device prefix
        and returns its ``insitu_*`` products: spectral monitoring inside
        a training step (the reference's ``train/step.py`` consumer).
        ``hook.reads`` lists, per endpoint that says (``selected``), the
        payload key it reads and the function naming the leaves it reads
        there."""
        device_eps = self._device_prefix()

        def hook(payload: Dict[str, Any]) -> Dict[str, Any]:
            d = BridgeData(arrays=dict(payload), domain="spatial")
            for ep in device_eps:
                d = ep.execute(d)
            return {k: v for k, v in d.arrays.items()
                    if k.startswith("insitu_")}
        hook.reads = [(ep.source, ep.selected) for ep in device_eps
                      if hasattr(ep, "selected")]
        return hook
