"""In-situ chain composition — the paper's multi-stage daisy-chain
(counterpart of ``repro/core/insitu/chain.py``).

Two execution modes of the reference. Across the ranks of a mesh every
rank runs the same chain on its block of the field; the exchanges
happen inside the planned FFT endpoints, the bandpass energies are
all-reduced, and the writer gathers to rank 0.

* **in-situ** — the device endpoints run back to back on the device
  tensors (the handoff between stages is the tensor itself), then the
  chain waits for the device once and runs the host endpoints (writer,
  visualization) on the results.
* **in-transit (staged)** — the chain waits for the device after every
  device stage and keeps a timing per stage. Every stage keeps the
  layout the previous one left (no M→N move between stage meshes: that
  is ROADMAP queue 1 item 14), so ``reshard_bytes`` stays 0.

The ``pipelined`` mode (host tail on a background worker while the next
field runs on the device) is ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint

MODES = ("insitu", "intransit", "pipelined")


def _wait_for_device(data: BridgeData) -> None:
    """Block until the device has finished the work behind ``data``."""
    def tensors(v):
        return v if isinstance(v, tuple) else (v,)
    if any(torch.is_tensor(t) and t.is_cuda
           for v in data.arrays.values() for t in tensors(v)):
        torch.cuda.synchronize()


class InSituChain:
    """An ordered list of endpoints run as one processing chain."""

    def __init__(self, endpoints: List[Endpoint], mesh=None, *,
                 mode: str = "insitu"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "pipelined":
            raise NotImplementedError(
                "the pipelined mode is ROADMAP queue 1 item 11")
        self.endpoints = endpoints
        self.mesh = mesh
        self.mode = mode
        self._timings: Dict[str, float] = {}

    # -- lifecycle -------------------------------------------------------------
    def initialize(self, grid=None):
        """(Re-)initialize every endpoint and clear the timings."""
        self._timings.clear()
        for ep in self.endpoints:
            ep.initialize(self.mesh, grid)
        return self

    def finalize(self) -> Dict[str, Any]:
        """Finalize every endpoint. Returns ``{endpoint_name: summary}``;
        repeated endpoint names get ``name#idx`` keys for the later
        occurrences."""
        out: Dict[str, Any] = {}
        for idx, ep in enumerate(self.endpoints):
            key = ep.name if ep.name not in out else f"{ep.name}#{idx}"
            out[key] = ep.finalize()
        return out

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
        """Run one field through the chain."""
        if self.mode == "insitu":
            return self._execute_fused(data)
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
    def marshaling_report(self) -> Dict[str, Any]:
        """Mode, reshard bytes (0: no stage moves data between meshes) and
        per-stage timings in seconds."""
        return {"mode": self.mode, "reshard_bytes": 0,
                "timings_s": dict(self._timings)}
