"""Endpoint protocol — Initialize / Execute / Finalize (paper §2.3)
(counterpart of ``repro/core/insitu/endpoint.py``).

Device endpoints (``host = False``) run on the device tensors of the
payload; host endpoints (writers, visualization) set ``host = True`` and
run on materialized outputs after the device stages.

Pipelined mode (``InSituChain(mode="pipelined")``, see ``pipeline.py``)
additionally runs host endpoints on a background worker so they overlap
the next field's device stages. Endpoints declare what that worker may
assume about them:

* ``thread_safe`` — ``execute`` may run concurrently with itself (from
  several worker threads at once). Required for ``pipeline_workers > 1``.
* ``ordered`` — ``execute`` must observe fields in submission (step)
  order. Ordered endpoints force a single worker; only endpoints
  declaring ``ordered = False`` *and* ``thread_safe = True`` may fan
  out across multiple workers.
"""
from __future__ import annotations

import abc
from typing import Any, Dict


class Endpoint(abc.ABC):
    """One stage of an in-situ chain (the paper's SENSEI endpoint).

    * ``name`` — registry/report key (``config.ENDPOINTS``,
      ``chain.marshaling_report()``).
    * ``host`` — True: runs on host data after the device stages.
    * ``thread_safe`` / ``ordered`` — pipelined-mode declarations, see
      the module docstring.
    """

    name: str = "endpoint"
    host: bool = False
    thread_safe: bool = False     # execute() may run concurrently w/ itself
    ordered: bool = True          # must see fields in submission order

    def __init__(self, **params):
        """Record the (JSON-able) config the endpoint was built from."""
        self.params = params

    def initialize(self, mesh=None, grid=None) -> None:
        """Plan-time setup: build FFT plans and masks, open files."""

    @abc.abstractmethod
    def execute(self, data):
        """Transform the bridge payload: take and return a ``BridgeData``;
        publish new products under ``insitu_*`` keys."""

    def finalize(self) -> Dict[str, Any]:
        """Tear down; return any summary the caller should report."""
        return {}
