"""Endpoint protocol — Initialize / Execute / Finalize (paper §2.3)
(counterpart of ``repro/core/insitu/endpoint.py``).

Device endpoints (``host = False``) run on the device tensors of the
payload; host endpoints (writers, visualization) set ``host = True`` and
run on materialized outputs after the device stages. The pipelined
mode's declarations (``thread_safe``, ``ordered``) come with it, ROADMAP
queue 1 item 11.
"""
from __future__ import annotations

import abc
from typing import Any, Dict


class Endpoint(abc.ABC):
    """One stage of an in-situ chain (the paper's SENSEI endpoint).

    * ``name`` — registry/report key (``config.ENDPOINTS``,
      ``chain.marshaling_report()``).
    * ``host`` — True: runs on host data after the device stages.
    """

    name: str = "endpoint"
    host: bool = False

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
