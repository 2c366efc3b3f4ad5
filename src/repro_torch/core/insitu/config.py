"""Declarative chain configuration — the paper's XML analogue (§2.2.1)
(counterpart of ``repro/core/insitu/config.py``).

A chain is a JSON-able dict, the same dict that drives the reference:

    {"mode": "insitu",
     "chain": [
        {"endpoint": "fft",      "array": "field", "direction": "forward",
         "backend": "pallas"},
        {"endpoint": "bandpass", "keep_frac": 0.05},
        {"endpoint": "fft",      "array": "field", "direction": "backward",
         "backend": "pallas"},
        {"endpoint": "writer"}]}

``"mode": "pipelined"`` takes ``pipeline_depth``, ``pipeline_workers``
and ``donate_buffers`` beside it, as in the reference (``chain.py``).
``backend: "pallas"`` selects the hand-written CUDA kernels, as it
selects the Pallas kernels in the reference. ``build_chain(cfg, mesh,
grid)`` instantiates the registered endpoints and initializes them
(FFT planning happens here, FFTW-style).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Union

from repro_torch.core.insitu.chain import InSituChain
from repro_torch.core.insitu.endpoint import Endpoint
from repro_torch.core.insitu.endpoints.bandpass import BandpassEndpoint
from repro_torch.core.insitu.endpoints.fft_endpoint import FFTEndpoint
from repro_torch.core.insitu.endpoints.spectral_monitor import \
    SpectralMonitorEndpoint
from repro_torch.core.insitu.endpoints.stats import (SpectrumEndpoint,
                                                     StatsEndpoint)
from repro_torch.core.insitu.endpoints.writer import (VisualizeEndpoint,
                                                      WriterEndpoint)

ENDPOINTS: Dict[str, type] = {
    "fft": FFTEndpoint,
    "bandpass": BandpassEndpoint,
    "stats": StatsEndpoint,
    "spectrum": SpectrumEndpoint,
    "spectral_monitor": SpectralMonitorEndpoint,
    "writer": WriterEndpoint,
    "visualize": VisualizeEndpoint,
}


def register_endpoint(name: str, cls: type):
    """Register a custom endpoint class under a config name."""
    if not issubclass(cls, Endpoint):
        raise TypeError(f"{cls!r} is not an Endpoint")
    ENDPOINTS[name] = cls


def build_chain(cfg: Union[Dict[str, Any], str, Path], mesh=None,
                grid=None) -> InSituChain:
    """Instantiate + initialize a chain from a config dict (or a path
    to a JSON file holding one) — the paper's XML-load moment."""
    if isinstance(cfg, (str, Path)):
        cfg = json.loads(Path(cfg).read_text())
    eps = []
    for spec in cfg["chain"]:
        spec = dict(spec)
        kind = spec.pop("endpoint")
        if kind not in ENDPOINTS:
            raise KeyError(f"unknown endpoint {kind!r}; "
                           f"known: {sorted(ENDPOINTS)}")
        eps.append(ENDPOINTS[kind](**spec))
    chain = InSituChain(
        eps, mesh=mesh, mode=cfg.get("mode", "insitu"),
        pipeline_depth=cfg.get("pipeline_depth", 2),
        pipeline_workers=cfg.get("pipeline_workers", 1),
        donate_buffers=cfg.get("donate_buffers", False))
    chain.initialize(grid)
    return chain
