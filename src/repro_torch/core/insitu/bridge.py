"""Bridge data model — the SENSEI-bridge analogue (counterpart of
``repro/core/insitu/bridge.py``).

``BridgeData`` carries one step's named tensors plus structured-grid
metadata through the chain. Spectral fields travel as split (re, im)
float32 pairs, as in the reference. ``from_numpy`` / ``to_numpy`` carry
a payload across from and back to numpy arrays, which is how the tests
hand one step's state between the reference and the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridMeta:
    """Structured-grid metadata (the VTK image-data analogue): global
    dims plus per-axis spacing/origin (defaulted to unit/zero)."""
    dims: Tuple[int, ...]
    spacing: Tuple[float, ...] = ()
    origin: Tuple[float, ...] = ()

    def __post_init__(self):
        nd = len(self.dims)
        if not self.spacing:
            object.__setattr__(self, "spacing", (1.0,) * nd)
        if not self.origin:
            object.__setattr__(self, "origin", (0.0,) * nd)


@dataclasses.dataclass
class BridgeData:
    """One step's payload moving through the chain."""
    arrays: Dict[str, Any]                  # name -> tensor | (re, im)
    grid: Optional[GridMeta] = None
    step: int = 0
    time: float = 0.0
    domain: str = "spatial"                 # spatial | spectral
    layout: str = "natural"        # spatial: natural; spectral: transposed
                                   # (each "+-half" for r2c)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "BridgeData":
        """Functional update (endpoints never mutate payloads in place)."""
        return dataclasses.replace(self, **kw)

    def primary(self) -> str:
        """Name of the primary array (``meta['primary']``, else the
        first key) — what single-array endpoints default to."""
        return self.meta.get("primary", next(iter(self.arrays)))

    def get_pair(self, name: Optional[str] = None):
        """Return (re, im) for an array, promoting real -> (x, 0)."""
        v = self.arrays[name or self.primary()]
        if isinstance(v, tuple):
            return v
        v = v.float()
        return v, torch.zeros_like(v)


def from_numpy(arrays: Dict[str, Any], grid_dims, *, step: int = 0,
               domain: str = "spatial", layout: str = "natural",
               device="cuda", meta: Optional[Dict[str, Any]] = None
               ) -> BridgeData:
    """A payload from numpy arrays (or (re, im) pairs of them), e.g. a
    reference ``BridgeData``'s arrays taken through ``np.asarray``."""
    def put(v):
        if isinstance(v, tuple):
            return tuple(put(x) for x in v)
        return torch.tensor(np.asarray(v), device=device)
    return BridgeData(arrays={k: put(v) for k, v in arrays.items()},
                      grid=GridMeta(tuple(int(d) for d in grid_dims)),
                      step=step, domain=domain, layout=layout,
                      meta=dict(meta or {}))


def to_numpy(data: BridgeData) -> Dict[str, Any]:
    """The payload's arrays as numpy (pairs stay pairs)."""
    def get(v):
        if isinstance(v, tuple):
            return tuple(get(x) for x in v)
        return v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)
    return {k: get(v) for k, v in data.arrays.items()}
