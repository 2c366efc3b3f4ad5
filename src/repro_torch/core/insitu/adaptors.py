"""Data adaptors + the demonstration producer (paper §3.2) (counterpart
of ``repro/core/insitu/adaptors.py``).

``radiating_field`` draws from numpy exactly as the reference does, so
both packages get the same field from a seed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.insitu.bridge import BridgeData, GridMeta


def radiating_field(dims: Tuple[int, int] = (200, 200),
                    center: Optional[Tuple[float, float]] = None,
                    *, noise_frac: float = 0.5, noise_scale: float = 25.0,
                    seed: int = 0, period: float = 20.0):
    """The paper's noisy radiating source. Returns (noisy, clean) float32
    numpy arrays."""
    n0, n1 = dims
    yc, xc = center or (n0 / 2.0, n1 / 2.0)
    y, x = np.mgrid[0:n0, 0:n1].astype(np.float64)
    r = np.sqrt((x - xc) ** 2 + (y - yc) ** 2)
    clean = np.sin(r / period * 2 * np.pi)        # radiating rings
    rng = np.random.default_rng(seed)
    mask = rng.random(dims) < noise_frac
    noise = rng.standard_normal(dims) * (noise_scale / 25.0)
    noisy = clean + np.where(mask, noise, 0.0)
    return noisy.astype(np.float32), clean.astype(np.float32)


class RadiatingSourceAdaptor:
    """Producer + Data Adaptor for the paper's demonstration workflow.
    Tensors land on ``device``: by default the mesh's device, else the
    CUDA device."""

    def __init__(self, dims=(200, 200), *, mesh=None, device=None, **kw):
        self.dims = tuple(dims)
        if device is None:
            device = mesh.device if mesh is not None else "cuda"
        self.device = torch.device(device)
        self.kw = kw
        self.grid = GridMeta(self.dims)

    def produce(self, step: int = 0) -> BridgeData:
        """One simulation step's payload: the noisy field (primary,
        seeded by ``step``) plus its clean reference."""
        noisy, clean = radiating_field(self.dims, seed=step, **self.kw)
        return BridgeData(
            arrays={"field": torch.from_numpy(noisy).to(self.device),
                    "clean_reference": torch.from_numpy(clean).to(
                        self.device)},
            grid=self.grid, step=step, meta={"primary": "field"})
