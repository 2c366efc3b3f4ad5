"""Host-side endpoints: array writer + image visualization (counterpart
of ``repro/core/insitu/endpoints/writer.py``).

These terminate a chain the way the paper's matplotlib endpoint does
(§2.3). ``host = True``: they run on materialized arrays after the
device stages. The visualizer writes portable PGM (and a PNG when
matplotlib is installed). Both declare ``ordered = True``: in pipelined
mode their file lists follow submission order, so the chain keeps them
on one pipeline worker. Across ranks they gather to the mesh's first rank
on the payload's ``meta[pipeline.HOST_GROUP]`` process group when it
names one (the pipelined chain's own group, so the worker's gathers
never interleave with the producer's exchanges), else on the mesh's.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.fft.distributed import unshard
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint
from repro_torch.core.insitu.pipeline import HOST_GROUP


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _gather(v, mesh, data: BridgeData):
    """The global array from this rank's block, on the mesh's first rank
    (None on the others); ``v`` itself where nothing is placed."""
    if mesh is None or data.spec is None:
        return v
    return unshard(v, mesh, data.spec, dst=mesh.first_rank,
                   group=data.meta.get(HOST_GROUP))


class WriterEndpoint(Endpoint):
    """Persist one named array per step as an (atomically published)
    ``.npy`` file; ``finalize`` reports the files written, in step
    order. Across ranks the payload's blocks are gathered to the mesh's
    first rank, which writes the one global array the reference writes;
    the other ranks write nothing. ``ordered = True``: in pipelined mode the file
    list must follow submission order."""

    name = "writer"
    host = True
    ordered = True

    def __init__(self, *, array: str = "field", out_dir: str = "results/insitu",
                 prefix: str = "field", every: int = 1):
        super().__init__(array=array, out_dir=out_dir)
        self.array = array
        self.out_dir = Path(out_dir)
        self.prefix = prefix
        self.every = every
        self.mesh = None
        self.written = []

    def initialize(self, mesh=None, grid=None):
        """Create the output directory."""
        self.mesh = mesh
        self.out_dir.mkdir(parents=True, exist_ok=True)

    def execute(self, data: BridgeData) -> BridgeData:
        """Write ``array`` (the real plane of an (re, im) pair) to
        ``<prefix>_<step>.npy`` every ``every`` steps; pass-through."""
        if data.step % self.every:
            return data
        v = data.arrays[self.array]
        v = v[0] if isinstance(v, tuple) else v
        v = _gather(v, self.mesh, data)
        if v is None:                 # not the mesh's first rank
            return data
        arr = _host(v)
        path = self.out_dir / f"{self.prefix}_{data.step:06d}.npy"
        tmp = path.with_suffix(".tmp.npy")
        np.save(tmp, arr)
        os.replace(tmp, path)               # atomic publish
        self.written.append(str(path))
        return data

    def finalize(self):
        """Report the files written, in step order."""
        return {"files": self.written}


class VisualizeEndpoint(Endpoint):
    """Render one named array per step to portable PGM (plus PNG when
    matplotlib is available) — the paper's matplotlib endpoint role.
    Across ranks the mesh's first rank renders the gathered global array. Ordered for
    the same file-list reason as ``WriterEndpoint``."""

    name = "visualize"
    host = True
    ordered = True

    def __init__(self, *, array: str = "field",
                 out_dir: str = "results/insitu", prefix: str = "viz",
                 log_scale: bool = False):
        super().__init__(array=array)
        self.array = array
        self.out_dir = Path(out_dir)
        self.prefix = prefix
        self.log_scale = log_scale
        self.mesh = None
        self.written = []

    def initialize(self, mesh=None, grid=None):
        """Create the output directory."""
        self.mesh = mesh
        self.out_dir.mkdir(parents=True, exist_ok=True)

    def execute(self, data: BridgeData) -> BridgeData:
        """Render ``array`` (|z| for an (re, im) pair, mid-slice for 3-D
        fields, optional log scale) to ``<prefix>_<step>.pgm``."""
        v = data.arrays[self.array]
        parts = [_gather(x, self.mesh, data)
                 for x in (v if isinstance(v, tuple) else (v,))]
        if parts[0] is None:          # not the mesh's first rank
            return data
        if len(parts) == 2:
            arr = np.abs(_host(parts[0]) + 1j * _host(parts[1]))
        else:
            arr = _host(parts[0])
        if arr.ndim == 3:
            arr = arr[arr.shape[0] // 2]
        if self.log_scale:
            arr = np.log1p(np.abs(arr))
        path = self.out_dir / f"{self.prefix}_{data.step:06d}.pgm"
        write_pgm(path, arr)
        self.written.append(str(path))
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return data
        plt.imsave(str(path.with_suffix(".png")), arr, cmap="viridis")
        self.written.append(str(path.with_suffix(".png")))
        return data

    def finalize(self):
        """Report the files written, in step order."""
        return {"files": self.written}


def write_pgm(path, arr: np.ndarray):
    """Write a 2-D array as an 8-bit binary PGM, min/max normalized."""
    lo, hi = float(arr.min()), float(arr.max())
    scale = 255.0 / (hi - lo) if hi > lo else 1.0
    img = ((arr - lo) * scale).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())
