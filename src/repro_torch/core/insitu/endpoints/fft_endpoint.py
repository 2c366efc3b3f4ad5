"""The SENSEI FFT endpoint — the paper's primary contribution (§2.2)
(counterpart of ``repro/core/insitu/endpoints/fft_endpoint.py``).

Configured like the paper's XML (mesh / array / direction), it turns
the bridge's named array into split-plane spectral form, runs the
planned transform (FFTW's plan-execute lifecycle via the cached
``FFTPlan``; decomposition inferred from grid rank and mesh), and
republishes the result. Forward sets ``domain="spectral"`` + the layout
tag; backward restores spatial data. ``local=True`` (or no mesh)
transforms with ``torch.fft`` instead of a plan, as the reference does
with ``jnp.fft``.

``real=True`` on a plan (r2c/c2r half-spectrum) is ROADMAP queue 1
item 9; the ``local=True`` real path is here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fft.plan import BACKWARD, FORWARD, plan_dft
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint

_LAYOUT = {"slab": "transposed", "slab3d": "transposed"}


class FFTEndpoint(Endpoint):
    """Planned (or ``local=True``) FFT as a chain stage."""

    name = "fft"

    def __init__(self, *, array: str = "field", direction: str = "forward",
                 backend: str = "auto", decomp: Optional[str] = None,
                 overlap_chunks: int = 0, local: bool = False,
                 real: bool = False, batch_ndim: int = 0,
                 wire_dtype: Optional[str] = None):
        super().__init__(array=array, direction=direction)
        self.array = array
        self.direction = FORWARD if direction == "forward" else BACKWARD
        self.backend = backend
        self.decomp = decomp
        self.overlap_chunks = overlap_chunks
        self.local = local
        self.real = real
        self.batch_ndim = batch_ndim
        self.wire_dtype = wire_dtype
        self.plan = None
        self._grid_dims = None

    def initialize(self, mesh=None, grid=None):
        """Build (or fetch from the process-wide cache) the plan for
        ``grid.dims`` on ``mesh``; ``local=True``/no-mesh chains skip
        planning and transform with ``torch.fft`` at execute time."""
        if grid is not None:
            self._grid_dims = tuple(grid.dims)
        if self.local or mesh is None:
            return
        if grid is None:
            raise ValueError("FFTEndpoint needs grid dims to plan")
        if self.real:
            raise NotImplementedError(
                "real=True plans (r2c/c2r) are ROADMAP queue 1 item 9")
        self.plan = plan_dft(grid.dims, self.direction, mesh,
                             decomp=self.decomp, backend=self.backend,
                             overlap_chunks=self.overlap_chunks,
                             batch_ndim=self.batch_ndim,
                             wire_dtype=self.wire_dtype)

    def _run_local(self, re, im):
        # transform only the trailing grid dims — leading batch dims are
        # independent fields, exactly like the planned transforms
        nd = re.dim() - self.batch_ndim
        dims = tuple(range(-nd, 0))
        if self.real and self.direction == FORWARD:
            z = torch.fft.rfftn(re, dim=dims)
            return (z.real.float(), z.imag.float()), "natural-half"
        if self.real and self.direction == BACKWARD:
            y = torch.fft.irfftn(torch.complex(re, im), s=self._grid_dims,
                                 dim=dims).float()
            return (y, torch.zeros_like(y)), "natural"
        x = torch.complex(re, im)
        out = (torch.fft.ifftn(x, dim=dims) if self.direction == BACKWARD
               else torch.fft.fftn(x, dim=dims))
        return (out.real.float(), out.imag.float()), "natural"

    def execute(self, data: BridgeData) -> BridgeData:
        """Transform ``array`` and republish it with the matching
        ``domain``/``layout`` tags."""
        re, im = data.get_pair(self.array)
        if self.plan is None:
            (r, i), layout = self._run_local(re, im)
        else:
            r, i = self.plan.execute(re, im)
            layout = _LAYOUT[self.plan.decomp] \
                if self.direction == FORWARD else "natural"

        arrays = dict(data.arrays)
        if self.direction == FORWARD:
            arrays[self.array] = (r, i)
            return data.replace(arrays=arrays, domain="spectral",
                                layout=layout)
        arrays[self.array] = r        # real field (imag ~ 0 for real input)
        arrays[self.array + "_imag"] = i
        return data.replace(arrays=arrays, domain="spatial",
                            layout="natural")
