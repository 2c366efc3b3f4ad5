"""Descriptive statistics and spectral analysis endpoints (counterpart
of ``repro/core/insitu/endpoints/stats.py``).

The small "science product" stages of a chain: summary statistics of a
field and its radial power spectrum (``spectrum.py``), published back
onto the bridge under ``insitu_*`` keys. On a mesh of more than one
rank each rank holds a block of the field (``BridgeData.spec``), so the
sums are all-reduced in float64 over the mesh's ranks (each replicated
block counted once, as the bandpass energies are) and every rank of the
mesh publishes the global values.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.fft import distributed, spectrum
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint


def _spread(mesh, spec) -> bool:
    """Whether the payload is cut into blocks over a mesh of ranks."""
    return mesh is not None and mesh.size > 1 and spec is not None


class StatsEndpoint(Endpoint):
    """Publish ``insitu_stats`` = [min, max, mean, std, rms] of one named
    array (the real plane of an (re, im) pair)."""

    name = "stats"

    def __init__(self, *, array: str = "field"):
        super().__init__(array=array)
        self.array = array
        self._mesh = None

    def initialize(self, mesh=None, grid=None):
        self._mesh = mesh

    def execute(self, data: BridgeData) -> BridgeData:
        """The five summary statistics, on the device."""
        v = data.arrays[self.array]
        xf = (v[0] if isinstance(v, tuple) else v).float()
        if _spread(self._mesh, data.spec):
            stats = self._global(xf, data.spec)
        else:
            stats = torch.stack([xf.min(), xf.max(), xf.mean(),
                                 xf.std(correction=0),
                                 torch.sqrt(torch.mean(xf * xf))])
        arrays = dict(data.arrays)
        arrays["insitu_stats"] = stats
        return data.replace(arrays=arrays)

    def _global(self, xf, spec):
        x = xf.double()
        sums = distributed.sum_over_blocks(torch.stack([
            x.sum(), (x * x).sum(),
            torch.tensor(float(x.numel()), device=x.device,
                         dtype=torch.float64)]), self._mesh, spec)
        lo, hi = x.min().reshape(1), x.max().reshape(1)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN,
                        group=self._mesh.mesh_group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX,
                        group=self._mesh.mesh_group)
        mean = sums[0] / sums[2]
        msq = sums[1] / sums[2]
        std = torch.sqrt(torch.clamp(msq - mean * mean, min=0.0))
        return torch.stack([lo[0], hi[0], mean, std,
                            torch.sqrt(msq)]).float()


class SpectrumEndpoint(Endpoint):
    """Publish the radially binned power spectrum of a spectral-domain
    array as ``insitu_spectrum_k`` / ``insitu_spectrum_e``. Frequencies
    are read in natural order over the array's global shape, as the
    reference reads them."""

    name = "spectrum"

    def __init__(self, *, array: str = "field", nbins: int = 32):
        super().__init__(array=array, nbins=nbins)
        self.array = array
        self.nbins = nbins
        self._mesh = None

    def initialize(self, mesh=None, grid=None):
        self._mesh = mesh

    def execute(self, data: BridgeData) -> BridgeData:
        """Radially bin |z|² into ``nbins`` shells."""
        if data.domain != "spectral":
            raise ValueError("spectrum needs spectral input, got "
                             f"domain={data.domain!r}")
        re, im = data.get_pair(self.array)
        if _spread(self._mesh, data.spec):
            k, e = self._global(re, im, data.spec)
        else:
            k, e = spectrum.radial_spectrum(re, im, self.nbins)
        arrays = dict(data.arrays)
        arrays["insitu_spectrum_k"] = k
        arrays["insitu_spectrum_e"] = e
        return data.replace(arrays=arrays)

    def _global(self, re, im, spec):
        """The spectrum of the global array from this rank's block: the
        block's shells, summed over the ranks."""
        mesh = self._mesh
        lead = re.dim() - len(spec)
        shape = list(re.shape)
        for i, entry in enumerate(spec):
            shape[lead + i] *= distributed.shard_count(mesh, entry)
        cut = distributed._slices(mesh, spec, tuple(shape), mesh.coordinate)
        bins, kmax = spectrum.shell_bins(shape, self.nbins, cut)
        e, cnt = spectrum.shell_sums(re, im, bins, self.nbins)
        sums = distributed.sum_over_blocks(torch.stack([e, cnt]), mesh, spec)
        centers = torch.linspace(0, float(kmax), self.nbins, device=re.device)
        return centers, (sums[0] / torch.clamp(sums[1], min=1.0)).float()
