"""Bandpass filter endpoint (paper §2.3): zero out unwanted frequencies
(counterpart of ``repro/core/insitu/endpoints/bandpass.py``).

The natural-order mask is built once at ``initialize`` on the host. At
execute it follows the payload's layout tag (digit-permuted layouts
gather it through ``fourstep_freq_of_position``) and, on a mesh of more
than one rank, is cut to this rank's block by the payload's spec; each
variant is kept on the device, one per (layout, spec, shape).
Execution is the fused bandpass kernel (filter + kept/total energy in
one pass) on 2-D blocks, or a plain multiply otherwise, as in the
reference. The energies are global: across ranks the block sums are
all-reduced in float64 (each replicated block counted once).
"""
from __future__ import annotations

import torch

from repro_torch.core.fft import distributed, filters
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.endpoint import Endpoint
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import bandpass_ref


class BandpassEndpoint(Endpoint):
    """Spectral mask + kept/total energy reduction in one stage."""

    name = "bandpass"

    def __init__(self, *, array: str = "field", keep_frac: float = 0.0075,
                 low_frac: float = 0.0, kind: str = "lowpass",
                 use_kernel: bool = True):
        super().__init__(array=array, keep_frac=keep_frac)
        self.array = array
        self.keep_frac = keep_frac
        self.low_frac = low_frac
        self.kind = kind
        self.use_kernel = use_kernel
        self.mask = None
        self._mesh = None
        self._masks = {}

    def initialize(self, mesh=None, grid=None):
        """Build the natural-order mask for the grid (on the host); the
        layout- and rank-specific variants are derived at execute."""
        self._mesh = mesh
        self._masks.clear()
        self.mask = None
        if grid is None:
            return
        shape = grid.dims
        if self.kind == "lowpass":
            self.mask = filters.lowpass_mask(shape, self.keep_frac)
        elif self.kind == "highpass":
            self.mask = filters.highpass_mask(shape, self.keep_frac)
        else:
            self.mask = filters.bandpass_mask(shape, self.low_frac,
                                              self.keep_frac)

    def _mask_for(self, data: BridgeData, re) -> torch.Tensor:
        """The mask in the payload's layout, cut to this rank's block, as
        float32 on the data's device (cached)."""
        key = (data.layout, data.spec, tuple(re.shape), str(re.device))
        cached = self._masks.get(key)
        if cached is not None:
            return cached
        mask = self.mask
        if mask is None:
            # prefer the grid dims: re may be a padded half-spectrum
            # and/or carry leading batch dims
            shape = data.grid.dims if data.grid is not None else re.shape
            mask = filters.lowpass_mask(shape, self.keep_frac)
        base_layout = data.layout[:-len("-half")] \
            if data.layout.endswith("-half") else data.layout
        if base_layout in ("fourstep", "rotated-fourstep"):
            if self._mesh is None:
                raise ValueError(
                    f"bandpass on layout={data.layout!r} needs the mesh "
                    f"(shard count of the permuted axis): initialize(mesh, "
                    f"grid) it, or pre-permute the mask")
            mask = filters.permute_mask_first_axis(
                mask, self._mesh.shape[self._mesh.axis_names[0]])
        hp = re.shape[-1]
        if self._mesh is not None and data.spec is not None:
            hp *= distributed.shard_count(self._mesh, data.spec[-1])
        if data.layout.endswith("half") and mask.shape[-1] != hp:
            # r2c path: the spectrum keeps only k_last <= N/2, padded to
            # the global half extent hp (this rank holds a block of it)
            mask = filters.halfspec_mask(mask, hp)
        if self._mesh is not None and data.spec is not None:
            mask = distributed.shard(mask, self._mesh, data.spec)
        mask = mask.to(device=re.device, dtype=torch.float32).contiguous()
        self._masks[key] = mask
        return mask

    def _global_sums(self, spec, kept, tot):
        """Sum the block energies over the mesh in float64, each block
        once (ranks along an axis the spec does not name hold copies)."""
        mesh = self._mesh
        if mesh is None or mesh.size == 1 or spec is None:
            return kept, tot
        sums = distributed.sum_over_blocks(torch.stack((kept, tot)), mesh,
                                           spec).float()
        return sums[0], sums[1]

    def execute(self, data: BridgeData) -> BridgeData:
        """Mask the spectrum in its native layout and publish the global
        ``insitu_kept_energy`` / ``insitu_total_energy``."""
        if data.domain != "spectral":
            raise ValueError("bandpass needs spectral input, got "
                             f"domain={data.domain!r}")
        re, im = data.get_pair(self.array)
        mask = self._mask_for(data, re)
        if self.use_kernel and re.dim() == 2:
            r, i, kept, tot = kops.bandpass(re, im, mask)
        else:
            r, i, kept, tot = bandpass_ref(re, im, mask)
        kept, tot = self._global_sums(data.spec, kept, tot)
        arrays = dict(data.arrays)
        arrays["insitu_kept_energy"] = kept
        arrays["insitu_total_energy"] = tot
        arrays[self.array] = (r, i)
        return data.replace(arrays=arrays)
