"""Bandpass filter endpoint (paper §2.3): zero out unwanted frequencies
(counterpart of ``repro/core/insitu/endpoints/bandpass.py``).

The mask is built once at ``initialize`` as float32 on the mesh's
device. Execution is the fused bandpass kernel (filter + kept/total
energy in one pass) on 2-D planes, or a plain multiply otherwise.
Digit-permuted layouts (``fourstep``, ``rotated-fourstep``) need the
distributed layout maps and come with ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import torch

from repro_torch.core.fft import filters
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

    def initialize(self, mesh=None, grid=None):
        """Build the natural-order mask for the grid, as float32 on the
        mesh's device (kept on the CPU without a mesh, and moved to the
        data's device at the first execute)."""
        self.mask = None
        if grid is None:
            return
        shape = grid.dims
        if self.kind == "lowpass":
            mask = filters.lowpass_mask(shape, self.keep_frac)
        elif self.kind == "highpass":
            mask = filters.highpass_mask(shape, self.keep_frac)
        else:
            mask = filters.bandpass_mask(shape, self.low_frac,
                                         self.keep_frac)
        device = mesh.device if mesh is not None else "cpu"
        self.mask = mask.to(device=device, dtype=torch.float32)

    def execute(self, data: BridgeData) -> BridgeData:
        """Mask the spectrum in its native layout and publish
        ``insitu_kept_energy`` / ``insitu_total_energy``."""
        if data.domain != "spectral":
            raise ValueError("bandpass needs spectral input, got "
                             f"domain={data.domain!r}")
        re, im = data.get_pair(self.array)
        if self.mask is None:
            # prefer the grid dims: re may be a padded half-spectrum
            # and/or carry leading batch dims
            shape = data.grid.dims if data.grid is not None else re.shape
            self.mask = filters.lowpass_mask(shape, self.keep_frac).float()
        if self.mask.device != re.device:
            self.mask = self.mask.to(re.device)
        mask = self.mask
        base_layout = data.layout[:-len("-half")] \
            if data.layout.endswith("-half") else data.layout
        if base_layout in ("fourstep", "rotated-fourstep"):
            raise NotImplementedError(
                f"bandpass on the digit-permuted layout {data.layout!r} is "
                f"ROADMAP queue 1 item 8")
        if data.layout.endswith("half") and mask.shape[-1] != re.shape[-1]:
            # r2c path: the spectrum keeps only k_last <= N/2 (padded) —
            # scatter the full-grid mask into the half layout to match
            mask = filters.halfspec_mask(mask, re.shape[-1])
        arrays = dict(data.arrays)
        if self.use_kernel and re.dim() == 2:
            r, i, kept, tot = kops.bandpass(re, im, mask)
        else:
            r, i, kept, tot = bandpass_ref(re, im, mask)
        arrays["insitu_kept_energy"] = kept
        arrays["insitu_total_energy"] = tot
        arrays[self.array] = (r, i)
        return data.replace(arrays=arrays)
