"""Fused spectral bandpass + band-energy reduction: the CUDA kernel
``csrc/bandpass.cu`` (port of the Pallas kernel
``repro/kernels/bandpass.py``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it computes the plain version, ``ref.bandpass_ref``.
``bandpass_filter.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bandpass_ref


def bandpass_filter(re, im, mask, *, block_rows: int = 256):
    """(R, C) spectrum planes × (R, C) float mask → filtered planes +
    kept/total energies (0-d float32); a CTA takes at most
    ``block_rows`` rows."""
    if all(t.device.type == "cpu" for t in (re, im, mask)):
        return bandpass_ref(re, im, mask)
    _build.check_planes("bandpass_filter", re, im, mask)
    R, C = re.shape
    rows = _build.rows_per_cta(block_rows, R, R, re.device)
    grid = -(-R // rows)
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    partial = torch.empty(2 * grid, dtype=torch.float64, device=re.device)
    sums = torch.empty(2, dtype=torch.float32, device=re.device)
    lib = _build.library()
    _build.check(lib.repro_bandpass(
        re.data_ptr(), im.data_ptr(), mask.data_ptr(), ore.data_ptr(),
        oim.data_ptr(), partial.data_ptr(), sums.data_ptr(), R, C, rows,
        _build.stream(re.device)), "bandpass_filter")
    bandpass_filter.launches += 1
    return ore, oim, sums[0], sums[1]


bandpass_filter.launches = 0
