"""Fused spectral bandpass + band-energy reduction: the CUDA kernel
``csrc/bandpass.cu`` (port of the Pallas kernel
``repro/kernels/bandpass.py``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it computes the plain version, ``ref.bandpass_ref``.
``bandpass_filter.launches`` counts kernel launches. ``plan`` sizes the
flat pass (its grid and unit) on the host.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bandpass_ref

# csrc/bandpass.cu's constants: the flat pass's CTA and the units a thread
# has in flight a plane
THREADS = 256
UNROLL = 2


class Plan(NamedTuple):
    grid: int          # CTAs, each writing its float64 partials
    vec: bool          # float4 units (all five planes 16-byte aligned)


def plan(n: int, vec: bool, sms: int, ctas_per_sm: int) -> Plan:
    """The flat pass over n points: float4 units where ``vec``; a grid of
    one wave of resident CTAs (``sms`` times ``ctas_per_sm``, from the
    occupancy API), or one CTA a tile where the planes hold fewer tiles."""
    if n < 1 or sms < 1 or ctas_per_sm < 1:
        raise ValueError(f"bandpass plan: n={n}, sms={sms}, "
                         f"ctas_per_sm={ctas_per_sm}")
    tiles = -(-n // tile_points(vec))
    return Plan(min(tiles, sms * ctas_per_sm), vec)


def tile_points(vec: bool) -> int:
    """Points of one tile: THREADS * UNROLL units of 4 points (vec) or 1."""
    return THREADS * UNROLL * (4 if vec else 1)


@functools.lru_cache(maxsize=None)
def _ctas_per_sm(vec: bool, device: torch.device) -> int:
    """The occupancy API's CTAs of the flat pass an SM on ``device``."""
    with torch.cuda.device(device):
        got = _build.library().repro_bandpass_ctas_per_sm(int(vec))
    _build.check(-got if got < 0 else 0, "bandpass_filter occupancy")
    if got < 1:
        raise RuntimeError("bandpass_filter: no CTA of the flat pass fits "
                           "an SM")
    return got


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bandpass_filter(re, im, mask, *, block_rows: int = 256):
    """(R, C) spectrum planes × (R, C) float mask → filtered planes +
    kept/total energies (0-d float32). ``block_rows`` is the reference's
    row-block hint: checked, and the result does not depend on it (the
    kernel walks the planes flat)."""
    if all(t.device.type == "cpu" for t in (re, im, mask)):
        return bandpass_ref(re, im, mask)
    _build.check_planes("bandpass_filter", re, im, mask)
    _build.check_block("bandpass_filter", block_rows, "block_rows")
    R, C = re.shape
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    sums = torch.empty(2, dtype=torch.float32, device=re.device)
    vec = all(t.data_ptr() % 16 == 0 for t in (re, im, mask, ore, oim))
    p = plan(R * C, vec, _sms(re.device), _ctas_per_sm(vec, re.device))
    partial = torch.empty(2 * p.grid, dtype=torch.float64, device=re.device)
    code = _build.library().repro_bandpass(
        re.data_ptr(), im.data_ptr(), mask.data_ptr(), ore.data_ptr(),
        oim.data_ptr(), partial.data_ptr(), sums.data_ptr(), R * C, p.grid,
        int(p.vec), _build.stream(re.device))
    _build.check(code, "bandpass_filter")
    bandpass_filter.launches += 1
    return ore, oim, sums[0], sums[1]


bandpass_filter.launches = 0
