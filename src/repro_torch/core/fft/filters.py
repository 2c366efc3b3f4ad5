"""Spectral-domain filters — the paper's bandpass stage (§2.3)
(counterpart of ``repro/core/fft/filters.py``).

Masks keep all but the lowest ``keep_frac`` of frequencies; in the
unshifted FFT layout the low frequencies sit at the corners of the 2-D
spectrum. The index math is numpy, as in the reference, so both
packages build the same masks bit for bit; the masks come back as
``torch.bool`` tensors on the CPU, and callers move them to their
device. The digit-permuted masks (``permute_mask_first_axis``,
``mask_fourstep_1d``, ``mask_pencil_tf_3d``) gather a natural-order mask
through ``distributed.fourstep_freq_of_position``. The r2c half-spectrum
masks (``halfspec_mask``, ``mask_r2c``, ``mask_pencil_tf_3d_r2c``) slice
the last axis to the non-negative bins and zero-pad it to the schedule's
half extent (``rfft.spectral_half_extent``); the last composes both, for
the digit-permuted half-spectrum of the r2c transpose-free pencil.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fft.distributed import fourstep_freq_of_position


def freq_index(n: int):
    """|k| per position in unshifted FFT order: 0,1,…,n/2,…,2,1."""
    k = np.arange(n)
    return np.minimum(k, n - k)


def _box(shape: Sequence[int], keep_axis) -> np.ndarray:
    """AND over axes of the per-axis keep vectors ``keep_axis(n)``."""
    shape = tuple(shape)
    out = np.ones(shape, bool)
    for ax, n in enumerate(shape):
        view = [None] * len(shape)
        view[ax] = slice(None)
        out &= keep_axis(n)[tuple(view)]
    return out


def lowpass_mask(shape: Sequence[int], keep_frac: float) -> torch.Tensor:
    """Keep frequencies with normalized radius ≤ keep_frac (product of
    per-axis cutoffs, the paper's corner-box criterion)."""
    return torch.from_numpy(_box(
        shape, lambda n: freq_index(n) < max(1, int(round(n * keep_frac)))))


def twothirds_mask(shape: Sequence[int]) -> torch.Tensor:
    """Orszag 2/3-rule dealiasing mask: keep |k| < n/3 per axis."""
    return torch.from_numpy(_box(shape, lambda n: freq_index(n) * 3 < n))


def highpass_mask(shape: Sequence[int], cut_frac: float) -> torch.Tensor:
    return torch.logical_not(lowpass_mask(shape, cut_frac))


def bandpass_mask(shape: Sequence[int], low_frac: float,
                  high_frac: float) -> torch.Tensor:
    """Keep low_frac ≤ |k|/n < high_frac per axis (box annulus)."""
    return torch.logical_and(lowpass_mask(shape, high_frac),
                             torch.logical_not(lowpass_mask(shape, low_frac)))


def radial_lowpass_mask(shape: Sequence[int], keep_frac: float
                        ) -> torch.Tensor:
    """Spherical cutoff on normalized radius (smoother than the box)."""
    grids = np.meshgrid(*[freq_index(n) / n for n in shape], indexing="ij")
    r = np.sqrt(sum(g * g for g in grids))
    return torch.from_numpy(r <= keep_frac)


def apply_filter(re, im, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    m = mask.to(device=re.device, dtype=re.dtype)
    return re * m, im * m


def mask_transposed_2d(n0: int, n1: int, build=lowpass_mask, **kw):
    """Mask for the slab forward output Y[k0, k1]: the slab transform
    keeps natural frequency order (only the sharding is transposed), so
    this is ``build((n0, n1))``."""
    return build((n0, n1), **kw)


def halfspec_mask(full_mask, hp: int) -> torch.Tensor:
    """Scatter a full-spectrum mask into the r2c half layout: the last
    axis sliced to the non-negative bins (``N/2+1``) and zero-padded to
    the extent ``hp``."""
    m = torch.as_tensor(full_mask)
    h = m.shape[-1] // 2 + 1
    out = m.new_zeros(m.shape[:-1] + (hp,))
    out[..., :h] = m[..., :h]
    return out


def permute_mask_first_axis(mask, p: int) -> torch.Tensor:
    """Gather a natural-order spectral mask into the four-step digit
    order along its FIRST axis (the layout of ``fourstep_fft_1d`` output
    and of axis 0 of the transpose-free pencil output): position g'
    keeps what the natural mask says about bin
    ``fourstep_freq_of_position[g']``."""
    base = np.asarray(mask)
    return torch.from_numpy(
        np.ascontiguousarray(base[fourstep_freq_of_position(base.shape[0],
                                                            p)]))


def mask_fourstep_1d(n: int, p: int, build=lowpass_mask, **kw):
    """Mask permuted into the four-step transposed digit order."""
    return permute_mask_first_axis(build((n,), **kw), p)


def mask_pencil_tf_3d(shape: Sequence[int], p0: int, build=lowpass_mask,
                      **kw):
    """Mask for the transpose-free pencil output layout: axis 0 in
    four-step digit order over the ``p0``-way mesh axis (axes 1, 2
    natural)."""
    return permute_mask_first_axis(build(tuple(shape), **kw), p0)


def mask_r2c(shape: Sequence[int], hp: int = None, build=lowpass_mask,
             **kw):
    """Natural-order half-spectrum mask for the r2c slab, slab3d, pencil
    and pencil2d outputs (natural frequency order on every axis; only
    the last axis is cut to N/2+1 and padded to ``hp``, by default the
    unpadded half extent)."""
    shape = tuple(shape)
    hp = shape[-1] // 2 + 1 if hp is None else hp
    return halfspec_mask(build(shape, **kw), hp)


def mask_pencil_tf_3d_r2c(shape: Sequence[int], p0: int, hp: int = None,
                          build=lowpass_mask, **kw):
    """Mask for the transpose-free pencil r2c output: axis 0 in four-step
    digit order over the ``p0``-way mesh axis AND the last axis in the
    padded half layout (different axes, so the two compose)."""
    shape = tuple(shape)
    hp = shape[-1] // 2 + 1 if hp is None else hp
    return halfspec_mask(mask_pencil_tf_3d(shape, p0, build, **kw), hp)
