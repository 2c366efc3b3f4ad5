"""Spectral analysis payloads for in-situ consumers (counterpart of
``repro/core/fft/spectrum.py``).

The small "science products" an in-situ chain ships out of a running
producer: total and band energies, radially binned power spectra (the
turbulence diagnostic), and the per-tensor spectral summaries of the
training integration. The frequency grids are numpy, as in the
reference; the sums run on the tensors' device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fft.filters import freq_index


def power(re, im) -> torch.Tensor:
    return re.float() ** 2 + im.float() ** 2


def total_energy(re, im) -> torch.Tensor:
    return torch.sum(power(re, im))


def band_energies(re, im, edges=(0.0, 0.01, 0.05, 0.1, 0.25, 0.5)
                  ) -> torch.Tensor:
    """Energy per radial band (normalised |k| edges); (len(edges)-1,)."""
    grids = np.meshgrid(*[freq_index(n) / n for n in re.shape],
                        indexing="ij")
    r = np.sqrt(sum(g * g for g in grids))
    p = power(re, im)
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = torch.from_numpy((r >= lo) & (r < hi)).to(p.device, p.dtype)
        out.append(torch.sum(p * m))
    return torch.stack(out)


def shell_bins(shape: Sequence[int], nbins: int,
               cut: Optional[Sequence[slice]] = None):
    """(|k| shell of each position, the largest |k|) for natural-order
    frequencies over ``shape``; ``cut`` takes one block of the grid
    (``distributed._slices``), so a rank bins its block alone."""
    cut = cut or [slice(None)] * len(shape)
    freqs = [freq_index(n)[sl].astype(np.float64)
             for n, sl in zip(shape, cut)]
    grids = np.meshgrid(*freqs, indexing="ij")
    r = np.sqrt(sum(g ** 2 for g in grids))
    # the largest |k| of the whole grid: every axis at its Nyquist bin
    kmax = math.sqrt(sum(float(n // 2) ** 2 for n in shape))
    bins = np.clip((r / (kmax + 1e-9) * nbins).astype(np.int32), 0,
                   nbins - 1)
    return bins, kmax


def radial_spectrum(re, im, nbins: int = 32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Isotropic 1-D power spectrum E(k): mean power per |k| shell."""
    bins, kmax = shell_bins(re.shape, nbins)
    e, cnt = shell_sums(re, im, bins, nbins)
    centers = torch.linspace(0, float(kmax), nbins, device=re.device)
    return centers, e / torch.clamp(cnt, min=1.0)


def shell_sums(re, im, bins, nbins: int):
    """(power summed per shell, positions per shell), float32."""
    idx = torch.from_numpy(bins.reshape(-1)).long().to(re.device)
    p = power(re, im).reshape(-1)
    e = torch.zeros(nbins, dtype=torch.float32, device=re.device)
    cnt = torch.zeros_like(e)
    e.index_add_(0, idx, p)
    cnt.index_add_(0, idx, torch.ones_like(p))
    return e, cnt


def radial_spectrum_k(re, im, kmag, nbins: int = 32, *, weights=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layout-aware isotropic spectrum: shell-SUMMED (weighted) power,
    binned by a caller-supplied ``|k|`` array in the SAME (possibly
    digit-permuted or padded half-spectrum) layout as ``re``/``im``.
    Hermitian multiplicity and normalisation fold into ``weights`` (zero
    on half-spectrum pad columns)."""
    kmag = np.asarray(kmag, np.float64)
    kmax = float(kmag.max())
    bins = np.clip((kmag / (kmax + 1e-9) * nbins).astype(np.int32), 0,
                   nbins - 1)
    idx = torch.from_numpy(bins.reshape(-1)).long().to(re.device)
    p = power(re, im)
    if weights is not None:
        p = p * torch.as_tensor(weights, device=p.device)
    e = torch.zeros(nbins, dtype=torch.float32, device=re.device)
    e.index_add_(0, idx, p.reshape(-1).float())
    centers = torch.linspace(0, kmax, nbins, device=re.device)
    return centers, e


def tensor_spectrum_summary(x, nbins: int = 16) -> torch.Tensor:
    """In-situ training payload: 1-D FFT along the last axis of a
    (..., N) tensor (gradient row, activation channel, ...), mean power
    per bin over the other axes, binned into ``nbins`` equal spans of
    the half-spectrum: (nbins,)."""
    xf = torch.fft.rfft(x.float(), dim=-1)
    p = (xf.abs() ** 2).mean(dim=tuple(range(x.dim() - 1)))
    n = p.shape[-1]
    edges = torch.arange(nbins + 1, device=x.device) * n // nbins
    idx = torch.searchsorted(edges, torch.arange(n, device=x.device),
                             right=True) - 1
    idx = torch.clamp(idx, 0, nbins - 1)
    e = torch.zeros(nbins, dtype=torch.float32, device=x.device)
    return e.index_add_(0, idx, p.float())
