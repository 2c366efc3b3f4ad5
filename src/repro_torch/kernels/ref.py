"""``torch.fft`` oracles for the FFT and bandpass kernels (counterpart
of ``repro/kernels/ref.py``; the flash-attention oracle comes with the
LM substrate)."""
from __future__ import annotations

import torch


def fft_ref(re, im, *, inverse: bool = False):
    """Batched FFT along the last axis on split planes via torch.fft."""
    x = torch.complex(re.float(), im.float())
    out = torch.fft.ifft(x, dim=-1) if inverse else torch.fft.fft(x, dim=-1)
    return out.real.float().contiguous(), out.imag.float().contiguous()


def bandpass_ref(re, im, mask):
    """Masked planes plus kept/total energy; the plain version of the
    bandpass kernel."""
    m = mask.float()
    p = re.float() ** 2 + im.float() ** 2
    return re * m, im * m, torch.sum(p * m), torch.sum(p)
