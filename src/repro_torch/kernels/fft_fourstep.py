"""Batched four-step (Bailey) FFT: the CUDA kernel ``csrc/fft_fourstep.cu``
(port of the Pallas kernel ``repro/kernels/fft_fourstep.py``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it computes the plain version, ``dft.fourstep_fft``.
``fft_fourstep.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.fft.dft import fourstep_fft, split_factor
from repro_torch.kernels import _build


def fft_fourstep(re, im, *, inverse: bool = False, block_b: int = 128):
    """Batched FFT along the last axis. re/im: (B, N) float32; a CTA
    takes at most ``block_b`` rows. A row too long for one CTA's shared
    memory runs on the kernel's global-memory path, with a scratch
    buffer the size of the input."""
    if re.device.type == "cpu" and im.device.type == "cpu":
        return fourstep_fft(re, im, inverse=inverse)
    _build.check_planes("fft_fourstep", re, im)
    B, N = re.shape
    n1, n2 = split_factor(N)
    fit = (_build.SMEM_MAX - 8 * (n1 + n2)) // (16 * N)
    if fit >= 1:
        rows, work = _build.rows_per_cta(block_b, B, fit, re.device), None
    else:
        rows = 0
        work = torch.empty(2 * (B * N + n1 + n2), dtype=torch.float32,
                           device=re.device)
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    lib = _build.library()
    _build.check(lib.repro_fft_fourstep(
        re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
        None if work is None else work.data_ptr(), B, n1, n2, rows,
        int(inverse), _build.stream(re.device)), "fft_fourstep")
    fft_fourstep.launches += 1
    return ore, oim


fft_fourstep.launches = 0
