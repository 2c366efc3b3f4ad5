"""Batched radix-2 Stockham FFT: the CUDA kernel ``csrc/fft_stockham.cu``
(port of the Pallas kernel ``repro/kernels/fft_stockham.py``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it computes the plain version, ``dft.stockham_fft``.
``fft_stockham.launches`` counts kernel launches.
"""
from __future__ import annotations

from repro_torch.core.fft.dft import stockham_fft
from repro_torch.kernels import _build


def fft_stockham(re, im, *, inverse: bool = False, block_b: int = 128):
    """Batched radix-2 FFT along the last axis. re/im: (B, N) float32, N a
    power of two; a CTA takes at most ``block_b`` rows."""
    if re.device.type == "cpu" and im.device.type == "cpu":
        return stockham_fft(re, im, inverse=inverse)
    _build.check_planes("fft_stockham", re, im)
    B, N = re.shape
    if N & (N - 1):
        raise ValueError(f"fft_stockham: N must be a power of two, got {N}")
    fit = (_build.SMEM_MAX - 4 * N) // (16 * N)
    if fit < 1:
        raise ValueError(f"fft_stockham: a row of N={N} does not fit one "
                         f"CTA's shared memory")
    rows = _build.rows_per_cta(block_b, B, fit, re.device)
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    lib = _build.library()
    _build.check(lib.repro_fft_stockham(
        re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), B,
        N.bit_length() - 1, rows, int(inverse), _build.stream(re.device)),
        "fft_stockham")
    fft_stockham.launches += 1
    return ore, oim


fft_stockham.launches = 0
