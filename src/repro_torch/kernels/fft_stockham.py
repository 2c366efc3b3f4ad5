"""Batched Stockham FFT of split f32 planes, power-of-two N: the CUDA
kernel ``csrc/fft_stockham.cu`` (port of the Pallas kernel
``repro/kernels/fft_stockham.py``).

``fft_stockham`` transforms (B, N) rows along the last axis (N <= 16384);
``fft_stockham_columns`` transforms an (outer, N, inner) tensor along its
middle axis in the same layout (N <= 256). On a CUDA tensor each wrapper
launches the kernel or raises; on a CPU tensor it computes the plain
version, ``dft.stockham_fft`` (moved to the last axis and back for
columns). ``fft_stockham.launches`` counts every kernel launched (one a
call), rows and columns alike; ``fft_stockham.column_launches`` counts
the column route's.
"""
from __future__ import annotations

from repro_torch.core.fft.dft import stockham_fft
from repro_torch.kernels import _build

ROW_MAX = 16384
COLUMN_MAX = 256


def _log2(kernel: str, n: int, limit: int) -> int:
    if n & (n - 1):
        raise ValueError(f"{kernel}: N must be a power of two, got {n}")
    if n > limit:
        raise ValueError(f"{kernel}: N={n} is past this route's {limit}")
    return n.bit_length() - 1


def fft_stockham(re, im, *, inverse: bool = False, block_b: int = 128):
    """Batched FFT along the last axis. re/im: (B, N) float32, N a power
    of two. ``block_b`` is the reference's row-block hint: checked and
    unused (for 4 < N <= 256 a row takes N/4 threads, 4 points each, and
    a CTA holds up to 1024/N rows)."""
    if re.device.type == "cpu" and im.device.type == "cpu":
        return stockham_fft(re, im, inverse=inverse)
    _build.check_planes("fft_stockham", re, im)
    _build.check_block("fft_stockham", block_b)
    B, N = re.shape
    log2n = _log2("fft_stockham", N, ROW_MAX)
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    lib = _build.library()
    _build.check(lib.repro_fft_stockham(
        re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), B,
        log2n, int(inverse), _build.stream(re.device)), "fft_stockham")
    fft_stockham.launches += 1
    return ore, oim


def fft_stockham_columns(re, im, *, inverse: bool = False):
    """FFT along the middle axis of (outer, N, inner) float32 planes, N a
    power of two <= 256, in the same layout."""
    if re.device.type == "cpu" and im.device.type == "cpu":
        rr, ii = stockham_fft(re.movedim(1, -1), im.movedim(1, -1),
                              inverse=inverse)
        return rr.movedim(-1, 1).contiguous(), ii.movedim(-1, 1).contiguous()
    _build.check_planes("fft_stockham_columns", re, im, ndim=3)
    outer, N, inner = re.shape
    log2n = _log2("fft_stockham_columns", N, COLUMN_MAX)
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    lib = _build.library()
    _build.check(lib.repro_fft_stockham_axis(
        re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), outer,
        log2n, inner, int(inverse), _build.stream(re.device)),
        "fft_stockham_columns")
    fft_stockham.launches += 1
    fft_stockham.column_launches += 1
    return ore, oim


fft_stockham.launches = 0
fft_stockham.column_launches = 0
