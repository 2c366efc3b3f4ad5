"""Batched FFT of split f32 planes: the CUDA kernel ``csrc/fft_fourstep.cu``
(port of the Pallas kernel ``repro/kernels/fft_fourstep.py``).

``fft_fourstep`` transforms (B, N) rows along the last axis;
``fft_fourstep_columns`` transforms an (outer, N, inner) tensor along its
middle axis and writes the same layout, without a transposed copy for a
power-of-two N up to 65536. On a CUDA tensor each wrapper launches the
kernel or raises; on a CPU tensor it computes the plain version,
``dft.fourstep_fft`` (moved to the last axis and back for columns).
``fft_fourstep.launches`` counts every kernel launched, rows and columns
alike (the global row path launches three, a two-pass column call two);
``fft_fourstep.column_launches`` counts the column route's.
"""
from __future__ import annotations

import torch

from repro_torch.core.fft.dft import fourstep_fft, split_factor
from repro_torch.kernels import _build

# the radix row route holds a row in one CTA's shared memory
RADIX_ROW_MAX = 16384
# the column route: one pass to 256 points, two passes of <= 256 to 65536
COLUMN_ONE_PASS_MAX = 256
COLUMN_MAX = 65536


def _pow2(n: int) -> bool:
    return n & (n - 1) == 0


def fft_fourstep(re, im, *, inverse: bool = False, block_b: int = 128):
    """Batched FFT along the last axis. re/im: (B, N) float32. A power of
    two N <= 16384 takes the radix route, one row per CTA group; another
    N takes the dense-product kernel with at most ``block_b`` rows a CTA,
    or, for a row too long for one CTA's shared memory, the global-memory
    path with a scratch buffer the size of the input."""
    if re.device.type == "cpu" and im.device.type == "cpu":
        return fourstep_fft(re, im, inverse=inverse)
    _build.check_planes("fft_fourstep", re, im)
    _build.check_block("fft_fourstep", block_b)
    B, N = re.shape
    n1, n2 = split_factor(N)
    rows, work, kernels = 1, None, 1
    if not (_pow2(N) and N <= RADIX_ROW_MAX):
        fit = (_build.SMEM_MAX - 8 * (n1 + n2)) // (16 * N)
        if fit >= 1:
            rows = _build.rows_per_cta(block_b, B, fit, re.device)
        else:
            work = torch.empty(2 * (B * N + n1 + n2), dtype=torch.float32,
                               device=re.device)
            kernels = 3         # twiddle tables, step 1, step 3
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    lib = _build.library()
    _build.check(lib.repro_fft_fourstep(
        re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
        None if work is None else work.data_ptr(), B, n1, n2, rows,
        int(inverse), _build.stream(re.device)), "fft_fourstep")
    fft_fourstep.launches += kernels
    return ore, oim


def fft_fourstep_columns(re, im, *, inverse: bool = False):
    """FFT along the middle axis of (outer, N, inner) float32 planes, in
    the same layout. A power-of-two N up to 65536 runs on the column
    kernel (two passes through a scratch buffer above 256); another N is
    moved to the last axis, transformed by ``fft_fourstep`` and moved
    back, by two copies."""
    if re.device.type == "cpu" and im.device.type == "cpu":
        rr, ii = fourstep_fft(re.movedim(1, -1), im.movedim(1, -1),
                              inverse=inverse)
        return rr.movedim(-1, 1).contiguous(), ii.movedim(-1, 1).contiguous()
    _build.check_planes("fft_fourstep_columns", re, im, ndim=3)
    outer, N, inner = re.shape
    if not (_pow2(N) and N <= COLUMN_MAX):
        def rows(t):
            return t.movedim(1, -1).reshape(-1, N).contiguous()
        rr, ii = fft_fourstep(rows(re), rows(im), inverse=inverse)
        return tuple(t.reshape(outer, inner, N).movedim(-1, 1).contiguous()
                     for t in (rr, ii))
    n1, n2 = split_factor(N)
    work, kernels = None, 1
    if N > COLUMN_ONE_PASS_MAX:
        work = torch.empty(2 * re.numel(), dtype=torch.float32,
                           device=re.device)
        kernels = 2
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    lib = _build.library()
    _build.check(lib.repro_fft_fourstep_axis(
        re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
        None if work is None else work.data_ptr(), outer, n1, n2, inner,
        int(inverse), _build.stream(re.device)), "fft_fourstep_columns")
    fft_fourstep.launches += kernels
    fft_fourstep.column_launches += kernels
    return ore, oim


fft_fourstep.launches = 0
fft_fourstep.column_launches = 0
