"""Dispatch to the CUDA kernels (counterpart of ``repro/kernels/ops.py``).

Same kernel rule and row-block halving as the reference: Stockham for a
power-of-two N < 256, four-step otherwise. ``fft`` takes (B, N) rows and
makes its inputs contiguous, so callers may pass strided views;
``fft_axis`` transforms any axis of a contiguous tensor in place of the
reference's moveaxis + ``fft``, through the kernels' column route, and
returns the same layout. The kernel wrappers take their plain PyTorch
versions only for CPU tensors; on a CUDA tensor they launch the kernel
or raise.
"""
from __future__ import annotations

import math

from repro_torch.kernels.bandpass import bandpass_filter
from repro_torch.kernels.fft_fourstep import (fft_fourstep,
                                              fft_fourstep_columns)
from repro_torch.kernels.fft_stockham import (fft_stockham,
                                              fft_stockham_columns)


def _use_stockham(n: int, kernel: str) -> bool:
    if kernel == "auto":
        return n & (n - 1) == 0 and n < 256
    return kernel == "stockham"


def _block(b: int, block_b: int) -> int:
    bb = block_b
    while b % bb:
        bb //= 2
    return max(bb, 1)


def fft(re, im, *, inverse: bool = False, block_b: int = 128,
        kernel: str = "auto"):
    """Batched FFT along the last axis, (B, N) split planes."""
    B, N = re.shape
    fn = fft_stockham if _use_stockham(N, kernel) else fft_fourstep
    return fn(re.contiguous(), im.contiguous(), inverse=inverse,
              block_b=_block(B, block_b))


def fft_axis(re, im, axis: int, *, inverse: bool = False):
    """FFT along ``axis`` of split planes, viewed as (outer, N, inner);
    the result has the input's shape and is contiguous."""
    shape = re.shape
    axis %= re.dim()
    N = shape[axis]
    outer = math.prod(shape[:axis])
    inner = math.prod(shape[axis + 1:])
    re, im = re.contiguous(), im.contiguous()
    if inner == 1:
        rr, ii = fft(re.reshape(outer, N), im.reshape(outer, N),
                     inverse=inverse)
    else:
        fn = (fft_stockham_columns if _use_stockham(N, "auto")
              else fft_fourstep_columns)
        rr, ii = fn(re.reshape(outer, N, inner), im.reshape(outer, N, inner),
                    inverse=inverse)
    return rr.reshape(shape), ii.reshape(shape)


def bandpass(re, im, mask, *, block_rows: int = 256):
    R, _ = re.shape
    br = block_rows
    while R % br:
        br //= 2
    return bandpass_filter(re.contiguous(), im.contiguous(),
                           mask.float().contiguous(), block_rows=max(br, 1))
