"""Dispatch to the CUDA kernels (counterpart of ``repro/kernels/ops.py``).

Same kernel rule and row-block halving as the reference. Inputs are made
contiguous here, so callers may pass the strided views that axis moves
leave. The kernel wrappers take their plain PyTorch versions only for
CPU tensors; on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

from repro_torch.kernels.bandpass import bandpass_filter
from repro_torch.kernels.fft_fourstep import fft_fourstep
from repro_torch.kernels.fft_stockham import fft_stockham


def fft(re, im, *, inverse: bool = False, block_b: int = 128,
        kernel: str = "auto"):
    """Batched FFT along the last axis, (B, N) split planes."""
    B, N = re.shape
    bb = block_b
    while B % bb:
        bb //= 2
    bb = max(bb, 1)
    if kernel == "auto":
        pow2 = N & (N - 1) == 0
        kernel = "stockham" if (pow2 and N < 256) else "fourstep"
    fn = fft_stockham if kernel == "stockham" else fft_fourstep
    return fn(re.contiguous(), im.contiguous(), inverse=inverse,
              block_b=bb)


def bandpass(re, im, mask, *, block_rows: int = 256):
    R, _ = re.shape
    br = block_rows
    while R % br:
        br //= 2
    return bandpass_filter(re.contiguous(), im.contiguous(),
                           mask.float().contiguous(), block_rows=max(br, 1))
