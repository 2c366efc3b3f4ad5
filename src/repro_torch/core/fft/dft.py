"""Local (single-shard) FFT backends on split re/im planes
(counterpart of ``repro/core/fft/dft.py``).

The reference carries (re, im) float pairs because Pallas on the TPU
has no complex dtype; the port keeps the same pairs so every stage and
kernel takes the same arrays as its reference. Two formulations:

* ``fourstep_fft`` — Bailey's four-step: a size-N FFT as N₁×N₁ and
  N₂×N₂ DFT-matrix matmuls around a twiddle multiply (N = N₁·N₂). It is
  the plain version of the ``fft_fourstep`` CUDA kernel.
* ``stockham_fft`` — iterative radix-2 Stockham autosort (no bit
  reversal), the plain version of the ``fft_stockham`` CUDA kernel.

Angles are taken in float32 exactly as the reference takes them
(``dft.py:44-55``), so these functions repeat its rounding.
``local_fft`` dispatches between them, the kernels (``"pallas"``) and
``torch.fft`` (``"jnp"``). ``"auto"`` takes the kernels for a CUDA
tensor and the plain versions for a CPU one, so a plan on the card runs
no plain stage unless its caller names one. All functions operate along
the LAST axis; callers move axes, except ``fft_along`` with the kernels
on a CUDA tensor, which hands the axis to the kernels' column route.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]

BACKENDS = ("auto", "fourstep", "stockham", "jnp", "pallas")


def to_pair(x, device=None) -> Pair:
    x = torch.as_tensor(x, device=device)
    if x.is_complex():
        return x.real.float().contiguous(), x.imag.float().contiguous()
    x = x.float()
    return x, torch.zeros_like(x)


def to_complex(p: Pair):
    return torch.complex(p[0], p[1])


# ---------------------------------------------------------------------------
# DFT matrices / twiddles
# ---------------------------------------------------------------------------

def dft_matrix(n: int, sign: float, device=None) -> Pair:
    k = torch.arange(n, dtype=torch.float32, device=device)
    ang = sign * 2.0 * math.pi * torch.outer(k, k) / n
    return torch.cos(ang), torch.sin(ang)


def twiddle(n1: int, n2: int, sign: float, device=None) -> Pair:
    """exp(sign·2πi·j·k/(n1·n2)) for j<n1, k<n2."""
    j = torch.arange(n1, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(n2, dtype=torch.float32, device=device)[None, :]
    ang = sign * 2.0 * math.pi * j * k / (n1 * n2)
    return torch.cos(ang), torch.sin(ang)


def cmul(ar, ai, br, bi) -> Pair:
    return ar * br - ai * bi, ar * bi + ai * br


def cmatmul(ar, ai, br, bi) -> Pair:
    """(...,m,k) complex @ (k,n) complex via four real matmuls."""
    rr = ar @ br
    ii = ai @ bi
    ri = ar @ bi
    ir = ai @ br
    return rr - ii, ri + ir


# ---------------------------------------------------------------------------
# Four-step (Bailey) FFT
# ---------------------------------------------------------------------------

def split_factor(n: int) -> Tuple[int, int]:
    """n = n1·n2 with n1 ≤ n2, both as close to √n as possible."""
    n1 = 1 << (int(math.log2(n)) // 2) if n & (n - 1) == 0 else 1
    if n1 == 1:  # non power of two: greedy factor near sqrt
        f = int(math.sqrt(n))
        while n % f:
            f -= 1
        n1 = f
    return n1, n // n1


def fourstep_fft(re, im, *, inverse: bool = False) -> Pair:
    """FFT along the last axis via the four-step algorithm.

    view x as (n2, n1) [row-major  x[k] = X[k // n1, k % n1]]:
      1. FFT over the n2 axis (DFT matmul)
      2. twiddle multiply
      3. FFT over the n1 axis (DFT matmul)
      4. transpose (n2, n1) -> (n1, n2) and flatten
    """
    n = re.shape[-1]
    n1, n2 = split_factor(n)
    sign = 1.0 if inverse else -1.0
    batch = re.shape[:-1]
    dev = re.device

    xr = re.reshape(*batch, n2, n1).transpose(-1, -2)     # (..., n1, n2)
    xi = im.reshape(*batch, n2, n1).transpose(-1, -2)
    w2r, w2i = dft_matrix(n2, sign, dev)
    xr, xi = cmatmul(xr, xi, w2r, w2i)                    # (..., n1, n2)

    tr, ti = twiddle(n1, n2, sign, dev)
    xr, xi = cmul(xr, xi, tr, ti)

    xr = xr.transpose(-1, -2)                             # (..., n2, n1)
    xi = xi.transpose(-1, -2)
    w1r, w1i = dft_matrix(n1, sign, dev)
    xr, xi = cmatmul(xr, xi, w1r, w1i)

    # output index is k1·n2 + k2 -> transpose then flatten
    out_r = xr.transpose(-1, -2).reshape(*batch, n)
    out_i = xi.transpose(-1, -2).reshape(*batch, n)
    if inverse:
        out_r = out_r / n
        out_i = out_i / n
    return out_r, out_i


# ---------------------------------------------------------------------------
# Stockham radix-2 (autosort, ping-pong buffers)
# ---------------------------------------------------------------------------

def stockham_fft(re, im, *, inverse: bool = False) -> Pair:
    """Radix-2 Stockham FFT along the last axis (N a power of two)."""
    n = re.shape[-1]
    if n & (n - 1):
        raise ValueError(f"stockham needs a power of two, got {n}")
    stages = int(math.log2(n))
    sign = 1.0 if inverse else -1.0
    batch = re.shape[:-1]

    xr, xi = re.float(), im.float()
    for s in range(stages):
        l = 1 << s              # combined block size so far
        m = n >> (s + 1)        # butterflies per block pair
        # view (..., 2, m, l): columns already sorted by Stockham
        ar = xr.reshape(*batch, 2, m, l)
        ai = xi.reshape(*batch, 2, m, l)
        x0r, x1r = ar[..., 0, :, :], ar[..., 1, :, :]
        x0i, x1i = ai[..., 0, :, :], ai[..., 1, :, :]
        ang = sign * 2.0 * math.pi * (
            torch.arange(l, dtype=torch.float32, device=re.device)
            * (n // (2 * l))) / n
        wr, wi = torch.cos(ang), torch.sin(ang)          # (l,)
        t1r, t1i = cmul(x1r, x1i, wr, wi)
        xr = torch.cat([x0r + t1r, x0r - t1r], dim=-1).reshape(*batch, n)
        xi = torch.cat([x0i + t1i, x0i - t1i], dim=-1).reshape(*batch, n)
    if inverse:
        xr, xi = xr / n, xi / n
    return xr, xi


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def local_fft(re, im, *, inverse: bool = False, backend: str = "auto"
              ) -> Pair:
    """FFT along the last axis.
    backend: auto | fourstep | stockham | jnp (torch.fft) | pallas (the
    hand-written CUDA kernels through ``kernels.ops``); auto is pallas
    on a CUDA tensor."""
    n = re.shape[-1]
    if backend == "auto":
        backend = "pallas" if re.is_cuda else "fourstep" if n >= 64 \
            else "stockham" if n & (n - 1) == 0 else "fourstep"
    if backend == "pallas":
        from repro_torch.kernels import ops as kops
        shape = re.shape
        rr, ii = kops.fft(re.reshape(-1, n), im.reshape(-1, n),
                          inverse=inverse)
        return rr.reshape(shape), ii.reshape(shape)
    if backend == "jnp":
        fn = torch.fft.ifft if inverse else torch.fft.fft
        out = fn(to_complex((re.float(), im.float())), dim=-1)
        return out.real.float(), out.imag.float()
    if backend == "stockham":
        return stockham_fft(re, im, inverse=inverse)
    if backend == "fourstep":
        return fourstep_fft(re, im, inverse=inverse)
    raise ValueError(backend)


def fft_along(re, im, axis: int, **kw) -> Pair:
    """FFT along ``axis``. The kernels on a CUDA tensor (pallas or auto)
    transform the axis where it lies (``kernels.ops.fft_axis``), so the
    output is contiguous and no transposed copy is made; everything else
    moves the axis last and back, as the reference does."""
    if kw.get("backend", "auto") in ("pallas", "auto") and re.is_cuda:
        from repro_torch.kernels import ops as kops
        return kops.fft_axis(re, im, axis,
                             inverse=kw.get("inverse", False))
    re = torch.movedim(re, axis, -1)
    im = torch.movedim(im, axis, -1)
    rr, ii = local_fft(re, im, **kw)
    return torch.movedim(rr, -1, axis), torch.movedim(ii, -1, axis)
