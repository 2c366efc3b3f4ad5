"""Batched FFT of split f32 planes: the CUDA kernel ``csrc/fft_fourstep.cu``
(port of the Pallas kernel ``repro/kernels/fft_fourstep.py``).

``fft_fourstep`` transforms (B, N) rows along the last axis;
``fft_fourstep_columns`` transforms an (outer, N, inner) tensor along its
middle axis and writes the same layout, with no transposed copy, for
every N. ``fft_plan.route`` picks the route once per N: the radix
Stockham kernels (powers of two to 16384 as rows, 65536 as columns),
mixed radix 2-16/3/5/7 (every other N whose prime factors are <= 7), or
Bluestein (the rest: a power-of-two convolution, with the chirp and its
spectrum made once per N and direction and kept on the device). On a
CUDA tensor each wrapper launches the kernels or raises; on a CPU tensor
it computes the plain version, ``dft.fourstep_fft`` (moved to the last
axis and back for columns). ``fft_fourstep.launches`` counts every
kernel launched, rows and columns alike;
``fft_fourstep.column_launches`` counts the column route's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.fft.dft import fourstep_fft
from repro_torch.kernels import _build, fft_plan

# Bluestein's chirp and the spectrum of its conjugate, per (N, inverse,
# device): made on the device once, by the route's own kernels
_CHIRPS: dict = {}


def _bluestein_tables(n: int, inverse: bool, device):
    key = (n, inverse, device)
    if key not in _CHIRPS:
        m = fft_plan.bluestein_size(n)
        sign = 1.0 if inverse else -1.0
        e = fft_plan.chirp_exponents(n, device).double()
        ang = (sign * math.pi / n) * e
        chirp = torch.stack((torch.cos(ang), torch.sin(ang)), -1).float()
        # conj(chirp) laid out circularly: b[m] = b[M - m] = conj(c[m])
        bre = torch.zeros((1, m), dtype=torch.float32, device=device)
        bim = torch.zeros_like(bre)
        bre[0, :n], bim[0, :n] = chirp[:, 0], -chirp[:, 1]
        bre[0, m - n + 1:] = chirp[1:, 0].flip(0)
        bim[0, m - n + 1:] = -chirp[1:, 1].flip(0)
        sre, sim = fft_fourstep(bre, bim)
        spec = torch.stack((sre[0], sim[0]), -1).contiguous()
        _CHIRPS[key] = (chirp.contiguous(), spec)
    return _CHIRPS[key]


def _launch(re, im, outer: int, n: int, inner: int, inverse: bool,
            columns: bool):
    """Transform (outer, n, inner) planes along the middle axis into new
    planes; returns them and the number of kernels launched."""
    r = fft_plan.route(n, columns)
    lib = _build.library()
    dev = re.device
    ore, oim = re.new_empty(re.shape), im.new_empty(im.shape)
    args = (re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr())
    stream = _build.stream(dev)
    work = (torch.empty(r.work * outer * inner, dtype=torch.float32,
                        device=dev) if r.work else None)
    wptr = None if work is None else work.data_ptr()
    if r.kind == "radix" and not columns:
        code = lib.repro_fft_fourstep(*args, outer, n.bit_length() - 1,
                                      int(inverse), stream)
    elif r.kind == "radix":
        n1 = 1 << ((n.bit_length() - 1) // 2)
        code = lib.repro_fft_fourstep_axis(*args, wptr, outer, n1, n // n1,
                                           inner, int(inverse), stream)
    elif r.kind == "mixed":
        code = lib.repro_fft_mixed(*args, wptr, outer, inner, r.plan,
                                   int(inverse), stream)
    else:
        chirp, spec = _bluestein_tables(n, inverse, dev)
        code = lib.repro_fft_bluestein(
            *args, wptr, outer, n, inner, r.m, r.m_route.plan,
            chirp.data_ptr(), spec.data_ptr(), int(inverse), stream)
    _build.check(code, "fft_fourstep")
    fft_fourstep.launches += r.launches
    return ore, oim, r.launches


def fft_fourstep(re, im, *, inverse: bool = False, block_b: int = 128):
    """Batched FFT along the last axis. re/im: (B, N) float32, any N.
    ``block_b`` is the reference's row-block hint: checked, and the
    result does not depend on it (the kernels size their own CTAs)."""
    if re.device.type == "cpu" and im.device.type == "cpu":
        return fourstep_fft(re, im, inverse=inverse)
    _build.check_planes("fft_fourstep", re, im)
    _build.check_block("fft_fourstep", block_b)
    B, N = re.shape
    ore, oim, _ = _launch(re, im, B, N, 1, inverse, columns=False)
    return ore, oim


def fft_fourstep_columns(re, im, *, inverse: bool = False):
    """FFT along the middle axis of (outer, N, inner) float32 planes, in
    the same layout, any N, with no transposed copy: ``inner == 1`` is
    the row route."""
    if re.device.type == "cpu" and im.device.type == "cpu":
        rr, ii = fourstep_fft(re.movedim(1, -1), im.movedim(1, -1),
                              inverse=inverse)
        return rr.movedim(-1, 1).contiguous(), ii.movedim(-1, 1).contiguous()
    _build.check_planes("fft_fourstep_columns", re, im, ndim=3)
    outer, N, inner = re.shape
    ore, oim, kernels = _launch(re, im, outer, N, inner, inverse,
                                columns=inner > 1)
    fft_fourstep.column_launches += kernels
    return ore, oim


fft_fourstep.launches = 0
fft_fourstep.column_launches = 0
