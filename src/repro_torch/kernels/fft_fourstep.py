"""Batched FFT of split f32 planes: the CUDA kernel ``csrc/fft_fourstep.cu``
(port of the Pallas kernel ``repro/kernels/fft_fourstep.py``).

``fft_fourstep`` transforms (B, N) rows along the last axis;
``fft_fourstep_columns`` transforms an (outer, N, inner) tensor along its
middle axis and writes the same layout, with no transposed copy, for
every N. ``fft_plan.route`` picks the route once per N: the radix
Stockham kernels (powers of two to 16384 as rows, 65536 as columns),
mixed radix 2-16/3/5/7 (every other N whose prime factors are <= 7: a
row in one CTA, from 4096 points on the row register kernel; longer rows
in passes of the tile register kernel; columns in one pass on a
thread-block cluster where one cluster holds the tile; else line
passes), or Bluestein (the rest: a convolution of 7-smooth length M on
the tile register kernel with the chirps fused into its first load and
last stores from ``fft_plan.BLUESTEIN_TILE_MIN`` on, of power-of-two M
with three pointwise kernels below it; the chirp and its spectrum made
once per N, direction and M and kept on the device that asked, in a
byte-capped LRU cache that
``plan.plan_cache_clear()`` empties: ``CHIRP_CACHE_BYTES``,
``clear_tables``). On a
CUDA tensor each wrapper launches the kernels or raises; on a CPU tensor
it computes the plain version, ``dft.fourstep_fft`` (moved to the last
axis and back for columns). ``fft_fourstep.launches`` counts every
kernel launched, rows and columns alike;
``fft_fourstep.column_launches`` counts the column route's,
``fft_fourstep.cluster_launches`` the cluster kernel's,
``fft_fourstep.row_reg_launches`` the row register kernel's and
``fft_fourstep.tile_launches`` the tile register kernel's.
"""
from __future__ import annotations

import collections
import math
import threading

import torch

from repro_torch.core.fft.dft import fourstep_fft
from repro_torch.kernels import _build, fft_plan

# The byte cap of the Bluestein tables kept on the devices, least recently
# used out first. A direction's tables take 8·(N + M) bytes (the chirp,
# N complex64, and its conjugate's spectrum, M complex64; M about 2N past
# fft_plan.BLUESTEIN_TILE_MIN, below it a power of two of at most 4N):
# both directions of every N to about 2^24 (M <= 2.01·2^25, 400 MiB a
# direction) fit together in 1 GiB, 1.25% of an H100's 80 GB that a
# simulation pays beside its own state; a larger N keeps one direction at
# a time, and a table past the cap (N past about 2^25.4) is made for its
# call and not kept.
CHIRP_CACHE_BYTES = 1 << 30

# Bluestein's chirp and the spectrum of its conjugate, per (N, inverse,
# device, M): made on the device once, by the routes' own kernels
_CHIRPS: "collections.OrderedDict" = collections.OrderedDict()
_CHIRPS_LOCK = threading.Lock()


def table_bytes() -> int:
    """Bytes the cached Bluestein tables hold, over every device."""
    with _CHIRPS_LOCK:
        return sum(t.numel() * t.element_size()
                   for pair in _CHIRPS.values() for t in pair)


def clear_tables() -> None:
    """Drop every cached Bluestein table (``plan.plan_cache_clear``)."""
    with _CHIRPS_LOCK:
        _CHIRPS.clear()


def _keep(key, tables) -> None:
    """Cache ``tables`` under ``key``, evicting the least recently used
    until the cache fits ``CHIRP_CACHE_BYTES``; a table larger than the
    cap alone is not kept."""
    size = sum(t.numel() * t.element_size() for t in tables)
    if size > CHIRP_CACHE_BYTES:
        return
    with _CHIRPS_LOCK:
        held = sum(t.numel() * t.element_size()
                   for pair in _CHIRPS.values() for t in pair)
        while _CHIRPS and held + size > CHIRP_CACHE_BYTES:
            _, old = _CHIRPS.popitem(last=False)
            held -= sum(t.numel() * t.element_size() for t in old)
        _CHIRPS[key] = tables


def _bluestein_tables(n: int, inverse: bool, device, m: int = 0):
    """Bluestein's chirp (N complex) and the spectrum of its conjugate laid
    out circularly over M (the route's, ``fft_plan.bluestein_m`` where
    ``m`` is 0)."""
    m = m or fft_plan.bluestein_m(n)
    key = (n, inverse, torch.device(device), m)
    with _CHIRPS_LOCK:
        hit = _CHIRPS.get(key)
        if hit is not None:
            _CHIRPS.move_to_end(key)
            return hit
    sign = 1.0 if inverse else -1.0
    # the angles in place, and gone before the spectrum's FFT (at N = 2^29
    # they and the exponents are 8 GiB beside its 48)
    ang = fft_plan.chirp_exponents(n, device).double()
    ang *= sign * math.pi / n
    chirp = torch.stack((torch.cos(ang), torch.sin(ang)), -1).float()
    del ang
    # conj(chirp) laid out circularly: b[m] = b[M - m] = conj(c[m])
    bre = torch.zeros((1, m), dtype=torch.float32, device=device)
    bim = torch.zeros_like(bre)
    bre[0, :n], bim[0, :n] = chirp[:, 0], -chirp[:, 1]
    bre[0, m - n + 1:] = chirp[1:, 0].flip(0)
    bim[0, m - n + 1:] = -chirp[1:, 1].flip(0)
    sre, sim = fft_fourstep(bre, bim)
    del bre, bim
    spec = torch.stack((sre[0], sim[0]), -1).contiguous()
    tables = (chirp.contiguous(), spec)
    _keep(key, tables)
    return tables


def _launch(re, im, outer: int, n: int, inner: int, inverse: bool,
            columns: bool):
    """Transform (outer, n, inner) planes along the middle axis into new
    planes; returns them and the number of kernels launched."""
    r = fft_plan.route(n, columns)
    lib = _build.library()
    dev = re.device
    # Bluestein's tables first: making them takes a spectrum's FFT of M
    # points, which should not sit beside this call's scratch
    tables = (_bluestein_tables(n, inverse, dev, r.m)
              if r.kind == "bluestein" else (None, None))
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
    elif r.cluster:
        code = lib.repro_fft_cluster(*args, outer, inner, r.plan,
                                     int(inverse), stream)
    elif r.kind == "mixed" and not r.tile:
        code = lib.repro_fft_mixed(*args, wptr, outer, inner, r.plan,
                                   int(inverse), stream)
    elif r.tile:
        # the tile register kernel's passes: a long row, or Bluestein
        desc, passes = fft_plan.tile_passes(n, columns, outer, inner,
                                            inverse)
        chirp, spec = (None if t is None else t.data_ptr() for t in tables)
        code = lib.repro_fft_tile(*args, wptr, (r.m or n) * outer * inner,
                                  chirp, spec, desc, passes, stream)
    else:
        chirp, spec = tables
        code = lib.repro_fft_bluestein(
            *args, wptr, outer, n, inner, r.m, r.m_route.plan,
            chirp.data_ptr(), spec.data_ptr(), int(inverse), stream)
    _build.check(code, "fft_fourstep")
    fft_fourstep.launches += r.launches
    fft_fourstep.cluster_launches += int(r.cluster)
    fft_fourstep.row_reg_launches += int(r.row_reg)
    fft_fourstep.tile_launches += r.launches if r.tile else 0
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
fft_fourstep.cluster_launches = 0
fft_fourstep.row_reg_launches = 0
fft_fourstep.tile_launches = 0
