"""Host-side planning of the four-step kernel's routes (``csrc/fft_fourstep.cu``).

Pure integer arithmetic, cached per N, so the wrappers pay for it once:

* ``radix_plan(n)`` — the radix passes of one line of n points (n with
  no prime factor above 7): radix 16/8/4/2 for the power of two, bits
  spread evenly, then one pass for each factor 3, 5 and 7;
* ``stages(n, columns)`` — the line lengths of a mixed-radix transform:
  one line when it fits one CTA's shared memory (rows to
  ``MIXED_ROW_MAX`` points, a tile of 32 columns to ``MIXED_LINE_MAX``),
  else, for columns, two to five lines of at most ``MIXED_LINE_MAX``
  points (``line_stages``), and for rows two to five lines that a tile
  of the tile register kernel holds (``tile_stages``: to ~1300 points),
  passes through a scratch buffer;
* ``wide_radix_plan(n)`` — the same with the composite radices 10, 20
  and 25 and radix 16, largest first: rows of ``ROW_WIDE_MIN`` points
  or more, the line passes' wide tiles, the cluster kernel's lines and
  the tile register kernel's;
* ``takes_row_reg(n)`` — whether a row of n points runs on the row
  register kernel (``mixed_row_reg_kernel``: one shared buffer, two CTAs
  an SM), from ``ROW_REG_MIN`` points;
* ``tile_fits(c, n)`` and ``tile_passes(...)`` — the tile register
  kernel (``mixed_tile_reg_kernel``: C lines a tile in one shared buffer,
  the points in registers between passes, two CTAs an SM), which takes
  every pass of a row longer than one CTA holds and every pass of
  Bluestein's M-point transforms, and the descriptor of each of its
  passes that ``repro_fft_tile`` runs;
* ``cluster_geometry(n)`` — the one-pass four-step of a column on a
  thread-block cluster (``mixed_cluster_kernel``): N = na * nj with the
  fewest passes, a tile of C columns spread over the shared memory of S
  CTAs;
* ``route(n, columns)`` — which route takes N: ``radix`` (powers of two
  to 16384 as rows, 65536 as columns), ``mixed`` (every other N whose
  prime factors are <= 7: the cluster kernel for columns of
  ``COLUMN_CLUSTER_MIN`` points or more whose tile a cluster of at most
  ``COLUMN_CLUSTER_CTAS`` CTAs holds; a row to ``MIXED_ROW_MAX`` points
  in one CTA, on the row register kernel where ``takes_row_reg`` says so,
  else on mixed_lines_kernel; longer rows in passes of the tile register
  kernel; longer columns in line passes) or ``bluestein`` (the rest),
  with its launch count, scratch size and the plan array the C entry
  points take. Every N >= 1 is planned: lengths, line counts and
  Bluestein's N and M cross the C interface as 64-bit integers, and a
  call the card's memory cannot hold fails in the allocator;
* ``bluestein_m(n, columns)`` and ``chirp_exponents(n)`` — Bluestein's
  length M >= 2N - 1 and the chirp's exponents n^2 mod 2N (an int64
  tensor, made where the chirp is). From ``BLUESTEIN_TILE_MIN`` on, M is
  ``bluestein_size``'s (7-smooth: of the lengths up to the next power of
  two, those with the fewest passes of the tile register kernel, then
  the fewest radix passes within ``BLUESTEIN_M_SLACK`` of the least) and
  both M-point transforms run on the tile register kernel alone,
  whatever route ``route(M, columns)`` gives M itself (the radix, row,
  cluster and line-pass kernels take no chirp): the pre-chirp and the
  zero pad fused into the forward transform's first load, the product
  with the chirp's spectrum into its last store, the post-chirp and the
  scale into the inverse's last store. Below it M is the least power of
  two, its transforms on ``route(M, columns)`` (or line passes past the
  radix route) between three pointwise kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels._build import SMEM_MAX

RADICES = (16, 8, 4, 2, 3, 5, 7)
# the largest power-of-two radix of the kernel's two instantiations
# (kRowMaxRadix, kLaneMaxRadix in the .cu): one-CTA rows, tiles of lines
ROW_MAX_RADIX = 16
LANE_MAX_RADIX = 8
# the radix routes of fft_common.cuh
RADIX_ROW_MAX = 16384
RADIX_COLUMN_ONE_PASS_MAX = 256
RADIX_COLUMN_MAX = 65536
MAX_STAGES = 5
TW_S = 64           # the kernel's split twiddle table: hi[e / 64] * lo[e % 64]
LINE_TILE = 32      # lines a CTA on the column-like passes


def mixed_smem_bytes(lines: int, n: int) -> int:
    """Shared memory of one mixed_lines_kernel CTA: two buffers of two
    planes (a pad word per 32) and the twiddle tables."""
    plane = lines * n + ((lines * n) >> 5) + 1
    return 16 * plane + 8 * (TW_S + -(-n // TW_S))


def _largest(lines: int) -> int:
    n = 1
    while mixed_smem_bytes(lines, n + 1) <= SMEM_MAX:
        n += 1
    return n


MIXED_ROW_MAX = _largest(1)
MIXED_LINE_MAX = _largest(LINE_TILE)


def is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def smooth7(n: int) -> bool:
    """No prime factor of n is above 7."""
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


@functools.lru_cache(maxsize=None)
def radix_plan(n: int, max_radix: int = ROW_MAX_RADIX) -> Tuple[int, ...]:
    """Radices of the Stockham passes of one n-point line, product n, the
    powers of two at most ``max_radix``."""
    if n < 1 or not smooth7(n):
        raise ValueError(f"radix_plan: {n} has a prime factor above 7")
    bits = (n & -n).bit_length() - 1
    odd = n >> bits
    plan = []
    if bits:
        passes = -(-bits // (max_radix.bit_length() - 1))
        plan = [1 << (bits // passes + (p < bits % passes))
                for p in range(passes)]
    for p in (3, 5, 7):
        while odd % p == 0:
            plan.append(p)
            odd //= p
    return tuple(plan) or (1,)


@functools.lru_cache(maxsize=4096)
def _divisors(n: int):
    """The divisors of a 7-smooth n, ascending."""
    divs = [1]
    for p in (2, 3, 5, 7):
        e = 0
        while n % p == 0:
            n //= p
            e += 1
        divs = [d * p ** i for d in divs for i in range(e + 1)]
    return tuple(sorted(divs))


def _splits(n: int, k: int, cap: int):
    """Every split of n into k factors of at most ``cap``, as (last, ...,
    first) tuples, in the order of k nested loops over ascending
    divisors (the first factor outermost)."""
    if k == 1:
        if n <= cap:
            yield (n,)
        return
    for d in _divisors(n):
        if d <= cap and n // d <= cap ** (k - 1):
            for rest in _splits(n // d, k - 1, cap):
                yield rest + (d,)


# The tile register kernel (mixed_tile_reg_kernel, csrc/fft_tile_reg.cuh):
# a tile of C lines (1, 2, 4 or 8; 8 neighbouring lines are one 32-byte
# sector a point a plane) in one shared buffer, the points in registers
# between passes, each thread holding up to TILE_HOLD[R] butterflies of an
# in-place pass of radix R (the row register kernel's counts), at most
# TILE_THREADS threads (80 registers) and TILE_SMEM_MAX bytes of shared
# memory a CTA, so that two CTAs share an SM and one's loads overlap the
# other's passes. Its lines run on wide_radix_plan's radices; a CTA keeps
# TILE_LINE_BYTES a line of offsets, the line's twiddle tables and the
# buffer. A pass is described to repro_fft_tile by TILE_DESC int64 words
# (tile_passes). A pass takes TILE_LINES neighbouring lines a CTA, or as
# many contiguous rows as a tile holds, fewer where that leaves under
# TILE_CTAS CTAs (two on each of an H100's 132 SMs).
TILE_THREADS = 384
TILE_LINES = 8
TILE_CTAS = 264
TILE_HOLD = {25: 1, 20: 1, 16: 1, 10: 2, 8: 3, 7: 3, 5: 4, 4: 6, 3: 8, 2: 12}
# an SM's 228 KB less the 1 KB the card reserves for each CTA, halved
TILE_SMEM_MAX = (233472 - 2 * 1024) // 2
TILE_LINE_BYTES = 64
TILE_DESC = 48


def tile_smem_bytes(c: int, n: int) -> int:
    """Shared memory of a tile register kernel CTA: the lines' offsets,
    the line's twiddle tables and one buffer of two planes (a pad word
    per 32)."""
    plane = c * n + ((c * n) >> 5) + 1
    return TILE_LINE_BYTES * c + 8 * (TW_S + -(-n // TW_S)) + 8 * plane


def tile_threads(c: int, n: int, fused: bool = False) -> int:
    """Threads of a tile register kernel CTA for a tile of c lines of n
    points: about 8 points a thread for the passes that loop (the first
    and the last), at least each in-place pass's butterflies over what a
    thread holds, whole warps. Bluestein's fused passes stage the tile
    through the buffer and run every radix pass in place."""
    rad = wide_radix_plan(n)
    t = min(TILE_THREADS, -(-c * n // 8))
    for r in (rad if fused else rad[1:-1]):
        t = max(t, -(-(c * (n // r)) // TILE_HOLD[r]))
    return -(-t // 32) * 32


@functools.lru_cache(maxsize=None)
def tile_fits(c: int, n: int, fused: bool = False) -> bool:
    """Whether a tile of c lines of n points (7-smooth, n > 1) fits one
    tile register kernel CTA at two CTAs an SM (``fused``: as one of
    Bluestein's fused passes)."""
    return (n > 1 and smooth7(n) and tile_smem_bytes(c, n) <= TILE_SMEM_MAX
            and tile_threads(c, n, fused) <= TILE_THREADS)


def _largest_tile(c: int) -> int:
    n = 1
    while tile_smem_bytes(c, n + 1) <= TILE_SMEM_MAX:
        n += 1
    return n


# the longest line a tile of TILE_LINES lines could hold (its radices
# decide whether it does: tile_fits)
TILE_LINE_MAX = _largest_tile(TILE_LINES)
# Rows of at least this many points that one CTA does not hold take the
# tile register kernel's passes (on an H100: PERF.md, PR 29); below it,
# and for every column, the line passes of <= MIXED_LINE_MAX points
TILE_ROWS_MIN = 1


def _fit_splits(n: int, k: int, fit):
    """Every split of n into k factors from the ascending tuple ``fit``,
    as (last, ..., first) tuples, in the order of k nested loops over it
    (the first factor outermost), as ``_splits`` orders its own."""
    if k == 1:
        if n in fit:
            yield (n,)
        return
    for d in fit:
        if n % d == 0 and n // d <= fit[-1] ** (k - 1):
            for rest in _fit_splits(n // d, k - 1, fit):
                yield rest + (d,)


@functools.lru_cache(maxsize=4096)
def _tile_split(n: int, k: int, fused: bool = False):
    """The most balanced split of n into k lines that a tile of
    ``TILE_LINES`` lines holds (the largest least factor, the first found
    on a tie; ``fused``: the first and the last as Bluestein's fused
    passes), or None."""
    fit = tuple(d for d in _divisors(n)
                if d <= TILE_LINE_MAX and tile_fits(TILE_LINES, d))
    best = None
    if fit:
        for lines in _fit_splits(n, k, fit):
            if fused and not (tile_fits(TILE_LINES, lines[0], True)
                              and tile_fits(TILE_LINES, lines[-1], True)):
                continue
            if best is None or min(lines) > min(best):
                best = lines
    return best


@functools.lru_cache(maxsize=None)
def tile_stages(n: int, fused: bool = False) -> Tuple[int, ...]:
    """Line lengths of a transform of n points in passes of the tile
    register kernel, first pass first: the most balanced split (the
    largest least factor, the first found on a tie) into two, or else
    three, four or five, lines that a tile of ``TILE_LINES`` lines holds
    (``fused``: the first and the last as Bluestein's fused passes)."""
    if not smooth7(n):
        raise ValueError(f"tile_stages: {n} has a prime factor above 7")
    for k in range(2, MAX_STAGES + 1):
        best = _tile_split(n, k, fused)
        if best:
            return best
    raise ValueError(f"tile_stages: {n} needs more than {MAX_STAGES} "
                     f"passes of the tile register kernel")


@functools.lru_cache(maxsize=None)
def line_stages(n: int) -> Tuple[int, ...]:
    """Line lengths of a transform of n points in line passes, first pass
    first: the most balanced split (the largest least factor, the first
    found on a tie) into two, or else three, four or five, lines of at
    most ``MIXED_LINE_MAX`` points."""
    if not smooth7(n):
        raise ValueError(f"line_stages: {n} has a prime factor above 7")
    for k in range(2, MAX_STAGES + 1):
        best = None
        for lines in _splits(n, k, MIXED_LINE_MAX):
            if best is None or min(lines) > min(best):
                best = lines
        if best:
            return best
    raise ValueError(f"line_stages: {n} needs more than {MAX_STAGES} "
                     f"passes of <= {MIXED_LINE_MAX} points")


def takes_tile(n: int, columns: bool) -> bool:
    """Whether a transform of n points runs in passes of the tile register
    kernel, a rule of N alone: a row of at least ``TILE_ROWS_MIN`` points
    that one CTA does not hold (past ``MIXED_ROW_MAX``, off the radix
    route), 7-smooth."""
    return (not columns and n >= TILE_ROWS_MIN and n > MIXED_ROW_MAX
            and smooth7(n) and not (is_pow2(n) and n <= RADIX_ROW_MAX))


@functools.lru_cache(maxsize=None)
def stages(n: int, columns: bool) -> Tuple[int, ...]:
    """Line lengths of a mixed-radix transform of n points, first pass
    first: one line if it fits a CTA, else ``tile_stages`` for the rows
    that ``takes_tile`` gives the tile register kernel and
    ``line_stages`` for the others."""
    if not smooth7(n):
        raise ValueError(f"stages: {n} has a prime factor above 7")
    if n <= (MIXED_LINE_MAX if columns else MIXED_ROW_MAX):
        return (n,)
    return tile_stages(n) if takes_tile(n, columns) else line_stages(n)


def splits(n: int, columns: bool) -> bool:
    """Whether the mixed-radix route takes n: 7-smooth, in at most
    ``MAX_STAGES`` lines."""
    if not smooth7(n):
        return False
    try:
        stages(n, columns)
    except ValueError:
        return False
    return True


# the register kernel (points in registers, one shared buffer): threads
# a CTA at most, and the points a thread holds (kRegPoints in the .cu)
REG_THREADS = 256
REG_POINTS = 20


def reg_points(n: int, rows: bool) -> int:
    """Points a thread of the register kernel holds for a stage of n
    points, or 0 where it does not take the stage. It takes the lines of
    a tile (not a row stage) with no prime factor but 2 and 5, n a
    multiple of 20 and at least 8 lines of n/20 threads in 256 (radices
    4, 2 and 5, which divide 20)."""
    m = n
    for p in (2, 5):
        while m % p == 0:
            m //= p
    e = REG_POINTS
    ok = not rows and m == 1 and n % e == 0 and 8 * (n // e) <= REG_THREADS
    return e if ok else 0


# a row of at least this many points takes the composite radices
# (``wide_radix_plan``: 10000 in three passes, 25 x 25 x 16, not five);
# shorter rows keep radix_plan's, where the composites ran no faster
ROW_WIDE_MIN = 2048
# The row register kernel (mixed_row_reg_kernel, csrc/fft_row_reg.cu): a
# row a CTA in one shared buffer, two CTAs an SM, the points in registers
# between passes, each thread holding up to ROW_REG_HOLD[R] butterflies of
# an in-place pass of radix R, ROW_REG_THREADS threads a CTA at most; the
# plan names it by E = ROW_REG_E (kRowRegE in the .cu). It takes rows from
# ROW_REG_MIN points: on an H100 it ran 10000^2 in 0.853 ms against 1.087
# for one CTA a row (mixed_lines_kernel, the same radices) and 64 rows of
# 5000 level, but 64 rows of 3000 8% slower (PERF.md).
ROW_REG_MIN = 4096
ROW_REG_THREADS = 448
ROW_REG_HOLD = {25: 1, 20: 1, 16: 1, 10: 2, 8: 3, 7: 3, 5: 4, 4: 6, 3: 8,
                2: 12}
ROW_REG_E = 1


def takes_row_reg(n: int) -> bool:
    """Whether a row stage of n points runs on the row register kernel, a
    rule of N alone: a row of ``ROW_REG_MIN`` points or more in one stage
    (off the radix route), on the composites, whose middle passes (all but
    the first and the last, which loop over their butterflies) each need
    at most ``ROW_REG_THREADS`` threads. The others (13824 = 8 x 8 x 8 x 3
    x 3 x 3 among them: 4608 radix-3 butterflies) keep mixed_lines_kernel,
    one CTA a row."""
    if (n < ROW_REG_MIN or n > MIXED_ROW_MAX or not smooth7(n)
            or (is_pow2(n) and n <= RADIX_ROW_MAX)):
        return False
    rad = wide_radix_plan(n)
    return len(rad) > 1 and all(
        -(-(n // r) // ROW_REG_HOLD[r]) <= ROW_REG_THREADS
        for r in rad[1:-1])


def plan_array(lines: Tuple[int, ...], columns: bool, wide: bool = False):
    """The C entry points' plan: [k, n_0, P_0, E_0, radices..., n_1, ...].
    A single row stage runs on a row kernel (E = ``ROW_REG_E``: the row
    register kernel), every other stage on tiles of lines; E_s =
    ``REG_POINTS`` puts stage s on the tiles' register kernel, its radices
    all dividing E_s; each kernel has its own largest radix, and a row of
    ``ROW_WIDE_MIN`` points or more the composites. ``wide`` puts every
    tile stage on the composites too (E = 0: the tiles' wide
    instantiation, 256 threads)."""
    rows = len(lines) == 1 and not columns
    flat = [len(lines)]
    for n in lines:
        e = 0 if wide else reg_points(n, rows)
        if rows and takes_row_reg(n):
            flat += [n, len(wide_radix_plan(n)), ROW_REG_E,
                     *wide_radix_plan(n)]
            continue
        if e:
            cap = e & -e            # 4: the powers of two dividing 20
        else:
            cap = ROW_MAX_RADIX if rows else LANE_MAX_RADIX
        rad = (wide_radix_plan(n) if wide or (rows and n >= ROW_WIDE_MIN)
               else radix_plan(n, cap))
        flat += [n, len(rad), e, *rad]
    return (ctypes.c_int * len(flat))(*flat)


def _smooth_between(lo: int, hi: int):
    """The 7-smooth numbers in [lo, hi], ascending."""
    out = []
    p2 = 1
    while p2 <= hi:
        p3 = p2
        while p3 <= hi:
            p5 = p3
            while p5 <= hi:
                p7 = p5
                while p7 <= hi:
                    if p7 >= lo:
                        out.append(p7)
                    p7 *= 7
                p5 *= 5
            p3 *= 3
        p2 *= 2
    return sorted(out)


def bluestein_passes(m: int, columns: bool, most: int = MAX_STAGES) -> int:
    """Passes of the tile register kernel in each of Bluestein's M-point
    transforms: one where a tile holds M (rows: one row a tile; columns:
    ``TILE_LINES`` neighbouring columns), else ``tile_stages``' count; 0
    where it takes more than ``most``."""
    if tile_fits(1 if not columns else TILE_LINES, m, True):
        return 1
    for k in range(2, most + 1):
        if _tile_split(m, k, True):
            return k
    return 0


def bluestein_lines(m: int, columns: bool) -> Tuple[int, ...]:
    """The line lengths of Bluestein's M-point transforms on the tile
    register kernel, first pass first."""
    if bluestein_passes(m, columns, 1) == 1:
        return (m,)
    return tile_stages(m, True)


# Of the lengths with the fewest passes, Bluestein takes the one with the
# fewest radix passes in its lines among those at most BLUESTEIN_M_SLACK
# past the least (a pass of the tile register kernel costs more the more
# radix passes its lines take; PERF.md, PR 29)
BLUESTEIN_M_SLACK = 0.01


# Bluestein's N from which its M-point transforms run on the tile register
# kernel with the chirps fused (below it the power-of-two design, which
# ran faster there on an H100: PERF.md, PR 29)
BLUESTEIN_TILE_MIN = 1 << 22


def bluestein_m(n: int, columns: bool = False) -> int:
    """Bluestein's M for n: ``bluestein_size`` from ``BLUESTEIN_TILE_MIN``
    on, else the least power of two >= 2n - 1."""
    if n >= BLUESTEIN_TILE_MIN:
        return bluestein_size(n, columns)
    return 1 << max(0, (2 * n - 2).bit_length())


@functools.lru_cache(maxsize=None)
def bluestein_size(n: int, columns: bool = False) -> int:
    """Bluestein's M >= 2n - 1: of the 7-smooth lengths up to the next
    power of two, those whose transform takes the fewest passes of the
    tile register kernel; of them, up to ``BLUESTEIN_M_SLACK`` past the
    least, the one with the fewest radix passes, the least on a tie (at
    2^24 + 1: 33600000, 2.0 N in three passes, where 2^26 took four)."""
    lo = max(2, 2 * n - 1)
    hi = 1 << (lo - 1).bit_length()
    smooth = _smooth_between(lo, hi)
    best = None
    for m in smooth:
        k = bluestein_passes(m, columns, best[0] - 1 if best else MAX_STAGES)
        if k:
            best = (k, m)
            if k == 1:
                break
    if best is None:
        raise ValueError(f"bluestein_size: no M for {n}")
    k, least = best

    def radix_passes(m):
        return sum(len(wide_radix_plan(d))
                   for d in bluestein_lines(m, columns))
    near = [m for m in smooth
            if least <= m <= least * (1 + BLUESTEIN_M_SLACK)
            and bluestein_passes(m, columns, k) == k]
    return min(near, key=lambda m: (radix_passes(m), m))


def chirp_exponents(n: int, device=None) -> torch.Tensor:
    """k^2 mod 2n for k < n, exact in int64 (k^2 < 2^63 for every n the
    route takes), on ``device``; the kernel's chirp is exp(sign*pi*i*e/n)
    of these."""
    k = torch.arange(n, dtype=torch.int64, device=device)
    return (k * k) % (2 * n)


# The one-pass cluster kernel (mixed_cluster_kernel in the .cu), for
# columns: N = na * nj as a four-step inside a thread-block cluster of S
# CTAs. Rank r holds the nj-lines j in [r*J, (r+1)*J) for the na-point
# transforms, then the k2 in [r*K, (r+1)*K) for the nj-point ones (J =
# ceil(nj/S), K = ceil(na/S)), C = COLUMN_TILE neighbouring columns a tile
# (a 32-byte sector a point a plane). A pass costs about the same whatever
# its radix (on an H100, ~0.28 ms over 10^8 points at radices 4 to 16;
# PERF.md), so the lines take few passes: the composite radices 25
# (5 x 5), 20 (4 x 5) and 10 (2 x 5) and radix 16 in registers, at 256
# threads a CTA (128 registers), and N splits into the two line lengths
# with the fewest passes. Threads a CTA at most, the cluster sizes tried
# (16 is non-portable), and the shared memory a CTA may take so that two
# CTAs share an SM (kClusterThreads etc. in fft_cluster.cu).
CLUSTER_THREADS = 256
CLUSTER_SIZES = (2, 4, 8, 16)
# an SM's 228 KB less the 1 KB the card reserves for each CTA, halved
CLUSTER_SMEM_MAX = (233472 - 2 * 1024) // 2
COLUMN_TILE = 8
# Columns from COLUMN_CLUSTER_MIN points (past one tile of 32 columns'
# 439) take the cluster kernel where their tile needs at most
# COLUMN_CLUSTER_CTAS CTAs (441 to 1680 points): on an H100 it beat the
# two line passes on the wide tiles at 600, 1000 and 1680 points (2 CTAs)
# and lost to them at 2000 and 3000 (4 CTAs), 4000, 5000 and 10000 (8 and
# 16: fewer clusters resident, more of each tile remote); those keep the
# line passes. (Rows shared by a cluster ran 10000^2 in 1.44 ms, slower
# than one CTA a row: rows never take it; PERF.md.)
COLUMN_CLUSTER_MIN = 440
COLUMN_CLUSTER_CTAS = 2


def _twiddle_lg(n: int) -> int:
    """The four-step twiddle's table split: 2^lg and n / 2^lg entries,
    the least lg with 4^lg >= n."""
    lg = 1
    while (1 << (2 * lg)) < n:
        lg += 1
    return lg


def cluster_smem_bytes(s: int, c: int, na: int, nj: int) -> int:
    """Shared memory of one mixed_cluster_kernel CTA: two buffers of two
    planes of the larger step's tile (a pad word per 32), the twiddle
    tables of the na- and nj-point lines, and the four-step twiddle's."""
    q = max(na * -(-nj // s) * c, nj * -(-na // s) * c)
    plane = q + (q >> 5) + 1
    lg = _twiddle_lg(na * nj)
    tables = (2 * TW_S + -(-na // TW_S) + -(-nj // TW_S) + (1 << lg)
              + -(-(na * nj) // (1 << lg)))
    return 16 * plane + 8 * tables


@functools.lru_cache(maxsize=None)
def wide_radix_plan(n: int) -> Tuple[int, ...]:
    """Radices of one cluster line of n points (7-smooth, n > 1), the
    largest first: 25 for each pair of 5s, a lone 5 as 20 or 10 with the
    powers of two where there are any, the powers of two in passes of at
    most 16 (bits spread evenly), then one pass for each 3 and 7."""
    e = {}
    for p in (2, 3, 5, 7):
        e[p] = 0
        while n % p == 0:
            n //= p
            e[p] += 1
    if n != 1:
        raise ValueError("wide_radix_plan: a prime factor above 7")
    plan = [25] * (e[5] // 2)
    bits = e[2]
    if e[5] % 2:
        take = min(bits, 2)
        plan.append(5 << take)
        bits -= take
    if bits:
        passes = -(-bits // 4)
        plan += [1 << (bits // passes + (p < bits % passes))
                 for p in range(passes)]
    return tuple(plan + [3] * e[3] + [7] * e[7])


@functools.lru_cache(maxsize=None)
def cluster_geometry(n: int) -> Optional[Tuple[int, ...]]:
    """(S, C, na, nj) of the cluster kernel for columns of n points, or
    None where no cluster of ``CLUSTER_SIZES`` holds the tile at two CTAs
    an SM. Of the splits n = na * nj whose tile some S holds, each step's
    lines a CTA within its threads, the one with the fewest passes in all;
    on a tie the least S, then the longest run of neighbouring points each
    CTA loads and stores (min(ceil(na/S), ceil(nj/S)) lines a tile)."""
    if n < 4 or not smooth7(n):
        return None
    c = COLUMN_TILE
    best = None
    for nj in _divisors(n):
        na = n // nj
        if min(na, nj) < 2:
            continue
        for s in CLUSTER_SIZES:
            J, K = -(-nj // s), -(-na // s)
            if (cluster_smem_bytes(s, c, na, nj) <= CLUSTER_SMEM_MAX
                    and J * c <= CLUSTER_THREADS
                    and K * c <= CLUSTER_THREADS):
                key = (len(wide_radix_plan(na))
                       + len(wide_radix_plan(nj)), s, -min(J, K))
                if best is None or key < best[0]:
                    best = (key, (s, c, na, nj))
                break
    return best[1] if best else None


def takes_cluster(n: int) -> bool:
    """Whether the cluster kernel takes columns of n points, a rule of N
    alone: 7-smooth, off the radix route, ``COLUMN_CLUSTER_MIN`` points or
    more, and a tile that one cluster of at most ``COLUMN_CLUSTER_CTAS``
    CTAs holds."""
    if is_pow2(n) and n <= RADIX_COLUMN_MAX:
        return False
    geometry = cluster_geometry(n)
    return (geometry is not None
            and n >= max(COLUMN_CLUSTER_MIN, MIXED_LINE_MAX + 1)
            and geometry[0] <= COLUMN_CLUSTER_CTAS)


def cluster_plan_array(n: int):
    """``repro_fft_cluster``'s plan: [S, C, na, P_a, radices..., nj, P_j,
    radices...], the na-point lines first (``wide_radix_plan``)."""
    s, c, na, nj = cluster_geometry(n)
    flat = [s, c]
    for line in (na, nj):
        rad = wide_radix_plan(line)
        flat += [line, len(rad), *rad]
    return (ctypes.c_int * len(flat))(*flat)


class Route(NamedTuple):
    kind: str                       # "radix", "mixed" or "bluestein"
    n: int
    lines: Tuple[int, ...]          # mixed: stage lengths
    plan: Optional[object]          # mixed: the ctypes plan array
    m: int                          # bluestein: M
    m_route: Optional["Route"]      # bluestein: the M-point route
    launches: int                   # kernels one call launches
    work: int                       # scratch floats per (outer * inner)
    cluster: bool = False           # mixed: the one-pass cluster kernel
    row_reg: bool = False           # mixed: the row register kernel
    tile: bool = False              # mixed: the tile register kernel


@functools.lru_cache(maxsize=None)
def route(n: int, columns: bool) -> Route:
    """How the four-step kernel transforms n points: as rows (columns
    False, inner == 1) or along the middle axis of (outer, n, inner)."""
    if n < 1:
        raise ValueError(f"route: N must be positive, got {n}")
    if is_pow2(n) and n <= (RADIX_COLUMN_MAX if columns else RADIX_ROW_MAX):
        two = columns and n > RADIX_COLUMN_ONE_PASS_MAX
        return Route("radix", n, (), None, 0, None, 2 if two else 1,
                     2 * n if two else 0)
    if columns and takes_cluster(n):
        return Route("mixed", n, (n,), cluster_plan_array(n), 0, None, 1, 0,
                     True)
    if splits(n, columns):
        # a column transform in two line passes runs them on the wide
        # tiles (on an H100: 10000 points 1.58 against 1.66 ms, 5000 0.43
        # against 0.52; PERF.md); rows, one-pass columns and three
        # passes or more keep their tiles
        lines = stages(n, columns)
        if len(lines) > 1 and takes_tile(n, columns):
            return Route("mixed", n, lines, None, 0, None, len(lines),
                         2 * n, tile=True)
        wide = columns and len(lines) == 2
        return Route("mixed", n, lines, plan_array(lines, columns, wide), 0,
                     None, len(lines), 2 * n if len(lines) > 1 else 0,
                     row_reg=not columns and lines == (n,)
                     and takes_row_reg(n))
    m = bluestein_m(n, columns)
    if n >= BLUESTEIN_TILE_MIN:
        # Bluestein on the tile register kernel: k lines forward, k back
        lines = bluestein_lines(m, columns)
        inner = Route("mixed", m, lines, None, 0, None, len(lines),
                      2 * m if len(lines) > 1 else 0, tile=True)
        return Route("bluestein", n, (), None, m, inner, 2 * len(lines),
                     4 * m, tile=True)
    # the power-of-two design: M's transforms on the radix route or in
    # line passes of <= MIXED_LINE_MAX points, three pointwise kernels
    if m <= (RADIX_COLUMN_MAX if columns else RADIX_ROW_MAX):
        inner = route(m, columns)
    else:
        lines = line_stages(m)
        inner = Route("mixed", m, lines,
                      plan_array(lines, columns, columns and len(lines) == 2),
                      0, None, len(lines), 2 * m)
    return Route("bluestein", n, (), None, m, inner, 3 + 2 * inner.launches,
                 4 * m)


def _pass_geometry(lines, outer: int, inner: int):
    """Each pass's lines, outer count and strides of a transform of
    prod(lines) points along the middle axis of (outer, N, inner), first
    pass first, as mixed_axis in fft_fourstep.cu lays them out: level i
    transforms the lines[i-1]-point lines; every level but the last
    stores times the four-step twiddle exp(sign*2*pi*i*e/tw_M),
    e = (l / tw_div) * (k*tw_kmul + ol*tw_omul) for output point k of
    line l of outer index (oh, ol) (ol = o % o_split)."""
    k = len(lines)
    n = math.prod(lines)
    out = []
    for i in range(1, k + 1):
        ni = math.prod(lines[:i])
        inner_i = inner * (n // ni)
        g = dict(n=lines[i - 1], o_split=1, in_lo=0, out_lo=0, tw_div=0,
                 tw_m=1, tw_kmul=1, tw_omul=0)
        if i < k:
            g.update(tw_div=inner * (n // math.prod(lines[:i + 1])),
                     tw_m=math.prod(lines[:i + 1]))
        if i == 1 and inner_i == 1:         # one pass of rows
            g.update(lines=outer, outer=1, in_hi=0, out_hi=0, in_ls=n,
                     out_ls=n, in_ps=1, out_ps=1)
        elif i == 1:                        # neighbouring lines
            g.update(lines=inner_i, outer=outer, in_hi=n * inner,
                     out_hi=n * inner, in_ls=1, out_ls=1, in_ps=inner_i,
                     out_ps=inner_i)
        elif inner_i == 1:                  # rows: lines k2 < m
            m = ni // lines[i - 1]
            g.update(lines=m, outer=outer, in_hi=n, out_hi=n,
                     in_ls=lines[i - 1], in_ps=1, out_ls=1, out_ps=m)
        else:                               # lines c of outer (o, k2)
            m = ni // lines[i - 1]
            g.update(lines=inner_i, outer=outer * m, o_split=m,
                     in_hi=n * inner, out_hi=n * inner,
                     in_lo=lines[i - 1] * inner_i, out_lo=inner_i, in_ls=1,
                     out_ls=1, in_ps=inner_i, out_ps=m * inner_i,
                     tw_kmul=m, tw_omul=1)
        out.append(g)
    return out


def tile_lines(g, fused: bool) -> int:
    """Lines a CTA of the tile register kernel takes in a pass: 8
    neighbouring lines, or as many rows of a one-pass row transform as a
    tile holds (8, 4, 2 or 1); half as many, down to one, while the pass
    has fewer than ``TILE_CTAS`` CTAs."""
    c = TILE_LINES
    if g["in_ps"] == 1 and g["out_ps"] == 1:
        while c > 1 and not tile_fits(c, g["n"], fused):
            c //= 2
    while c > 1 and g["outer"] * -(-g["lines"] // c) < TILE_CTAS:
        c //= 2
    return c


@functools.lru_cache(maxsize=256)
def tile_passes(n: int, columns: bool, outer: int, inner: int,
                inverse: bool):
    """``repro_fft_tile``'s descriptor of a call on (outer, n, inner):
    TILE_DESC int64 words a pass (``_DESC_FIELDS`` in order) and the pass
    count. Buffers: 0 the input planes, 1 the output, 2 and 3 the two
    halves of the scratch. A tile route (``Route.tile``) runs its passes
    input -> ... -> output through the output and the scratch; Bluestein
    on the tile register kernel runs the forward M-point transform from
    the input (the pre-chirp and the zero pad fused into its first load,
    the product with the chirp's spectrum into its last store) into the
    scratch, then the inverse into the output (the post-chirp and the
    scale fused into its last store, which writes only positions < N)."""
    r = route(n, columns)
    if r.kind == "bluestein":
        geo = _pass_geometry(r.m_route.lines, outer, inner)
        k = len(geo)

        def inv_dst(i):
            return 1 if i == k - 1 else 3 - i % 2
        fwd = [dict(g, src=2 + (k - i) % 2 if i else 0,
                    dst=2 + (k - 1 - i) % 2, sign=-1, scale=1,
                    fuse_in=int(i == 0), fuse_out=int(i == k - 1))
               for i, g in enumerate(geo)]
        inv = [dict(g, src=inv_dst(i - 1) if i else 2, dst=inv_dst(i),
                    sign=1, scale=r.m * (n if inverse else 1)
                    if i == k - 1 else 1, fuse_in=0,
                    fuse_out=2 * int(i == k - 1))
               for i, g in enumerate(geo)]
        passes = fwd + inv
        for d in passes:
            d.update(bn=n, brow=r.m * inner, binner=inner)
    else:
        geo = _pass_geometry(r.lines, outer, inner)
        k = len(geo)

        def dst(i):
            return 1 if (k - 1 - i) % 2 == 0 else 2
        passes = [dict(g, src=dst(i - 1) if i else 0, dst=dst(i),
                       sign=1 if inverse else -1,
                       scale=n if inverse and i == k - 1 else 1, fuse_in=0,
                       fuse_out=0, bn=0, brow=0, binner=1)
                  for i, g in enumerate(geo)]
    words = []
    for d in passes:
        rad = wide_radix_plan(d["n"])
        fused = bool(d["fuse_in"] or d["fuse_out"])
        c = tile_lines(d, fused)
        d.update(p=len(rad), c=c, threads=tile_threads(c, d["n"], fused),
                 mstep_in=d["in_ps"] // d["binner"],
                 mstep_out=d["out_ps"] // d["binner"])
        row = [d[f] for f in _DESC_FIELDS[:4]] + list(rad) + \
            [0] * (16 - len(rad)) + [d[f] for f in _DESC_FIELDS[4:]]
        words += row + [0] * (TILE_DESC - len(row))
    return (ctypes.c_longlong * len(words))(*words), len(passes)


# repro_fft_tile's descriptor of a pass, in order (the radices, 16 words,
# after the first four)
_DESC_FIELDS = ("src", "dst", "n", "p", "c", "threads", "lines", "o_split",
                "outer", "in_hi", "in_lo", "in_ls", "in_ps", "out_hi",
                "out_lo", "out_ls", "out_ps", "tw_div", "tw_m", "tw_kmul",
                "tw_omul", "sign", "scale", "fuse_in", "fuse_out", "bn",
                "brow", "binner", "mstep_in", "mstep_out")
