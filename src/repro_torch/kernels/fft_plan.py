"""Host-side planning of the four-step kernel's routes (``csrc/fft_fourstep.cu``).

Pure integer arithmetic, cached per N, so the wrappers pay for it once:

* ``radix_plan(n)`` — the radix passes of one line of n points (n with
  no prime factor above 7): radix 16/8/4/2 for the power of two, bits
  spread evenly, then one pass for each factor 3, 5 and 7;
* ``stages(n, columns)`` — the line lengths of a mixed-radix transform:
  one line when it fits one CTA's shared memory (rows to
  ``MIXED_ROW_MAX`` points, a tile of 32 columns to ``MIXED_LINE_MAX``),
  else two, three, four or five lines of at most ``MIXED_LINE_MAX``
  points, passes through a scratch buffer;
* ``wide_radix_plan(n)`` — the same with the composite radices 10, 20
  and 25 and radix 16, largest first: rows of ``ROW_WIDE_MIN`` points
  or more, the line passes' wide tiles and the cluster kernel's lines;
* ``takes_row_reg(n)`` — whether a row of n points runs on the row
  register kernel (``mixed_row_reg_kernel``: one shared buffer, two CTAs
  an SM), from ``ROW_REG_MIN`` points;
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
  else on mixed_lines_kernel; else line passes) or ``bluestein`` (the
  rest), with its launch count, scratch size and
  the plan array the C entry points take. Every N >= 1 is planned:
  lengths, line counts and Bluestein's N and M cross the C interface as
  64-bit integers, and a call the card's memory cannot hold fails in
  the allocator;
* ``bluestein_size(n)`` and ``chirp_exponents(n)`` — Bluestein's
  power-of-two length M >= 2N - 1 and the chirp's exponents n^2 mod 2N
  (an int64 tensor, made where the chirp is).
"""
from __future__ import annotations

import ctypes
import functools
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


def _divisors(n: int):
    """The divisors of a 7-smooth n, ascending."""
    divs = [1]
    for p in (2, 3, 5, 7):
        e = 0
        while n % p == 0:
            n //= p
            e += 1
        divs = [d * p ** i for d in divs for i in range(e + 1)]
    return sorted(divs)


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


@functools.lru_cache(maxsize=None)
def stages(n: int, columns: bool) -> Tuple[int, ...]:
    """Line lengths of a mixed-radix transform of n points, first pass
    first: one line if it fits a CTA, else the most balanced split (the
    largest least factor, the first found on a tie) into two, or else
    three, four or five, lines of at most ``MIXED_LINE_MAX`` points."""
    if not smooth7(n):
        raise ValueError(f"stages: {n} has a prime factor above 7")
    if n <= (MIXED_LINE_MAX if columns else MIXED_ROW_MAX):
        return (n,)
    for k in range(2, MAX_STAGES + 1):
        best = None
        for lines in _splits(n, k, MIXED_LINE_MAX):
            if best is None or min(lines) > min(best):
                best = lines
        if best:
            return best
    raise ValueError(f"stages: {n} needs more than {MAX_STAGES} passes "
                     f"of <= {MIXED_LINE_MAX} points")


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


def bluestein_size(n: int) -> int:
    """The least power of two M >= 2n - 1."""
    return 1 << max(0, (2 * n - 2).bit_length())


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
        # passes or more keep their tiles (Bluestein's 32768-point rows
        # and the 2^20 rows lost there)
        lines = stages(n, columns)
        wide = columns and len(lines) == 2
        return Route("mixed", n, lines, plan_array(lines, columns, wide), 0,
                     None, len(lines), 2 * n if len(lines) > 1 else 0,
                     row_reg=not columns and lines == (n,)
                     and takes_row_reg(n))
    m = bluestein_size(n)
    inner = route(m, columns)    # a power of two: never the cluster kernel
    return Route("bluestein", n, (), None, m, inner, 3 + 2 * inner.launches,
                 4 * m)
