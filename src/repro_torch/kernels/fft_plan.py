"""Host-side planning of the four-step kernel's routes (``csrc/fft_fourstep.cu``).

Pure integer arithmetic, cached per N, so the wrappers pay for it once:

* ``radix_plan(n)`` — the radix passes of one line of n points (n with
  no prime factor above 7): radix 16/8/4/2 for the power of two, bits
  spread evenly, then one pass for each factor 3, 5 and 7;
* ``stages(n, columns)`` — the line lengths of a mixed-radix transform:
  one line when it fits one CTA's shared memory (rows to
  ``MIXED_ROW_MAX`` points, a tile of 32 columns to ``MIXED_LINE_MAX``),
  else two or three lines of at most ``MIXED_LINE_MAX`` points, passes
  through a scratch buffer;
* ``route(n, columns)`` — which route takes N: ``radix`` (powers of two
  to 16384 as rows, 65536 as columns), ``mixed`` (every other N whose
  prime factors are <= 7) or ``bluestein`` (the rest), with its launch
  count, scratch size and the plan array the C entry points take;
* ``bluestein_size(n)`` and ``chirp_exponents(n)`` — Bluestein's
  power-of-two length M >= 2N - 1 and the chirp's exponents n^2 mod 2N.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

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
MAX_STAGES = 3
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
    return [d for d in range(1, math.isqrt(n) + 1) if n % d == 0] + \
        [n // d for d in range(math.isqrt(n), 0, -1) if n % d == 0]


@functools.lru_cache(maxsize=None)
def stages(n: int, columns: bool) -> Tuple[int, ...]:
    """Line lengths of a mixed-radix transform of n points, first pass
    first: one line if it fits a CTA, else the most balanced split into
    two, or else three, lines of at most ``MIXED_LINE_MAX`` points."""
    if not smooth7(n):
        raise ValueError(f"stages: {n} has a prime factor above 7")
    if n <= (MIXED_LINE_MAX if columns else MIXED_ROW_MAX):
        return (n,)
    cap = MIXED_LINE_MAX
    best = None
    for d in _divisors(n):
        if d <= cap and n // d <= cap:
            key = min(d, n // d)
            if best is None or key > best[0]:
                best = (key, (n // d, d))
    if best:
        return best[1]
    for d1 in _divisors(n):
        if d1 > cap:
            continue
        for d2 in _divisors(n // d1):
            d3 = n // d1 // d2
            if d2 <= cap and d3 <= cap:
                key = min(d1, d2, d3)
                if best is None or key > best[0]:
                    best = (key, (d3, d2, d1))
    if best is None:
        raise ValueError(f"stages: {n} needs more than {MAX_STAGES} passes "
                         f"of <= {cap} points")
    return best[1]


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


def plan_array(lines: Tuple[int, ...], columns: bool):
    """The C entry points' plan: [k, n_0, P_0, E_0, radices..., n_1, ...].
    A single row stage runs on a row kernel, every other stage on tiles
    of lines; E_s > 0 puts stage s on the register kernel, its radices
    all dividing E_s; each kernel has its own largest radix."""
    rows = len(lines) == 1 and not columns
    flat = [len(lines)]
    for n in lines:
        e = reg_points(n, rows)
        if e:
            cap = e & -e            # 4: the powers of two dividing 20
        else:
            cap = ROW_MAX_RADIX if rows else LANE_MAX_RADIX
        rad = radix_plan(n, cap)
        flat += [n, len(rad), e, *rad]
    return (ctypes.c_int * len(flat))(*flat)


def bluestein_size(n: int) -> int:
    """The least power of two M >= 2n - 1."""
    return 1 << max(0, (2 * n - 2).bit_length())


def chirp_exponents(n: int):
    """k^2 mod 2n for k < n, as exact Python ints (the kernel's chirp is
    exp(sign*pi*i*e/n) of these)."""
    return [(k * k) % (2 * n) for k in range(n)]


class Route(NamedTuple):
    kind: str                       # "radix", "mixed" or "bluestein"
    n: int
    lines: Tuple[int, ...]          # mixed: stage lengths
    plan: Optional[object]          # mixed: the ctypes plan array
    m: int                          # bluestein: M
    m_route: Optional["Route"]      # bluestein: the M-point route
    launches: int                   # kernels one call launches
    work: int                       # scratch floats per (outer * inner)


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
    if smooth7(n):
        lines = stages(n, columns)
        return Route("mixed", n, lines, plan_array(lines, columns), 0, None,
                     len(lines), 2 * n if len(lines) > 1 else 0)
    m = bluestein_size(n)
    inner = route(m, columns)
    return Route("bluestein", n, (), None, m, inner, 3 + 2 * inner.launches,
                 4 * m)
