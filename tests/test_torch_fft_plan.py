"""The four-step kernel's host-side planning (``kernels/fft_plan.py``):
the radix plans, the routes each N takes, Bluestein's length and chirp,
and plain PyTorch versions of the mixed-radix passes, the multi-pass
split and Bluestein built from those plans, held against ``np.fft`` in
float64 (the kernels' index arithmetic, checked before any card runs
it)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import fft_plan

SMOOTH = [2, 3, 5, 6, 7, 12, 60, 100, 128, 200, 360, 1000, 1536, 3000, 6000,
          3360, 10000, 13824, 20000, 32768, 65536, 1 << 20]


@pytest.mark.parametrize("n", SMOOTH)
def test_radix_plan_multiplies_to_n(n):
    for lines in {(n,), fft_plan.stages(n, False), fft_plan.stages(n, True)}:
        assert math.prod(lines) == n
        for line in lines:
            for cap in (fft_plan.ROW_MAX_RADIX, fft_plan.LANE_MAX_RADIX):
                plan = fft_plan.radix_plan(line, cap)
                assert math.prod(plan) == line
                assert set(plan) <= set(fft_plan.RADICES)
                assert all(p <= cap for p in plan if p & (p - 1) == 0)


def test_radix_plan_refuses_large_primes():
    for n in (11, 257, 4097, 10007):
        with pytest.raises(ValueError):
            fft_plan.radix_plan(n)


# launches a call: rows past one CTA in passes of the tile register kernel
# (32768 and 65536 in two, 2^20 in two where tiles of <= 439 points took
# three, 2^25 in three, not four); Bluestein from BLUESTEIN_TILE_MIN on
# the tile register kernel, two passes a line of M (2^24 + 1: 33600000 in
# 3 + 3, was 11 launches at 2^26), below it the power-of-two design, 3 +
# 2 x passes (257: 5, 10007: 7); columns keep theirs
@pytest.mark.parametrize("n,columns,kind,passes", [
    (64, False, "radix", 1), (8192, False, "radix", 1),
    (16384, False, "radix", 1), (8192, True, "radix", 2),
    (128, True, "radix", 1), (65536, True, "radix", 2),
    (32768, False, "mixed", 2), (65536, False, "mixed", 2),
    (1 << 20, False, "mixed", 2), (1 << 24, False, "mixed", 3),
    (1 << 20, True, "mixed", 3),
    (200, False, "mixed", 1), (200, True, "mixed", 1),
    (360, False, "mixed", 1), (10000, False, "mixed", 1),
    (10000, True, "mixed", 2), (20000, False, "mixed", 2),
    (7, False, "mixed", 1),
    (257, False, "bluestein", 5), (4097, False, "bluestein", 5),
    (10007, False, "bluestein", 7), (257, True, "bluestein", 7),
    (1 << 25, False, "mixed", 3), (1 << 25, True, "mixed", 4),
    (5 ** 10, False, "mixed", 3), (1 << 31, False, "mixed", 4),
    (16777217, False, "bluestein", 6), (1 << 29, False, "mixed", 3)])
def test_route_per_n(n, columns, kind, passes):
    r = fft_plan.route(n, columns)
    assert r.kind == kind
    assert r.launches == passes
    assert r.cluster == (columns and fft_plan.takes_cluster(n))
    assert r.row_reg == (not columns and r.lines == (n,)
                         and fft_plan.takes_row_reg(n))
    assert r.tile == (fft_plan.takes_tile(n, columns) if kind == "mixed"
                      else kind == "bluestein"
                      and n >= fft_plan.BLUESTEIN_TILE_MIN)
    if r.cluster:
        s, c, na, nj = fft_plan.cluster_geometry(n)
        assert r.lines == (n,) and na * nj == n and r.work == 0
        assert list(r.plan)[:3] == [s, c, na]
        assert fft_plan.cluster_smem_bytes(s, c, na, nj) <= \
            fft_plan.CLUSTER_SMEM_MAX
    elif r.tile and kind == "mixed":
        assert not columns and r.plan is None and r.work == 2 * n
        assert r.lines == fft_plan.tile_stages(n) == fft_plan.stages(n, False)
        assert len(r.lines) == passes and math.prod(r.lines) == n
        assert all(fft_plan.tile_fits(fft_plan.TILE_LINES, d)
                   for d in r.lines)
    elif kind == "mixed":
        assert len(r.lines) == passes and math.prod(r.lines) == n
        limit = (fft_plan.MIXED_LINE_MAX if columns or passes > 1
                 else fft_plan.MIXED_ROW_MAX)
        assert max(r.lines) <= limit
        assert fft_plan.mixed_smem_bytes(
            1 if passes == 1 and not columns else fft_plan.LINE_TILE,
            max(r.lines)) <= fft_plan.SMEM_MAX
        assert list(r.plan)[0] == passes
    if kind == "bluestein":
        assert r.m == fft_plan.bluestein_m(n, columns) and r.work == 4 * r.m
        if r.tile:
            assert r.m == fft_plan.bluestein_size(n, columns)
            assert 2 * n - 1 <= r.m <= 2.15 * n
            assert r.m_route.tile and 2 * len(r.m_route.lines) == passes
            assert math.prod(r.m_route.lines) == r.m
        else:
            assert fft_plan.is_pow2(r.m) and r.m // 2 < 2 * n - 1 <= r.m
            assert 3 + 2 * r.m_route.launches == passes
    assert fft_plan.route(n, columns) is r      # planned once per N


@pytest.mark.parametrize("n,rows,points", [
    (10000, True, 0), (100, True, 0), (100, False, 20), (200, False, 20),
    (160, False, 20), (320, False, 20), (360, False, 0), (101, False, 0),
    (400, False, 20), (800, False, 0), (1000, False, 0), (60, False, 0),
    (256, False, 0), (128, False, 0), (100, False, 20)])
def test_register_kernel_takes_its_n(n, rows, points):
    assert fft_plan.reg_points(n, rows) == points
    if points:
        arr = list(fft_plan.plan_array((n,), not rows))
        assert arr[:4] == [1, n, arr[2], points]
        assert all(points % r == 0 for r in arr[4:])
        assert math.prod(arr[4:]) == n


def test_plan_array_layout():
    arr = list(fft_plan.plan_array((100, 100), True))
    assert arr == [2, 100, 3, 20, 4, 5, 5, 100, 3, 20, 4, 5, 5]
    arr = list(fft_plan.plan_array((360,), False))
    assert arr == [1, 360, 4, 0, 8, 3, 3, 5]


@pytest.mark.parametrize("n", [1, 2, 3, 7, 257, 4097, 8192, 10007])
def test_bluestein_size_is_least_power_of_two(n):
    # Bluestein's M: 7-smooth, >= 2N - 1, not past the power of two the
    # rule had before; the fewest passes of the tile register kernel; of
    # those, within BLUESTEIN_M_SLACK of the least, the fewest radix
    # passes, then the least
    for columns in (False, True):
        m = fft_plan.bluestein_size(n, columns)
        lo = max(2, 2 * n - 1)
        assert fft_plan.smooth7(m) and lo <= m <= 1 << (lo - 1).bit_length()
        k = fft_plan.bluestein_passes(m, columns)
        assert k >= 1
        same = [o for o in range(lo, m + 1) if fft_plan.smooth7(o)
                and fft_plan.bluestein_passes(o, columns) == k]
        for other in range(lo, m):
            if fft_plan.smooth7(other):
                assert not 0 < fft_plan.bluestein_passes(other, columns) < k
        assert m <= same[0] * (1 + fft_plan.BLUESTEIN_M_SLACK)

        def radix(x):
            return sum(len(fft_plan.wide_radix_plan(d))
                       for d in fft_plan.bluestein_lines(x, columns))
        assert all(radix(o) > radix(m) for o in same if o < m)
    assert fft_plan.bluestein_size(10007) == 20160 == 144 * 140
    assert fft_plan.bluestein_size(4097) == 8748     # one pass of 8 radices
    assert fft_plan.bluestein_size(4097, True) == 8232 == 98 * 84


@pytest.mark.parametrize("n", [7, 257, 4097, 10007])
def test_chirp_table_matches_numpy(n):
    e = fft_plan.chirp_exponents(n).numpy()
    k = np.arange(n, dtype=np.float64)
    want = np.exp(-1j * np.pi * k * k / n)
    got = np.exp(-1j * np.pi * e / n)
    assert np.abs(got - want).max() < 1e-9 * max(1.0, n * n / 1e6)
    assert e.max() < 2 * n and (e == (np.arange(n) ** 2) % (2 * n)).all()


# ---- plain versions of what the kernels compute, from the same plans ----

def _stockham(x: torch.Tensor, plan, sign: float) -> torch.Tensor:
    """Mixed-radix Stockham passes over the last axis of complex128 x, as
    mixed_lines_kernel runs them: pass radix R, Ns = earlier radices;
    butterfly j reads j + r*n/R, twiddles by exp(sign*2*pi*i*r*(j mod
    Ns)/(Ns*R)), writes (j/Ns)*Ns*R + (j mod Ns) + r*Ns."""
    *batch, n = x.shape
    ns = 1
    for R in plan:
        nb = n // R
        u = x.reshape(*batch, R, nb // ns, ns)
        r = torch.arange(R, dtype=torch.float64)
        jm = torch.arange(ns, dtype=torch.float64)
        u = u * torch.exp(sign * 2j * math.pi * r[:, None, None]
                          * jm / (ns * R))
        w = torch.exp(sign * 2j * math.pi * torch.outer(r, r) / R)
        y = torch.einsum("kr,...rqs->...qks", w, u)
        x = y.reshape(*batch, n)
        ns *= R
    return x


def _mixed(x: torch.Tensor, lines, sign: float) -> torch.Tensor:
    """The multi-pass split of fft_fourstep.cu's mixed_axis: N = m * n1,
    m-point lines at stride n1 times exp(sign*2*pi*i*j*k2/N), then
    n1-point lines written at stride m."""
    n = x.shape[-1]
    if len(lines) == 1:
        return _stockham(x, fft_plan.radix_plan(n), sign)
    n1 = lines[-1]
    m = n // n1
    y = x.reshape(*x.shape[:-1], m, n1).transpose(-1, -2)   # (.., j, a)
    y = _mixed(y, lines[:-1], sign)                         # (.., j, k2)
    j = torch.arange(n1, dtype=torch.float64)[:, None]
    k2 = torch.arange(m, dtype=torch.float64)[None, :]
    y = y * torch.exp(sign * 2j * math.pi * j * k2 / n)
    y = _stockham(y.transpose(-1, -2), fft_plan.radix_plan(n1), sign)
    return y.transpose(-1, -2).reshape(x.shape)           # k1*m + k2


def _bluestein(x: torch.Tensor, sign: float) -> torch.Tensor:
    """Bluestein as the kernels run it: chirp exp(sign*pi*i*(k^2 mod 2N)/N),
    a circular convolution of 7-smooth M points with conj(chirp), its
    transforms split as the route's M-point transform is."""
    n = x.shape[-1]
    m = fft_plan.bluestein_size(n)
    e = fft_plan.chirp_exponents(n).double()
    chirp = torch.exp(sign * 1j * math.pi * e / n)
    a = torch.zeros(*x.shape[:-1], m, dtype=torch.complex128)
    a[..., :n] = x * chirp
    b = torch.zeros(m, dtype=torch.complex128)
    b[:n] = chirp.conj()
    b[m - n + 1:] = chirp[1:].conj().flip(0)
    lines = ((m,) if fft_plan.bluestein_passes(m, False) == 1
             else fft_plan.tile_stages(m))
    spec = _mixed(b, lines, -1.0)
    conv = _mixed(_mixed(a, lines, -1.0) * spec, lines, 1.0) / m
    return conv[..., :n] * chirp


def _signal(b, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))


@pytest.mark.parametrize("n", [6, 60, 200, 360, 1000, 2 * 3 * 5 * 7 * 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_mixed_radix_passes_match_numpy(n, inverse):
    x = _signal(3, n)
    sign = 1.0 if inverse else -1.0
    got = _stockham(torch.from_numpy(x), fft_plan.radix_plan(n), sign)
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert np.abs(got.numpy() - want).max() < 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("n,columns", [(10000, True), (20000, False),
                                       (32768, False), (1 << 16, False),
                                       (2 * 3 * 5 * 7 * 1000, True)])
def test_multi_pass_split_matches_numpy(n, columns):
    lines = fft_plan.stages(n, columns)
    assert len(lines) > 1
    x = _signal(2, n)
    got = _mixed(torch.from_numpy(x), lines, -1.0).numpy()
    want = np.fft.fft(x)
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


def test_three_pass_split_matches_numpy():
    # the route of 2^20 takes three passes; the same split on a short N
    lines = (8, 4, 4)
    x = _signal(2, 128)
    got = _mixed(torch.from_numpy(x), lines, 1.0).numpy()
    want = np.fft.ifft(x) * 128
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("lines,inverse", [((4, 2, 4, 4), False),
                                            ((5, 5, 3, 2), True),
                                            ((7, 3, 4, 5), False)])
def test_four_pass_split_matches_numpy(lines, inverse):
    # the split of 2^25 and 5^10 (four passes), on short N
    n = math.prod(lines)
    x = _signal(2, n)
    got = _mixed(torch.from_numpy(x), lines, 1.0 if inverse else -1.0)
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert np.abs(got.numpy() - want).max() < 1e-10 * np.abs(want).max()


def test_routes_take_every_length():
    # 5^13 and 7*5^12 as rows: four passes of the tile register kernel;
    # as columns they have no split into four lines of <= 439 points:
    # five mixed passes. (1<<29)+1 takes Bluestein on the tile register
    # kernel at M = 1088391168 in three passes each way and (1<<31)+2 at M
    # = 4306640625 in four (2^31 and 2^33 before, in four and five). No
    # length is refused, and the 64-bit lengths cross the C interface.
    for n, rows in ((5 ** 13, (625, 125, 125, 125)),
                    (7 * 5 ** 12, (875, 125, 125, 125))):
        r = fft_plan.route(n, False)
        assert (r.kind, r.launches, r.lines, r.tile) == ("mixed", 4, rows,
                                                         True)
        assert r.work == 2 * n
        r = fft_plan.route(n, True)
        assert (r.kind, r.launches, len(r.lines)) == ("mixed", 5, 5)
        assert math.prod(r.lines) == n
        assert max(r.lines) <= fft_plan.MIXED_LINE_MAX
        assert list(r.plan)[0] == 5 and r.work == 2 * n
    assert fft_plan.line_stages(5 ** 13) == (125, 125, 125, 25, 25)
    r = fft_plan.route((1 << 29) + 1, False)
    assert (r.kind, r.m, r.m_route.lines) == ("bluestein", 1088391168,
                                              (972, 1152, 972))
    r = fft_plan.route((1 << 31) + 2, False)
    assert (r.kind, r.m, len(r.m_route.lines)) == ("bluestein", 4306640625,
                                                   4)
    assert r.launches == 2 * 4
    assert fft_plan.route(1 << 29, False).kind == "mixed"
    from repro_torch.kernels import _build
    sig = _build._SIGNATURES["repro_fft_tile"]
    assert sig[5] is _build._L                     # the scratch's plane
    desc, passes = fft_plan.tile_passes((1 << 31) + 2, False, 1, 1, False)
    assert passes == 8 and desc._type_ is __import__("ctypes").c_longlong
    words = list(desc)
    bn = 16 + fft_plan._DESC_FIELDS.index("bn")
    assert words[fft_plan.TILE_DESC * 4 + bn] == (1 << 31) + 2


@pytest.mark.parametrize("lines,inverse", [((5, 5, 3, 2, 2), False),
                                            ((7, 5, 5, 3, 2), True)])
def test_five_pass_split_matches_numpy(lines, inverse):
    # the split of 5^13 and 7*5^12 (five passes), on short N
    n = math.prod(lines)
    x = _signal(2, n)
    got = _mixed(torch.from_numpy(x), lines, 1.0 if inverse else -1.0)
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert np.abs(got.numpy() - want).max() < 1e-10 * np.abs(want).max()


# ---- the one-pass cluster kernel ----

@pytest.mark.parametrize("n,columns,geometry,takes", [
    # columns whose tile 2 CTAs hold take the cluster kernel
    (1000, True, (2, 8, 40, 25), True), (600, True, (2, 8, 25, 24), True),
    (1680, True, (2, 8, 56, 30), True),
    # 4, 8 or 16 CTAs: the line passes, which ran faster there
    (2000, True, (4, 8, 80, 25), False), (3000, True, (4, 8, 60, 50), False),
    (4000, True, (8, 8, 160, 25), False), (5000, True, (8, 8, 200, 25), False),
    (10000, True, (16, 8, 400, 25), False),
    (12000, True, (16, 8, 160, 75), False),
    # rows never take it (a row shared by a cluster ran slower than one
    # CTA a row): the planner has no row geometry
    (10000, False, None, False), (1680, False, None, False),
    (13824, False, None, False), (3000, False, None, False),
    # columns to 439 points keep one tile of 32 columns; powers of two the
    # radix route; past one cluster's capacity or off 7-smooth N nothing
    (200, True, (2, 8, 20, 10), False), (439, True, None, False),
    (8192, True, (16, 8, 128, 64), False), (20000, True, None, False),
    (13824, True, None, False), (10007, True, None, False)])
def test_cluster_route_per_n(n, columns, geometry, takes):
    if columns:
        assert fft_plan.cluster_geometry(n) == geometry
    r = fft_plan.route(n, columns)
    assert r.cluster == takes
    if takes:
        assert (r.kind, r.launches, r.work) == ("mixed", 1, 0)
        s, c, na, nj = geometry
        assert s <= fft_plan.COLUMN_CLUSTER_CTAS
        arr = list(r.plan)
        assert arr[:3] == [s, c, na]
        pa = arr[3]
        assert math.prod(arr[4:4 + pa]) == na
        assert arr[4 + pa] == nj
        assert math.prod(arr[6 + pa:]) == nj
        assert set(arr[4:4 + pa] + arr[6 + pa:]) <= {2, 3, 4, 5, 7, 8, 10,
                                                      16, 20, 25}
        assert (arr[4:4 + pa], arr[6 + pa:]) == (
            list(fft_plan.wide_radix_plan(na)),
            list(fft_plan.wide_radix_plan(nj)))
    if geometry:
        assert fft_plan.cluster_smem_bytes(*geometry) <= \
            fft_plan.CLUSTER_SMEM_MAX


@pytest.mark.parametrize("n,plan", [
    # rows from ROW_WIDE_MIN take the composite radices in one CTA, from
    # ROW_REG_MIN on the row register kernel (E = 1) where its middle
    # passes fit 448 threads (not 13824: 4608 radix-3 butterflies)
    (10000, [1, 10000, 3, 1, 25, 25, 16]), (5000, [1, 5000, 3, 1, 25, 25, 8]),
    (3000, [1, 3000, 4, 0, 25, 20, 2, 3]),
    (13824, [1, 13824, 6, 0, 8, 8, 8, 3, 3, 3]),
    # shorter rows keep radix_plan's
    (200, [1, 200, 3, 0, 8, 5, 5]), (360, [1, 360, 4, 0, 8, 3, 3, 5]),
    (1680, [1, 1680, 4, 0, 16, 3, 5, 7])])
def test_row_route_takes_the_composite_radices(n, plan):
    r = fft_plan.route(n, False)
    assert (r.kind, r.launches, r.cluster) == ("mixed", 1, False)
    assert list(r.plan) == plan
    assert r.row_reg == (plan[3] == fft_plan.ROW_REG_E)
    assert math.prod(plan[4:]) == n


def _cluster_pass(x: np.ndarray, n: int, sign: float) -> np.ndarray:
    """mixed_cluster_kernel on complex128 (outer, n, inner) x, CTA by CTA
    with the kernel's index maps: rank r loads point a of the na-point
    lines (jj, c), j = r*J + jj, from (a*nj + j)*ps + c*ls into a buffer
    [a, jj*C + c]; runs their radix passes; gathers from every rank's
    buffer [k2, l1] the points of its own k2 = r*K + kk, twiddled by
    exp(sign*2*pi*i*j*k2/n), into [j, kk*C + c]; runs the nj-point
    passes and stores point k1 at (k1*na + k2)*ps + c*ls."""
    s, c, na, nj = fft_plan.cluster_geometry(n)
    outer, _, inner = x.shape
    J, K = -(-nj // s), -(-na // s)
    L1, L2 = J * c, K * c
    lines, hi, ls, ps = inner, n * inner, 1, inner
    tiles = outer * -(-inner // c)
    flat, out = x.reshape(-1), np.zeros(x.size, dtype=np.complex128)
    written = np.zeros(x.size, dtype=np.int64)
    ncb = -(-lines // c)
    plan_a = fft_plan.wide_radix_plan(na)
    plan_j = fft_plan.wide_radix_plan(nj)
    scale = 1.0 / n if sign > 0 else 1.0
    for tile in range(tiles):
        o, l0 = tile // ncb, (tile % ncb) * c
        nl = min(c, lines - l0)
        base = o * hi + l0 * ls
        bufs = []
        for r in range(s):
            buf = np.full((na, L1), np.nan, dtype=np.complex128)
            jr = max(0, min(J, nj - r * J))
            jj, cc = np.meshgrid(np.arange(jr), np.arange(nl), indexing="ij")
            jj, cc = jj.ravel(), cc.ravel()
            a = np.arange(na)[None, :]
            idx = base + (a * nj + r * J + jj[:, None]) * ps + \
                cc[:, None] * ls
            got = _stockham(torch.from_numpy(flat[idx]), plan_a, sign)
            buf[:, jj * c + cc] = got.numpy().T
            bufs.append(buf)
        for r in range(s):
            kr = max(0, min(K, na - r * K))
            z = np.full((nj, L2), np.nan, dtype=np.complex128)
            for src in range(s):
                kk, l1 = np.meshgrid(np.arange(kr), np.arange(L1),
                                     indexing="ij")
                kk, l1 = kk.ravel(), l1.ravel()
                jj, cc = l1 // c, l1 % c
                j, k2 = src * J + jj, r * K + kk
                keep = j < nj
                j, k2, kk, cc, l1 = (v[keep] for v in (j, k2, kk, cc, l1))
                tw = np.exp(sign * 2j * np.pi * ((j * k2) % n) / n)
                z[j, kk * c + cc] = bufs[src][k2, l1] * tw
            kk, cc = np.meshgrid(np.arange(kr), np.arange(nl),
                                 indexing="ij")
            kk, cc = kk.ravel(), cc.ravel()
            got = _stockham(torch.from_numpy(z[:, kk * c + cc].T), plan_j,
                            sign).numpy()
            k1 = np.arange(nj)[None, :]
            idx = base + (k1 * na + r * K + kk[:, None]) * ps + \
                cc[:, None] * ls
            out[idx] = got * scale
            written[idx] += 1
    assert (written == 1).all()     # every point stored once
    return out.reshape(x.shape)


@pytest.mark.parametrize("n,shape", [
    (10000, (2, 10000, 11)), (1000, (2, 1000, 11)), (1000, (1, 1000, 501)),
    (600, (1, 600, 17)), (1680, (2, 1680, 9)), (5000, (1, 5000, 8))])
@pytest.mark.parametrize("inverse", [False, True])
def test_cluster_pass_matches_numpy(n, shape, inverse):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    sign = 1.0 if inverse else -1.0
    got = _cluster_pass(x, n, sign)
    want = np.fft.ifft(x, axis=1) if inverse else np.fft.fft(x, axis=1)
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()


# ---- the row register kernel ----

def _row_reg_pass(x: np.ndarray, sign: float) -> np.ndarray:
    """mixed_row_reg_kernel on complex128 (rows, n) x, with the kernel's
    index maps: one padded shared buffer (point q at q + q // 32); pass 0
    reads butterfly j's points j + r*n/R from device memory and writes
    (j/Ns)*Ns*R + (j mod Ns) + r*Ns (Ns = 1); each middle pass has thread
    t hold butterflies t + h*T (h < ROW_REG_HOLD[R]), all read before any
    is written; the last pass stores to device memory with the scale. T
    as the launcher picks it (about 8 points a thread, whole warps, at
    least each middle pass's need)."""
    rows, n = x.shape
    rad = fft_plan.wide_radix_plan(n)
    T = min(fft_plan.ROW_REG_THREADS, -(-n // 8))
    for r in rad[1:-1]:
        T = max(T, -(-(n // r) // fft_plan.ROW_REG_HOLD[r]))
    T = -(-T // 32) * 32
    assert T <= fft_plan.ROW_REG_THREADS

    def pad(q):
        return q + q // 32

    out = np.zeros_like(x)
    ns = 1
    for p, R in enumerate(rad):
        nb = n // R
        j = np.arange(nb)
        jm = j % ns
        r = np.arange(R)
        src = j[:, None] + r[None, :] * nb
        if p == 0:
            u = x[:, src]
        else:
            if p < len(rad) - 1:        # every butterfly held by a thread
                held = (np.arange(T)[:, None]
                        + np.arange(fft_plan.ROW_REG_HOLD[R])[None, :] * T)
                assert set(held.ravel()) >= set(j.tolist())
            u = buf[:, pad(src)]
            u = u * np.exp(sign * 2j * np.pi * r[None, None, :]
                           * jm[None, :, None] / (ns * R))
        dft = np.exp(sign * 2j * np.pi * np.outer(r, r) / R)
        v = u @ dft
        dst = ((j - jm) * R + jm)[:, None] + r[None, :] * ns
        if p == len(rad) - 1:
            out[:, dst] = v * (1.0 / n if sign > 0 else 1.0)
        else:
            new = np.full((rows, pad(n - 1) + 1), np.nan, dtype=complex)
            new[:, pad(dst)] = v
            assert len(set(pad(dst).ravel())) == n   # each point once
            buf = new
        ns *= R
    return out


@pytest.mark.parametrize("n", [10000, 5000, 6144, 7000])
@pytest.mark.parametrize("inverse", [False, True])
def test_row_reg_pass_matches_numpy(n, inverse):
    assert fft_plan.takes_row_reg(n)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    sign = 1.0 if inverse else -1.0
    got = _row_reg_pass(x, sign)
    want = np.fft.ifft(x, axis=1) if inverse else np.fft.fft(x, axis=1)
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("n,takes", [
    (10000, True), (5000, True), (6144, True), (7000, True), (4200, True),
    # shorter rows keep mixed_lines_kernel (64 rows of 3000 ran faster
    # there), as do rows whose middle passes need more than 448 threads,
    # powers of two on the radix route, and rows past one stage
    (3000, False), (4000, False), (200, False), (13824, False),
    (12000, False), (8192, False), (20000, False)])
def test_row_register_route_per_n(n, takes):
    assert fft_plan.takes_row_reg(n) == takes
    r = fft_plan.route(n, False)
    assert r.row_reg == takes
    assert (r.kind == "mixed" and r.lines == (n,)
            and list(r.plan)[3] == fft_plan.ROW_REG_E) == takes
    assert not fft_plan.route(n, True).row_reg


@pytest.mark.parametrize("n", [7, 257, 4097, 10007])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_bluestein_matches_numpy(n, inverse):
    x = _signal(2, n, seed=n)
    got = _bluestein(torch.from_numpy(x), 1.0 if inverse else -1.0).numpy()
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("n,plan", [
    (100, (25, 4)), (400, (25, 16)), (25, (25,)), (1000, (25, 20, 2)),
    (40, (20, 2)), (10, (10,)), (1680, (20, 4, 3, 7)), (128, (16, 8)),
    (13824, (8, 8, 8, 3, 3, 3)), (5, (5,)), (50, (25, 2))])
def test_wide_radix_plan(n, plan):
    assert fft_plan.wide_radix_plan(n) == plan
    assert math.prod(plan) == n


def _composite(v: np.ndarray, P: int, Q: int, sign: float) -> np.ndarray:
    """fft_common.cuh's dft_composite<P, Q> on the last axis: the P-point
    DFTs of x[Q*n1 + n2] over n1, output k1 times exp(sign*2*pi*i*n2*k1/R),
    then the Q-point DFTs over n2 into k1 + P*k2."""
    R = P * Q
    y = np.empty_like(v)
    for n2 in range(Q):
        a = v[..., [Q * n1 + n2 for n1 in range(P)]]
        a = a @ np.exp(sign * 2j * np.pi * np.outer(np.arange(P),
                                                     np.arange(P)) / P)
        for k1 in range(P):
            y[..., k1 * Q + n2] = a[..., k1] * np.exp(
                sign * 2j * np.pi * n2 * k1 / R)
    out = np.empty_like(v)
    for k1 in range(P):
        b = y[..., [k1 * Q + n2 for n2 in range(Q)]]
        b = b @ np.exp(sign * 2j * np.pi * np.outer(np.arange(Q),
                                                     np.arange(Q)) / Q)
        for k2 in range(Q):
            out[..., k1 + P * k2] = b[..., k2]
    return out


@pytest.mark.parametrize("P,Q", [(2, 5), (4, 5), (5, 5)])
@pytest.mark.parametrize("inverse", [False, True])
def test_composite_radix_matches_numpy(P, Q, inverse):
    x = _signal(3, P * Q, seed=P * Q)
    sign = 1.0 if inverse else -1.0
    want = np.fft.ifft(x) * P * Q if inverse else np.fft.fft(x)
    got = _composite(x, P, Q, sign)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("n,lines", [(10000, (100, 100)), (5000, (100, 50)),
                                     (4000, (80, 50)), (20000, (160, 125))])
def test_column_passes_take_the_wide_tiles(n, lines):
    # a column route of two line passes: every stage on the composite
    # radices, E = 0 (the tiles' wide instantiation); the same split as
    # before. Three passes keep their tiles.
    assert list(fft_plan.route(1 << 20, True).plan) == [
        3, 256, 3, 0, 8, 8, 4, 64, 2, 0, 8, 8, 64, 2, 0, 8, 8]
    r = fft_plan.route(n, True)
    assert (r.kind, r.cluster, r.lines) == ("mixed", False, lines)
    arr, i = list(r.plan), 1
    assert arr[0] == len(lines)
    for line in lines:
        P = arr[i + 1]
        assert arr[i] == line and arr[i + 2] == 0
        assert tuple(arr[i + 3:i + 3 + P]) == fft_plan.wide_radix_plan(line)
        i += 3 + P
    # rows that one CTA holds keep it; past it, the tile register kernel
    rows = fft_plan.route(n, False)
    if n > fft_plan.MIXED_ROW_MAX:
        assert rows.tile and rows.lines == fft_plan.stages(n, False)
    else:
        assert list(rows.plan)[:2] == [1, n]


# ---- the tile register kernel ----

def _tile_pass(d: dict, bufs: dict, chirp, spec) -> None:
    """One pass of mixed_tile_reg_kernel on complex128 flat buffers, with
    the kernel's index maps: CTA b takes outer index o = b / ncb (oh, ol)
    and lines l0 .. l0 + nl of it; a thread < C fills the line's offsets
    (point 0 in and out, the twiddle coefficient, and for Bluestein the
    line's row, position and inner index in the (outer, M, binner) layout
    and x's offset of position 0); the first pass loads point k of line c
    (Bluestein: x's point p = p0 + k*mstep times chirp[p], zero past N);
    the radix passes run through one padded buffer of the tile's lines
    side by side, each in-place pass's butterflies within what T threads
    hold (a fused pass: every radix pass); the last pass stores point k
    with the four-step twiddle of its exact exponent, the spectrum or the
    post-chirp, and the scale."""
    n, C, T = d["n"], d["c"], d["threads"]
    rad = fft_plan.wide_radix_plan(n)
    fused = d["fuse_in"] or d["fuse_out"]
    assert fft_plan.tile_smem_bytes(C, n) <= fft_plan.TILE_SMEM_MAX
    assert T <= fft_plan.TILE_THREADS and T % 32 == 0
    for R in (rad if fused else rad[1:-1]):
        assert T * fft_plan.TILE_HOLD[R] >= C * (n // R)
    # the padded shared index q + q // 32 of q = k*C + c: one slot each
    q = np.arange(n)[:, None] * C + np.arange(C)[None, :]
    assert len(np.unique(q + q // 32)) == C * n
    ncb = -(-d["lines"] // C)
    blk = np.arange(d["outer"] * ncb)
    o, l0 = blk // ncb, (blk % ncb) * C
    oh, ol = o // d["o_split"], o % d["o_split"]
    l = l0[:, None] + np.arange(C)[None, :]
    valid = l < d["lines"]
    lin = oh[:, None] * d["in_hi"] + ol[:, None] * d["in_lo"] + l * d["in_ls"]
    lout = (oh[:, None] * d["out_hi"] + ol[:, None] * d["out_lo"]
            + l * d["out_ls"])
    k = np.arange(n)

    def place(v):
        if not d["brow"]:
            return v, v
        row, rem = v // d["brow"], v % d["brow"]
        p0 = rem // d["binner"]
        return p0, row * d["bn"] * d["binner"] + rem % d["binner"]

    src, dst = bufs[d["src"]], bufs[d["dst"]]
    if d["fuse_in"]:
        p0, xin = place(lin)
        p = p0[..., None] + k * d["mstep_in"]
        keep = (p < d["bn"]) & valid[..., None]
        x = np.zeros(p.shape, dtype=np.complex128)
        x[keep] = src[(xin[..., None] + p * d["binner"])[keep]] * chirp[p[keep]]
    else:
        x = np.zeros(lin.shape + (n,), dtype=np.complex128)
        idx = lin[..., None] + k * d["in_ps"]
        x[valid] = src[idx[valid]]
    y = _stockham(torch.from_numpy(x), rad, float(d["sign"])).numpy()
    if d["tw_div"]:
        coef = l // d["tw_div"]
        e = coef[..., None] * (k * d["tw_kmul"] + (ol * d["tw_omul"])[:, None,
                                                                    None])
        assert (e[valid] < d["tw_m"]).all()
        y = y * np.exp(d["sign"] * 2j * np.pi * e / d["tw_m"])
    p0, xout = place(lout)
    p = p0[..., None] + k * d["mstep_out"]
    if d["fuse_out"] == 1:
        y = y * spec[np.where(valid[..., None], p, 0)]
    y = y / d["scale"]
    if d["fuse_out"] == 2:
        keep = (p < d["bn"]) & valid[..., None]
        idx = (xout[..., None] + p * d["binner"])[keep]
        dst[idx] = y[keep] * chirp[p[keep]]
    else:
        keep = np.broadcast_to(valid[..., None], y.shape)
        idx = (lout[..., None] + k * d["out_ps"])[keep]
        dst[idx] = y[keep]
    # every point stored once
    assert len(np.unique(idx)) == idx.size


def _tile_run(x: np.ndarray, columns: bool, inverse: bool) -> np.ndarray:
    """A call of repro_fft_tile on complex128 (outer, n, inner) x, from
    fft_plan.tile_passes' descriptor, pass by pass (buffers: 0 the input,
    1 the output, 2 and 3 the scratch's halves)."""
    outer, n, inner = x.shape
    r = fft_plan.route(n, columns)
    desc, passes = fft_plan.tile_passes(n, columns, outer, inner, inverse)
    words = np.array(list(desc), dtype=np.int64).reshape(passes, -1)
    assert words.shape[1] == fft_plan.TILE_DESC
    big = outer * (r.m or n) * inner
    bufs = {0: x.reshape(-1).copy(),
            1: np.full(x.size, np.nan, dtype=np.complex128),
            2: np.full(big, np.nan, dtype=np.complex128),
            3: np.full(big, np.nan, dtype=np.complex128)}
    chirp = spec = None
    if r.kind == "bluestein":
        sign = 1.0 if inverse else -1.0
        e = fft_plan.chirp_exponents(n).numpy().astype(np.float64)
        chirp = np.exp(sign * 1j * np.pi * e / n)
        b = np.zeros(r.m, dtype=np.complex128)
        b[:n] = chirp.conj()
        b[r.m - n + 1:] = chirp[1:].conj()[::-1]
        spec = np.fft.fft(b)
    assert passes == r.launches
    for w in words:
        d = dict(zip(fft_plan._DESC_FIELDS[:4], w[:4]))
        d.update(zip(fft_plan._DESC_FIELDS[4:], w[20:]))
        assert list(w[4:4 + d["p"]]) == list(
            fft_plan.wide_radix_plan(d["n"]))
        _tile_pass(d, bufs, chirp, spec)
    return bufs[1].reshape(x.shape)


@pytest.mark.parametrize("shape", [(2, 32768), (1, 20000), (3, 1 << 16),
                                   (1, 1 << 21), (1, 5 ** 9)])
@pytest.mark.parametrize("inverse", [False, True])
def test_tile_passes_match_numpy(shape, inverse):
    # rows past one CTA: 32768 as 256 x 128, 20000 as 160 x 125, 2^21 and
    # 5^9 in three passes, each pass's tiles of 8 neighbouring lines
    b, n = shape
    r = fft_plan.route(n, False)
    assert r.tile and len(r.lines) == (3 if n > 1 << 20 else 2)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((b, n, 1)) + 1j * rng.standard_normal((b, n, 1))
    got = _tile_run(x, False, inverse)
    want = np.fft.ifft(x, axis=1) if inverse else np.fft.fft(x, axis=1)
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()


@pytest.fixture
def tile_bluestein(monkeypatch):
    """Every Bluestein N on the tile register kernel's fused passes."""
    monkeypatch.setattr(fft_plan, "BLUESTEIN_TILE_MIN", 0)
    fft_plan.route.cache_clear()
    fft_plan.tile_passes.cache_clear()
    yield
    fft_plan.route.cache_clear()
    fft_plan.tile_passes.cache_clear()


@pytest.mark.parametrize("shape,columns,passes", [
    ((2, 257, 1), False, 1), ((3, 10007, 1), False, 2),
    ((1, 4097, 1), False, 1), ((2, 13, 1), False, 1),
    ((2, 257, 9), True, 1), ((1, 1009, 3), True, 2), ((3, 11, 5), True, 1),
    ((1, 1000003, 1), False, 3)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fused_bluestein_passes_match_numpy(tile_bluestein, shape, columns,
                                            passes, inverse):
    # Bluestein on the tile register kernel, M 7-smooth (525, 20160,
    # 8748, 25 (one radix pass), 45 x 45, 160 x 112 x 112): the pre-chirp
    # and zero
    # pad in the forward transform's first load, the spectrum in its last
    # store, the post-chirp and scale in the inverse's last store, which
    # writes only k < N; the buffers alternate so no pass runs in place
    outer, n, inner = shape
    r = fft_plan.route(n, columns)
    assert r.kind == "bluestein" and len(r.m_route.lines) == passes
    assert fft_plan.smooth7(r.m) and not fft_plan.is_pow2(r.m)
    rng = np.random.default_rng(n)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = _tile_run(x, columns, inverse)
    want = np.fft.ifft(x, axis=1) if inverse else np.fft.fft(x, axis=1)
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("n,c,fits,fused", [
    (1024, 8, True, False), (1152, 8, True, False), (1280, 8, False, False),
    (1344, 8, False, False), (1600, 8, False, False), (2048, 8, False, False),
    (972, 8, True, True), (8232, 1, False, False), (8748, 1, True, True),
    (13824, 1, False, False), (525, 8, True, True), (25, 8, True, True),
    (2, 1, True, True), (1, 1, False, False)])
def test_tile_fits_its_lines(n, c, fits, fused):
    # two CTAs an SM (shared memory) and each in-place pass's butterflies
    # within 384 threads' holds; Bluestein's fused passes run every radix
    # pass in place (1024 = 16 x 8 x 8 fits as a plain pass, not fused)
    assert fft_plan.tile_fits(c, n) == fits
    assert fft_plan.tile_fits(c, n, True) == fused
    if fits:
        assert fft_plan.tile_smem_bytes(c, n) <= fft_plan.TILE_SMEM_MAX
        assert fft_plan.tile_threads(c, n) <= fft_plan.TILE_THREADS
