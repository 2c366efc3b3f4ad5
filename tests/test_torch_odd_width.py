"""The host arithmetic of the real paths' two odd-width kernels, held to
numpy models on the CPU (the kernels themselves run only on the card,
``tests/test_torch_cuda.py``).

* The fused bandpass's flat pass (``kernels/bandpass.py``, ``plan``, and
  the kernel's walk, ``_tile_starts``): its tiles cover [0, R*C) exactly
  once, each starts on a 128-byte line of the planes, the grid is one
  wave or less, and a numpy run of the walk gives planes equal to re*m
  bit for bit and float64 sums.
* The radix column route's two passes (``csrc/fft_fourstep.cu``,
  ``pow2_axis``): a numpy model of ``fft_lines_kernel``'s column addressing
  under the geometry ``pow2_axis`` gives each pass reproduces
  ``np.fft`` along the middle axis, and every full warp of pass 2 stores
  32 consecutive floats from a 128-byte line, with no partial tile; the
  model of the second pass it replaced (the columns of each (o, k2))
  shows that pass's rows starting off the line at an odd inner.
"""
import math

import numpy as np
import pytest

from repro_torch.kernels import bandpass, fft_plan

# ---- the bandpass's flat pass ------------------------------------------

BANDPASS_N = [1, 3, 7 * 33, 4 * 32000, 131072, 131073, 4 * 32000 + 1,
              1 << 20, 8192 * 4097, 10000 * 5001, 8192 * 8192]


def _tile_starts(n, p):
    """csrc/bandpass.cu's walk: for each CTA, the first point of each tile
    it takes, in its order (CTA b takes tiles b, b + grid, ...)."""
    tile = bandpass.tile_points(p.vec)
    return [list(range(b * tile, n, p.grid * tile)) for b in range(p.grid)]


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("n", BANDPASS_N)
def test_bandpass_tiles_cover_the_planes_once_on_lines(n, vec):
    sms, per_sm = 132, 4
    p = bandpass.plan(n, vec, sms, per_sm)
    starts = _tile_starts(n, p)
    tile = bandpass.tile_points(vec)
    assert len(starts) == p.grid <= sms * per_sm
    assert all(starts), p                                # no idle CTA
    seen = np.zeros(n, np.int8)
    for cta in starts:
        assert cta == sorted(cta)
        for s in cta:
            assert (4 * s) % 128 == 0           # a 128-byte line
            seen[s:s + tile] += 1
    assert (seen == 1).all()


def test_bandpass_plan_per_shape():
    # the logits monitor's plane on one CTA a tile; the real chains'
    # planes on one wave
    assert bandpass.plan(4 * 32000, True, 132, 8) == (63, True)
    for n in (8192 * 4097, 10000 * 5001, 8192 * 8192):
        assert bandpass.plan(n, True, 132, 8) == (132 * 8, True)
    assert bandpass.plan(8192 * 4097, False, 132, 6) == (132 * 6, False)
    assert bandpass.plan(1, True, 132, 8) == (1, True)
    with pytest.raises(ValueError):
        bandpass.plan(0, True, 132, 8)


def _walk(re, im, mask, p):
    """The kernel's walk in numpy: each CTA's tiles in order, float32
    products, float64 sums; the CTAs' partials added in CTA order."""
    n = re.size
    ore, oim = np.empty_like(re), np.empty_like(im)
    tile = bandpass.tile_points(p.vec)
    kept = tot = 0.0
    for cta in _tile_starts(n, p):
        k_cta = t_cta = 0.0
        for s in cta:
            sl = slice(s, min(s + tile, n))
            r, q, m = re[sl], im[sl], mask[sl]
            ore[sl], oim[sl] = r * m, q * m
            pw = r.astype(np.float64) ** 2 + q.astype(np.float64) ** 2
            k_cta += float(np.sum(pw * m))
            t_cta += float(np.sum(pw))
        kept, tot = kept + k_cta, tot + t_cta
    return ore, oim, kept, tot


@pytest.mark.parametrize("n,vec", [(7 * 33, True), (4 * 32000, True),
                                   (200003, True), (200003, False)])
def test_bandpass_walk_matches_the_plain_version(n, vec):
    rng = np.random.default_rng(n)
    re, im = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    mask = rng.random(n).astype(np.float32)
    p = bandpass.plan(n, vec, 132, 8)
    ore, oim, kept, tot = _walk(re, im, mask, p)
    assert np.array_equal(ore, re * mask) and np.array_equal(oim, im * mask)
    pw = re.astype(np.float64) ** 2 + im.astype(np.float64) ** 2
    assert abs(kept / float(np.sum(pw * mask)) - 1) < 1e-12
    assert abs(tot / float(np.sum(pw)) - 1) < 1e-12


# ---- the radix column route's two passes --------------------------------

COL_W = 32     # kColW: columns (lanes) a CTA


def _geometries(outer, n, inner, inverse, replaced=False):
    """pow2_axis's two passes: (points a line, blocks of the outer index,
    the Geom fields), as csrc/fft_fourstep.cu sets them; ``replaced``: the
    second pass it replaced, lines (o, k2, c) of ``inner`` columns."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    sign = 1.0 if inverse else -1.0
    g1 = dict(lines=n1 * inner, o_split=1, in_hi=n * inner,
              out_hi=n * inner, in_lo=0, out_lo=0, in_ps=n1 * inner,
              out_ps=n1 * inner, in_cdiv=0, in_cmul=0, tw_div=inner, mt=n,
              sign=sign, scale=1.0)
    g2 = dict(in_hi=n * inner, out_hi=n * inner, in_lo=0, out_lo=0,
              in_ps=inner, out_ps=n2 * inner, tw_div=0, mt=n1, sign=sign,
              scale=1.0 / n if inverse else 1.0, o_split=1, in_cdiv=0,
              in_cmul=0)
    if replaced:
        g2.update(lines=inner, o_split=n2, in_lo=n1 * inner, out_lo=inner)
        return (n2, outer, g1), (n1, outer * n2, g2)
    g2.update(lines=n2 * inner, in_cdiv=inner, in_cmul=n1 * inner)
    return (n2, outer, g1), (n1, outer, g2)


def _addresses(points, outer, g):
    """fft_lines_kernel<., true>'s column addressing: per (block, lane),
    whether the lane holds a line, its input and output base."""
    ncb = -(-g["lines"] // COL_W)
    b = np.arange(outer * ncb)[:, None]
    lane = np.arange(COL_W)[None, :]
    o, c = b // ncb, (b % ncb) * COL_W + lane
    oh, ol = o // g["o_split"], o % g["o_split"]
    col_in = ((c // g["in_cdiv"]) * g["in_cmul"] + c % g["in_cdiv"]
              if g["in_cdiv"] else c)
    in_base = oh * g["in_hi"] + ol * g["in_lo"] + col_in
    out_base = oh * g["out_hi"] + ol * g["out_lo"] + c
    coef = c // g["tw_div"] if g["tw_div"] else None
    return c < g["lines"], in_base, out_base, coef


def _pass(src, dst, points, outer, g):
    valid, in_base, out_base, coef = _addresses(points, outer, g)
    k = np.arange(points)
    lines = src[in_base[valid][:, None] + k * g["in_ps"]]
    out = (np.fft.fft(lines, axis=1) if g["sign"] < 0
           else np.fft.ifft(lines, axis=1) * points)
    if coef is not None:
        e = (coef[valid][:, None] * k) % g["mt"]
        out = out * np.exp(g["sign"] * 2j * np.pi * e / g["mt"])
    dst[out_base[valid][:, None] + k * g["out_ps"]] = out * g["scale"]


def _columns(x, inverse):
    outer, n, inner = x.shape
    (p1, o1, g1), (p2, o2, g2) = _geometries(outer, n, inner, inverse)
    work = np.full(x.size, np.nan, complex)   # pass 1 writes all of it
    out = np.full(x.size, np.nan, complex)
    _pass(x.reshape(-1), work, p1, o1, g1)
    assert not np.isnan(work).any()
    _pass(work, out, p2, o2, g2)
    return out.reshape(x.shape)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(2, 512, 257), (1, 512, 7), (3, 1024, 33),
                                   (1, 2048, 1), (2, 512, 32),
                                   (1, 8192, 3), (3, 1024, 100),
                                   (1, 512, 4097), (2, 65536, 3),
                                   (1, 512, 4100), (1, 1024, 1001)])
def test_radix_column_passes_match_numpy(shape, inverse):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    got = _columns(x, inverse)
    want = np.fft.ifft(x, axis=1) if inverse else np.fft.fft(x, axis=1)
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("n,inner", [(512, 257), (8192, 4097), (8192, 4100),
                                     (1024, 33), (65536, 7), (512, 1),
                                     (8192, 4104), (16384, 1001)])
def test_flat_second_pass_stores_whole_lines(n, inner):
    # every full warp of the flat pass 2 stores each point's 32 floats as
    # one 128-byte line, and its lines fill whole tiles; pass 1 loads and
    # stores whole lines where n1 * inner is a multiple of 32
    outer = 2
    (p1, o1, g1), (p2, o2, g2) = _geometries(outer, n, inner, False)
    assert g2["lines"] % COL_W == 0              # no partial tile
    valid, _, out_base, _ = _addresses(p2, o2, g2)
    assert valid.all()
    for k in (0, p2 - 1):
        a = out_base + k * g2["out_ps"]
        assert (a[:, 0] % COL_W == 0).all()
        assert (np.diff(a, axis=1) == 1).all()
    valid, in1, out1, _ = _addresses(p1, o1, g1)
    if (g1["lines"]) % COL_W == 0:
        assert valid.all() and (in1[:, 0] % COL_W == 0).all()
        assert (out1[:, 0] % COL_W == 0).all()
    # the work buffer the route allocates holds pass 1's output
    r = fft_plan.route(n, True)
    if r.launches == 2:
        assert r.work == 2 * n
        assert int((out1[valid] + (p1 - 1) * g1["out_ps"]).max()) \
            < outer * n * inner


def test_replaced_second_pass_is_off_the_line_at_an_odd_inner():
    # what the flat pass removes: the column tiles of each (o, k2) start
    # their rows off a 128-byte line, and the last tile of each holds
    # inner mod 32 columns
    _, (p2, o2, g2) = _geometries(1, 8192, 4097, False, replaced=True)
    valid, _, out_base, _ = _addresses(p2, o2, g2)
    starts = out_base[:, 0] + 5 * g2["out_ps"]
    assert (starts % COL_W != 0).any()
    assert math.isclose(valid.mean(), 4097 / (129 * 32))
