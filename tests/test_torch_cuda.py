"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. The file
imports neither JAX nor the reference, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.fft import dft
from repro_torch.kernels import (bandpass, fft_fourstep, fft_plan,
                                  fft_stockham, flash_attention, ops, ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _planes(gen, shape):
    return (torch.randn(shape, generator=gen, device="cuda"),
            torch.randn(shape, generator=gen, device="cuda"))


def _rel(got, want):
    scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale


# Every route against a float64 oracle (torch.fft in complex128, an oracle
# only), at 5e-5 of max |X|, the reference's bar (tests/test_kernels.py:28);
# against torch.fft in float32 (5e-6, as before), and against the plain
# version where its float32 angles hold (5e-5 for powers of two, 1e-4
# otherwise). Launches per call from the
# route's plan (a Bluestein N's first call per direction also makes its
# chirp spectrum, one more FFT; the warm-up call pays it).
def _oracle(re, im, inverse, dim=-1):
    z = torch.complex(re.double(), im.double())
    out = (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=dim)
    return out.real, out.imag


def _rel64(got, want):
    scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
    return max(float((g.double() - w).abs().max())
               for g, w in zip(got, want)) / scale


def _plain_holds(n):
    # the plain four-step's float32 DFT matrices lose the angle for large
    # prime factors (past ~4096) and for N >= 2^16
    return n <= 1024 or (n <= 32768 and fft_plan.smooth7(n))


ROUTE_ROWS = [(1, 8192), (3, 1024), (8200, 64), (9001, 200), (5, 360),
              (7, 257), (4, 1), (3, 16384), (64, 200), (64, 360), (64, 257),
              (200, 200), (2, 20000), (2, 32768), (64, 32768), (8, 65536),
              (4, 1 << 20), (8, 10007), (16, 4097), (3, 10000), (5, 7),
              (2, 3 * 5 * 7 * 64),
              # past one CTA on the tile register kernel: 2^25, 2^26 and
              # 5^10 in three passes, 2048 x 32768 in two; 2^24 + 1 on
              # Bluestein (M = 33592320, three passes each way)
              (1, 1 << 25), (1, 5 ** 10), (1, (1 << 24) + 1),
              (2048, 32768), (1, 1 << 26)]


@pytest.mark.parametrize("shape", ROUTE_ROWS)
def test_fourstep_kernel_matches_plain(gen, shape):
    re, im = _planes(gen, shape)
    n = shape[1]
    kernels = fft_plan.route(n, False).launches
    for inverse in (False, True):
        fft_fourstep.fft_fourstep(re, im, inverse=inverse)   # warm-up
        before = fft_fourstep.fft_fourstep.launches
        got = fft_fourstep.fft_fourstep(re, im, inverse=inverse)
        assert fft_fourstep.fft_fourstep.launches == before + kernels
        assert _rel64(got, _oracle(re, im, inverse)) < 5e-5
        assert _rel(got, dft.local_fft(re, im, inverse=inverse,
                                       backend="jnp")) < 5e-6
        if _plain_holds(n):
            tol = 5e-5 if n & (n - 1) == 0 else 1e-4
            assert _rel(got, dft.fourstep_fft(re, im, inverse=inverse)) < tol


@pytest.mark.parametrize("n", [9973, 10007])
def test_fourstep_kernel_long_prime_rows(gen, n):
    # Bluestein (M = 32768 for both). The plain version's float32 angles
    # reach 2*pi*(N-1)**2/N here, so torch.fft is the yardstick.
    re, im = _planes(gen, (3, n))
    for inverse in (False, True):
        got = fft_fourstep.fft_fourstep(re, im, inverse=inverse)
        assert _rel(got, dft.local_fft(re, im, inverse=inverse,
                                       backend="jnp")) < 1e-5


@pytest.mark.parametrize("shape", [(64, 200), (64, 360), (8, 10007),
                                   (16, 4097), (64, 32768), (4, 1 << 20),
                                   (10, 10000)])
def test_fourstep_kernel_round_trip(gen, shape):
    re, im = _planes(gen, shape)
    fwd = fft_fourstep.fft_fourstep(re, im)
    back = fft_fourstep.fft_fourstep(*fwd, inverse=True)
    assert _rel(back, (re, im)) < 1e-4


# The mixed-radix rows (one CTA a row; from fft_plan.ROW_WIDE_MIN points
# on the composite radices, from fft_plan.ROW_REG_MIN on the row register
# kernel where its middle passes fit: 10000, 5000, 6144, not 13824 or
# 3000; 200 and 360 on radix_plan's) and columns (the cluster kernel where
# a cluster of 2 CTAs holds the tile: the engine's 1000^2 and its r2c half
# width (1, 1000, 501); the line passes past it: 3000, the 10000^2
# step's, the real steps' half widths with an odd inner; 8192 on the radix
# route; an odd inner with an outer axis). Against float64 at 5e-5 of max |X|,
# torch.fft at 1e-5, the plain version where its float32 angles hold
# (1e-4), and the round trip at 5e-5.
WIDE_ROWS = [(10000, 10000), (64, 10000), (200, 200), (64, 360),
             (3, 13824), (64, 5000), (64, 3000), (16, 6144)]
CLUSTER_COLUMNS = [(1, 10000, 10000), (1, 1000, 1000), (1, 1000, 501),
                   (1, 10000, 5001), (1, 8192, 4100), (3, 10000, 7),
                   (2, 3000, 33)]


def _check_route(fn, re, im, dim, n, columns):
    fs = fft_fourstep.fft_fourstep
    r = fft_plan.route(n, columns)
    for inverse in (False, True):
        before = (fs.cluster_launches, fs.row_reg_launches)
        got = fn(re, im, inverse=inverse)
        assert (fs.cluster_launches, fs.row_reg_launches) == (
            before[0] + int(r.cluster), before[1] + int(r.row_reg))
        assert _rel64(got, _oracle(re, im, inverse, dim=dim)) < 5e-5
        z = torch.complex(re, im)
        lib = (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=dim)
        assert _rel(got, (lib.real, lib.imag)) < 1e-5
        del z, lib
        if _plain_holds(n):
            plain = (_columns_plain(dft.fourstep_fft, re, im, inverse)
                     if columns else dft.fourstep_fft(re, im,
                                                      inverse=inverse))
            assert _rel(got, plain) < 1e-4
    back = fn(*fn(re, im), inverse=True)
    assert _rel(back, (re, im)) < 5e-5
    return r


@pytest.mark.parametrize("shape", WIDE_ROWS)
def test_wide_rows_match_plain_and_float64(gen, shape):
    re, im = _planes(gen, shape)
    n = shape[1]
    r = _check_route(fft_fourstep.fft_fourstep, re, im, -1, n, False)
    assert not r.cluster
    assert r.row_reg == (n in (10000, 5000, 6144))
    wide = list(fft_plan.wide_radix_plan(n))
    assert (list(r.plan)[4:] == wide) == (n >= fft_plan.ROW_WIDE_MIN)


@pytest.mark.parametrize("shape", CLUSTER_COLUMNS)
def test_cluster_columns_match_plain_and_float64(gen, shape):
    re, im = _planes(gen, shape)
    keep = (re.clone(), im.clone())
    n = shape[1]
    r = _check_route(fft_fourstep.fft_fourstep_columns, re, im, 1, n, True)
    assert r.cluster == fft_plan.takes_cluster(n)
    assert r.cluster == (n == 1000)
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])


@pytest.mark.parametrize("shape", [(1, 10000, 5001), (3, 10000, 7),
                                   (1, 5000, 64), (2, 3000, 33)])
def test_cluster_kernel_off_its_route_matches_float64(gen, shape,
                                                     monkeypatch):
    # the cluster kernel's 4-, 8- and 16-CTA columns, which the routes leave
    # to the faster line passes and tools/fft_variants.py times
    monkeypatch.setattr(fft_plan, "COLUMN_CLUSTER_CTAS", 16)
    fft_plan.route.cache_clear()
    try:
        re, im = _planes(gen, shape)
        r = _check_route(fft_fourstep.fft_fourstep_columns, re, im, 1,
                         shape[1], True)
        assert r.cluster
    finally:
        fft_plan.route.cache_clear()


def test_bluestein_at_m_2_pow_31_matches_closed_form(gen):
    # (1, 2^29 + 1): Bluestein at M = 1088391168 (2^31 before; about 40 GB
    # with its tables, made before the call's scratch), N and M 64-bit in
    # the tile register kernel's descriptor; a closed form stands in for a
    # float64 oracle
    torch.cuda.empty_cache()
    n = (1 << 29) + 1
    r = fft_plan.route(n, False)
    assert (r.kind, r.m, r.launches) == ("bluestein", 1088391168, 6)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    # the tones and closed form chip_smoke.py holds (1, 5^13) to
    from chip_smoke import tone_err, tone_field
    re, im, freqs, amps = tone_field(n, 0)
    for inverse in (False, True):
        got = fft_fourstep.fft_fourstep(re, im, inverse=inverse)
        assert tone_err(got, n, freqs, amps, inverse) < 5e-5
        del got
    del re, im
    fft_fourstep.clear_tables()
    torch.cuda.empty_cache()


# The tile register kernel's routes: rows past one CTA (2048 x 32768 in
# two passes, 2^25 and 2^26 in three) and Bluestein from
# fft_plan.BLUESTEIN_TILE_MIN (2^24 + 1: M 7-smooth, the chirps fused into
# the passes, 3 + 3); below it Bluestein keeps its power-of-two design
# ((8, 10007), (16, 4097), (64, 257), the (3, 257, 100) columns), and runs
# on the tile kernel too where the threshold is set to 0. Each call's
# launches are the route's, the tile kernel's all of them where the route
# takes it; against float64 at 5e-5 of max |X| and torch.fft at 1e-5.
BLUESTEIN_SHAPES = [((8, 10007), False), ((16, 4097), False),
                    ((64, 257), False), ((3, 257, 100), True)]
TILE_SHAPES = ([((64, 32768), False, False), ((2048, 32768), False, False),
                ((1, 1 << 25), False, False), ((1, 1 << 26), False, False),
                ((1, (1 << 24) + 1), False, False)]
               + [(s, c, a) for s, c in BLUESTEIN_SHAPES for a in (False,
                                                                   True)])


@pytest.mark.parametrize("shape,columns,tile_all", TILE_SHAPES)
def test_tile_routes_count_their_launches(gen, shape, columns, tile_all,
                                          monkeypatch):
    if tile_all:
        monkeypatch.setattr(fft_plan, "BLUESTEIN_TILE_MIN", 0)
    fft_plan.route.cache_clear()
    fft_plan.tile_passes.cache_clear()
    re, im = _planes(gen, shape)
    n = shape[1]
    r = fft_plan.route(n, columns)
    assert r.tile == (fft_plan.takes_tile(n, columns) if r.kind == "mixed"
                      else n >= fft_plan.BLUESTEIN_TILE_MIN)
    fn = (fft_fourstep.fft_fourstep_columns if columns
          else fft_fourstep.fft_fourstep)
    fs = fft_fourstep.fft_fourstep
    dim = 1 if columns else -1
    try:
        for inverse in (False, True):
            fn(re, im, inverse=inverse)              # warm-up: the tables
            before = (fs.launches, fs.tile_launches)
            got = fn(re, im, inverse=inverse)
            assert (fs.launches, fs.tile_launches) == (
                before[0] + r.launches,
                before[1] + (r.launches if r.tile else 0))
            assert _rel64(got, _oracle(re, im, inverse, dim=dim)) < 5e-5
            z = torch.complex(re, im)
            lib = (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=dim)
            assert _rel(got, (lib.real, lib.imag)) < 1e-5
            del got, z, lib
    finally:
        fft_fourstep.clear_tables()
        fft_plan.route.cache_clear()
        fft_plan.tile_passes.cache_clear()
        torch.cuda.empty_cache()
    if r.kind == "bluestein" and r.tile:
        assert r.launches == 2 * len(r.m_route.lines)
        assert r.m <= 2.15 * n


@pytest.mark.parametrize("shape", [(1, 2), (8200, 64), (1000, 128),
                                   (3, 4096), (5, 1)])
def test_stockham_kernel_matches_plain(gen, shape):
    re, im = _planes(gen, shape)
    for inverse in (False, True):
        got = fft_stockham.fft_stockham(re, im, inverse=inverse)
        assert _rel(got, dft.stockham_fft(re, im, inverse=inverse)) < 5e-5


@pytest.mark.parametrize("shape", [(4096, 1), (4096, 2), (1, 1, 1 << 20),
                                   (1, 2, 1 << 20), (3, 2, 1000),
                                   (1, 1, 1 << 27)])
def test_length_one_and_two_passes_match_plain(gen, shape):
    # the length-1 passes of pencil_tf and fourstep1d on one rank, and
    # the 2-point ones of pencil_tf on a 2-way first mesh axis, through
    # ops (Stockham, log2 N = 0 or 1), rows and columns
    re, im = _planes(gen, shape)
    for inverse in (False, True):
        if len(shape) == 2:
            got = ops.fft(re, im, inverse=inverse)
            want = dft.stockham_fft(re, im, inverse=inverse)
        else:
            got = ops.fft_axis(re, im, 1, inverse=inverse)
            want = _columns_plain(dft.stockham_fft, re, im, inverse)
        assert _rel(got, want) < 5e-5


@pytest.mark.parametrize("decomp,grid", [
    ("slab", (256, 384)), ("slab3d", (32, 48, 64)), ("pencil", (32, 48, 64)),
    ("pencil_tf", (32, 48, 64)), ("pencil2d", (256, 384)),
    ("fourstep1d", (1 << 16,))])
def test_one_rank_decompositions_run_the_kernels(gen, decomp, grid):
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft.plan import plan_dft
    axes = 2 if decomp in ("pencil", "pencil_tf", "pencil2d") else 1
    mesh = make_mesh((1,) * axes, ("data", "model")[:axes])
    assert mesh.device.type == "cuda"
    re, im = _planes(gen, grid)
    z = torch.complex(re.double(), im.double())
    for direction, want in (("forward", torch.fft.fftn(z)),
                            ("backward", torch.fft.ifftn(z))):
        plan = plan_dft(grid, direction, mesh, decomp=decomp,
                        backend="pallas")
        before = (ops.fft_fourstep.launches, ops.fft_stockham.launches)
        got = plan.execute(re, im)
        assert got[0].is_cuda and got[0].shape == re.shape
        assert (ops.fft_fourstep.launches, ops.fft_stockham.launches) \
            != before
        assert _rel64(got, (want.real, want.imag)) < 5e-5


@pytest.mark.parametrize("wrapper,grid", [
    ("slab_fft_2d", (256, 384)), ("slab_fft_3d", (32, 48, 64)),
    ("pencil_fft_3d", (32, 48, 64)), ("pencil_tf_fft_3d", (32, 48, 64)),
    ("pencil2d_fft_2d", (256, 384)), ("fourstep_fft_1d", (1 << 16,))])
def test_default_backend_runs_the_kernels(gen, wrapper, grid):
    # a caller who names no backend gets the kernels on a CUDA tensor
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft import distributed as D
    axes = 2 if wrapper.startswith("pencil") else 1
    mesh = make_mesh((1,) * axes, ("data", "model")[:axes])
    re, im = _planes(gen, grid)
    before = ops.fft_fourstep.launches + ops.fft_stockham.launches
    got = getattr(D, wrapper)(re, im, mesh)
    assert ops.fft_fourstep.launches + ops.fft_stockham.launches > before
    want = torch.fft.fftn(torch.complex(re.double(), im.double()))
    assert _rel64(got, (want.real, want.imag)) < 5e-5


@pytest.mark.parametrize("block_b", [1, 8, 64, 128])
def test_kernels_row_block_invariance(gen, block_b):
    # B large enough that the wrappers put up to block_b rows in a CTA
    re, im = _planes(gen, (16384, 128))
    want = fft_stockham.fft_stockham(re, im, block_b=1)
    got = fft_stockham.fft_stockham(re, im, block_b=block_b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # non-powers of two: mixed radix (200) and Bluestein (257)
    for n in (200, 257):
        re, im = _planes(gen, (16384, n))
        want = fft_fourstep.fft_fourstep(re, im, block_b=1)
        got = fft_fourstep.fft_fourstep(re, im, block_b=block_b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# The column route, (outer, N, inner) along the middle axis: inner == 1 is
# the row route. Against the plain version (5e-5 for powers of two, 1e-4
# otherwise; not for the primes past 4096, where its float32 angles fail),
# torch.fft (1e-5, the kernels' own fp32 error) and the float64 oracle
# (5e-5).
def _columns_plain(plain, re, im, inverse):
    rr, ii = plain(re.movedim(1, -1), im.movedim(1, -1), inverse=inverse)
    return rr.movedim(-1, 1), ii.movedim(-1, 1)


@pytest.mark.parametrize("n", [8, 64, 128, 256, 1024, 8192, 16384, 200, 360,
                               257, 20000, 32768, 10000, 4097, 10007,
                               1 << 17])
@pytest.mark.parametrize("inner", [1, 3, 32, 100])
def test_fft_axis_routes_match_plain_and_torch_fft(gen, n, inner):
    outer = 2 if n * inner <= 1 << 20 else 1
    re, im = _planes(gen, (outer, n, inner))
    keep = (re.clone(), im.clone())
    tol = 5e-5 if n & (n - 1) == 0 else 1e-4
    routes = [(fft_fourstep.fft_fourstep_columns, dft.fourstep_fft)]
    if n & (n - 1) == 0 and n <= 256:
        routes.append((fft_stockham.fft_stockham_columns, dft.stockham_fft))
    for fn, plain in routes:
        for inverse in (False, True):
            got = fn(re, im, inverse=inverse)
            assert got[0].shape == re.shape and got[0].is_contiguous()
            if _plain_holds(n):
                assert _rel(got, _columns_plain(plain, re, im,
                                                inverse)) < tol
            assert _rel64(got, _oracle(re, im, inverse, dim=1)) < 5e-5
            z = torch.complex(re, im)
            lib = (torch.fft.ifft if inverse else torch.fft.fft)(z, dim=1)
            assert _rel(got, (lib.real, lib.imag)) < 1e-5
    # the caller's input is never written
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])
    got = ops.fft_axis(re, im, 1)
    lib = torch.fft.fft(torch.complex(re, im), dim=1)
    assert _rel(got, (lib.real, lib.imag)) < 1e-5


def test_column_route_counts_its_launches(gen):
    # every kernel launched counts: two passes for 8192-point columns,
    # one for a radix row, two for a 32768-point row and for a 2^20-point
    # row (passes of the tile register kernel through a scratch buffer)
    re, im = _planes(gen, (1, 8192, 64))
    fs = fft_fourstep.fft_fourstep
    before, cols = fs.launches, fs.column_launches
    fft_fourstep.fft_fourstep_columns(re, im)
    assert (fs.launches, fs.column_launches) == (before + 2, cols + 2)
    for n, kernels in ((8192, 1), (32768, 2), (1 << 20, 2), (200, 1)):
        re, im = _planes(gen, (2, n))
        before = fs.launches
        fft_fourstep.fft_fourstep(re, im)
        assert (fs.launches, fs.column_launches) == (before + kernels,
                                                      cols + 2)
    re, im = _planes(gen, (1, 128, 128))
    st = fft_stockham.fft_stockham
    before, cols = st.launches, st.column_launches
    ops.fft_axis(re, im, 0)
    assert (st.launches, st.column_launches) == (before + 1, cols + 1)


@pytest.mark.parametrize("shape,kernels", [((200, 64), 1), ((360, 40), 1),
                                           ((10000, 33), 2),
                                           ((257, 40), 7)])
def test_non_power_of_two_columns_make_no_copy(gen, shape, kernels):
    # ops.fft_axis along axis 0: the column counter moves by the route's
    # launches, and the profiler sees only this library's kernels (no
    # copy, no elementwise kernel of PyTorch's)
    from torch.profiler import ProfilerActivity, profile
    re, im = _planes(gen, shape)
    ops.fft_axis(re, im, 0)                     # warm-up (Bluestein tables)
    torch.cuda.synchronize()
    fs = fft_fourstep.fft_fourstep
    cols = fs.column_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ops.fft_axis(re, im, 0)
        torch.cuda.synchronize()
    assert fs.column_launches == cols + kernels
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and not [k for k in names if "copy" in k.lower()
                          or "elementwise" in k.lower()], names
    assert _rel64(got, _oracle(re, im, False, dim=0)) < 5e-5


def test_column_wrappers_refuse_what_the_kernels_do_not_take(gen):
    re, im = _planes(gen, (2, 64, 8))
    for fn in (fft_fourstep.fft_fourstep_columns,
               fft_stockham.fft_stockham_columns):
        with pytest.raises(ValueError, match="contiguous"):
            fn(re.transpose(0, 2), im.transpose(0, 2))
        with pytest.raises(TypeError):
            fn(re.double(), im.double())
        with pytest.raises(ValueError, match="device"):
            fn(re, im.cpu())
        with pytest.raises(ValueError, match="3-D"):
            fn(re[0], im[0])
    with pytest.raises(ValueError, match="power of two"):
        fft_stockham.fft_stockham_columns(re[:, :48].contiguous(),
                                          im[:, :48].contiguous())
    with pytest.raises(ValueError, match="past"):
        big = _planes(gen, (1, 512, 2))
        fft_stockham.fft_stockham_columns(*big)


@pytest.mark.parametrize("shape", [(1, 1), (3, 1000), (8193, 129)])
def test_bandpass_kernel_matches_plain(gen, shape):
    re, im = _planes(gen, shape)
    mask = torch.rand(shape, generator=gen, device="cuda")
    r, i, kept, tot = bandpass.bandpass_filter(re, im, mask)
    pr, pi, _, _ = ref.bandpass_ref(re, im, mask)
    assert torch.equal(r, pr) and torch.equal(i, pi)
    p = re.double() ** 2 + im.double() ** 2
    assert abs(float(kept) / float((p * mask).sum()) - 1) < 1e-5
    assert abs(float(tot) / float(p.sum()) - 1) < 1e-5
    again = bandpass.bandpass_filter(re, im, mask)
    assert torch.equal(again[2], kept) and torch.equal(again[3], tot)


# The flat pass at the real chains' half-spectrum planes, the monitor's
# plane, planes whose size ends mid-sector, and a view whose base is not
# 16-byte aligned (scalar units): planes bit for bit, sums within 1e-5 of
# float64 and the same bits on a second run.
@pytest.mark.parametrize("shape,offset", [
    ((8192, 4097), 0), ((10000, 5001), 0), ((4, 32000), 0), ((7, 33), 0),
    ((1, 1), 0), ((8192, 4097), 1), ((7, 33), 3)])
def test_bandpass_kernel_odd_widths_match_plain(gen, shape, offset):
    n = shape[0] * shape[1]

    def plane(flat):
        return flat[offset:].view(shape)
    re = plane(torch.randn(n + offset, generator=gen, device="cuda"))
    im = plane(torch.randn(n + offset, generator=gen, device="cuda"))
    mask = plane(torch.rand(n + offset, generator=gen, device="cuda"))
    assert (re.data_ptr() % 16 == 0) == (offset == 0)
    before = bandpass.bandpass_filter.launches
    r, i, kept, tot = bandpass.bandpass_filter(re, im, mask)
    assert bandpass.bandpass_filter.launches == before + 1
    pr, pi, _, _ = ref.bandpass_ref(re, im, mask)
    assert torch.equal(r, pr) and torch.equal(i, pi)
    p = re.double() ** 2 + im.double() ** 2
    assert abs(float(kept) / float((p * mask).sum()) - 1) < 1e-5
    assert abs(float(tot) / float(p.sum()) - 1) < 1e-5
    # block_rows is the reference's hint: checked, and it changes nothing
    again = bandpass.bandpass_filter(re, im, mask, block_rows=1)
    assert torch.equal(again[2], kept) and torch.equal(again[3], tot)
    assert torch.equal(again[0], r) and torch.equal(again[1], i)
    with pytest.raises(ValueError, match="block_rows"):
        bandpass.bandpass_filter(re, im, mask, block_rows=0)


# The radix column route at odd and even inner: two passes through the
# scratch buffer (column launches) past 256 points, one row launch at
# inner 1; within 5e-5 of max |X| of float64 both ways.
@pytest.mark.parametrize("n", [512, 8192])
@pytest.mark.parametrize("inner", [1, 7, 33, 257, 4097, 4100, 4104, 8192])
def test_radix_columns_at_any_inner_match_float64(gen, n, inner):
    outer = max(1, (1 << 22) // (n * inner))
    re, im = _planes(gen, (outer, n, inner))
    fs = fft_fourstep.fft_fourstep
    for inverse in (False, True):
        before, cols = fs.launches, fs.column_launches
        got = fft_fourstep.fft_fourstep_columns(re, im, inverse=inverse)
        assert fs.launches - before == (1 if inner == 1 else 2)
        assert fs.column_launches - cols == (1 if inner == 1 else 2)
        assert _rel64(got, _oracle(re, im, inverse, dim=1)) < 5e-5


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    re, im = _planes(gen, (8, 64))
    with pytest.raises(ValueError, match="contiguous"):
        fft_fourstep.fft_fourstep(re.t(), im.t())
    with pytest.raises(TypeError):
        fft_stockham.fft_stockham(re.double(), im.double())
    with pytest.raises(ValueError, match="power of two"):
        fft_stockham.fft_stockham(re[:, :48].contiguous(),
                                  im[:, :48].contiguous())
    with pytest.raises(ValueError, match="device"):
        fft_fourstep.fft_fourstep(re, im.cpu())
    with pytest.raises(ValueError, match="block_b"):
        fft_stockham.fft_stockham(re, im, block_b=0)
    # ops makes strided views contiguous before the launch
    got = ops.fft(re.t(), im.t())
    want = dft.local_fft(re.t(), im.t(), backend="jnp")
    assert _rel(got, want) < 5e-5


# Flash attention against its plain version: the reference's bars,
# atol 2e-5 / rtol 1e-4 in float32 (tests/test_flash_attention.py), 3e-2
# in bf16. float32 runs as three TF32 products on the tensor cores,
# bf16 on wgmma; both hold these bars.
def _qkv(gen, B, S, H, KV, hd, dtype=torch.float32):
    return tuple(torch.randn((B, S, n, hd), generator=gen, device="cuda")
                 .to(dtype) for n in (H, KV, KV))


def _close(got, want, tol=None):
    if tol is None:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def _flash_case(gen, shape, dtype, causal=True, softcap=0.0):
    q, k, v = _qkv(gen, *shape, dtype)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          softcap=softcap)
    assert flash_attention.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                        softcap=softcap),
           None if dtype == torch.float32 else 3e-2)


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (False, 30.0)])
def test_flash_kernel_head_dims(gen, hd, causal, softcap):
    _flash_case(gen, (2, 200, 8, 2, hd), torch.float32, causal, softcap)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (False, 30.0),
                                            (True, 30.0), (False, 0.0)])
def test_flash_kernel_head_dims_bf16(gen, hd, causal, softcap):
    _flash_case(gen, (2, 200, 8, 2, hd), torch.bfloat16, causal, softcap)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,softcap", [(True, 30.0), (False, 0.0)])
def test_flash_kernel_head_dims_other_variants(gen, hd, causal, softcap):
    _flash_case(gen, (2, 200, 8, 2, hd), torch.float32, causal, softcap)


@pytest.mark.parametrize("S", [1, 5, 63, 65, 300, 2049])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_ragged_sequence(gen, S, causal):
    q, k, v = _qkv(gen, 1, S, 8, 2, 64)
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("S", [1, 5, 63, 65, 300, 2049])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_ragged_sequence_bf16(gen, S, causal):
    _flash_case(gen, (1, S, 8, 2, 64), torch.bfloat16, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_flash_kernel_gqa(gen, dtype, G):
    _flash_case(gen, (2, 300, 8, 8 // G, 128), dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_scaled_logits_f32(gen, causal):
    # q x 4 puts the logits at std 4 (|s| up to ~20): one TF32 product
    # (~5e-4 relative) would miss the bar here; three hold it
    q, k, v = _qkv(gen, 1, 512, 4, 2, 128)
    q = q * 4.0
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal))


def test_flash_kernel_block_invariance(gen):
    # block_q/block_k are the reference's TPU tiling hint: accepted, and
    # the result does not depend on them
    q, k, v = _qkv(gen, 2, 300, 4, 4, 64)
    want = flash_attention.flash_attention(q, k, v)
    _close(want, ref.flash_attention_ref(q, k, v))
    for bq, bk in ((32, 32), (32, 64), (64, 32), (128, 512), (256, 256)):
        assert torch.equal(flash_attention.flash_attention(
            q, k, v, block_q=bq, block_k=bk), want)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (8, 1)])
def test_flash_kernel_bf16(gen, H, KV):
    q, k, v = _qkv(gen, 1, 1024 // H, H, KV, 128, torch.bfloat16)
    got = flash_attention.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    _close(got, ref.flash_attention_ref(q, k, v), tol=3e-2)


def test_flash_kernel_reads_strided_views(gen):
    # q/k/v as slices of one fused projection, as (B, S, H, hd) views
    qkv = torch.randn((2, 130, 8 + 2 + 2, 32), generator=gen, device="cuda")
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert not q.is_contiguous()
    got = flash_attention.flash_attention(q, k, v)
    _close(got, ref.flash_attention_ref(q, k, v))
    # aligned strides, start 8 bytes past a 16-byte boundary: copied
    wide = torch.randn((2, 130, 8, 36), generator=gen, device="cuda")
    q = wide[..., 2:34]
    assert q.data_ptr() % 16
    got = flash_attention.flash_attention(q, k, v)
    _close(got, ref.flash_attention_ref(q, k, v))


def _qkv_sk(gen, B, Sq, Sk, H, KV, hd):
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda")
    k, v = (torch.randn((B, Sk, KV, hd), generator=gen, device="cuda")
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("Sq,Sk", [(64, 1500), (1, 1500), (300, 65),
                                   (130, 7), (2048, 64)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_kernel_key_length_of_its_own(gen, Sq, Sk, softcap):
    # non-causal, Sk != Sq: whisper's cross-attention (64 decoder queries
    # against 1500 encoder keys) and ragged tiles on both sides
    q, k, v = _qkv_sk(gen, 2, Sq, Sk, 16, 16, 64)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=False,
                                          softcap=softcap)
    assert flash_attention.flash_attention.launches == before + 1
    assert got.shape == q.shape
    _close(got, ref.flash_attention_ref(q, k, v, causal=False,
                                        softcap=softcap))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_head_dim_80_at_zamba2_heads(gen, causal):
    # zamba2's shared block: MHA, 32 heads of 80, a ragged S
    _flash_case(gen, (2, 333, 32, 32, 80), torch.float32, causal)


def test_flash_wrapper_refuses_the_new_shapes_where_it_must(gen):
    q, k, v = _qkv_sk(gen, 1, 64, 96, 4, 4, 64)
    with pytest.raises(ValueError, match="causal"):
        flash_attention.flash_attention(q, k, v, causal=True)
    q, k, v = _qkv(gen, 1, 64, 4, 4, 80, torch.bfloat16)
    with pytest.raises(ValueError, match="80"):
        flash_attention.flash_attention(q, k, v)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 64, 8, 2, 64)
    with pytest.raises(ValueError, match="device"):
        flash_attention.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.flash_attention(q[:, :, :7], k[:, :, :2],
                                        v[:, :, :2])
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(q[..., :48], k[..., :48],
                                        v[..., :48])
    with pytest.raises(ValueError, match="block"):
        flash_attention.flash_attention(q, k, v, block_q=0)


def test_flash_wrapper_raises_under_grad(gen):
    """The kernel has no backward: a call that autograd would record
    raises instead of returning an output with no gradient; under
    no_grad, or on tensors that need none, it runs."""
    q, k, v = _qkv(gen, 1, 128, 4, 2, 64)
    out = flash_attention.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert torch.equal(flash_attention.flash_attention(q, k, v), out)


def test_loss_under_a_policy_trains_attention_on_the_card(gen):
    """The training path on CUDA: under a one-rank policy attention takes
    the plain paths (no flash launch), and wq, wk and wv get nonzero
    gradients equal to the CPU run's."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.sharding.policy import make_policy
    from repro_torch.tree_util import tree_leaves_with_path, tree_unflatten
    cfg = registry.get_reduced("qwen3-4b")
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    grads = {}
    for device in ("cuda", "cpu"):
        moved = [(path, t.detach().to(device).requires_grad_())
                 for path, t in tree_leaves_with_path(params)]
        p = tree_unflatten(params, [t for _, t in moved])
        pol = make_policy(make_host_mesh(device=device), global_batch=2)
        before = flash_attention.flash_attention.launches
        loss, _ = lm.loss_fn(cfg, p, {k: v.to(device)
                                      for k, v in batch.items()}, pol,
                             loss_chunk=16)
        g = torch.autograd.grad(loss, [t for _, t in moved])
        assert flash_attention.flash_attention.launches == before
        grads[device] = {path: t for (path, _), t in zip(moved, g)}
    for path, g in grads["cuda"].items():
        if path.endswith(("['wq']", "['wk']", "['wv']")):
            assert float(g.abs().max()) > 0, path
        want = grads["cpu"][path]
        scale = max(float(want.abs().max()), 1e-30)
        assert float((g.cpu() - want).abs().max()) <= 1e-4 * scale, path


def test_sharded_loader_places_pinned_batches_on_the_card(gen):
    """The loader's CUDA branch: batches copied from pinned memory on the
    worker's stream, ready for the consumer's stream, equal to the
    stream's numpy batches, in step order."""
    import numpy as np
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.policy import make_policy
    pol = make_policy(make_host_mesh(device="cuda"), global_batch=4)
    kw = dict(global_batch=4, seq_len=64, vocab=1000, seed=2)
    loader = ShardedLoader(lambda s: synthetic.batch_at(s, **kw), pol,
                           start_step=3, prefetch=2)
    try:
        for want in range(3, 8):
            step, batch = next(loader)
            assert step == want
            for k, v in synthetic.batch_at(step, **kw).items():
                assert batch[k].is_cuda
                np.testing.assert_array_equal(batch[k].cpu().numpy(), v)
    finally:
        loader.close()


# ---------------------------------------------------------------------------
# The planner's real (r2c/c2r) plans, wires, tables and measured sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decomp,grid", [
    ("slab", (256, 384)), ("slab3d", (32, 48, 64)), ("pencil", (32, 48, 64)),
    ("pencil_tf", (32, 48, 64)), ("pencil2d", (256, 384)),
    ("slab", (200, 250))])
def test_one_rank_real_plans_run_the_kernels(gen, decomp, grid):
    # every complex pass of an r2c/c2r plan on the kernels (the endcaps
    # are torch.fft's rfft/irfft, as the reference's are jnp.fft's)
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft.plan import plan_rfft
    axes = 2 if decomp in ("pencil", "pencil_tf", "pencil2d") else 1
    mesh = make_mesh((1,) * axes, ("data", "model")[:axes])
    x = torch.randn(grid, generator=gen, device="cuda")
    fwd = plan_rfft(grid, "forward", mesh, decomp=decomp)
    bwd = plan_rfft(grid, "backward", mesh, decomp=decomp)
    before = ops.fft_fourstep.launches + ops.fft_stockham.launches
    re, im = fwd.execute(x)
    assert ops.fft_fourstep.launches + ops.fft_stockham.launches > before
    want = torch.fft.rfftn(x.double())
    h = want.shape[-1]
    assert re.shape[-1] == h and re.is_cuda
    assert _rel64((re, im), (want.real, want.imag)) < 5e-5
    before = ops.fft_fourstep.launches + ops.fft_stockham.launches
    back = bwd.execute(re, im)
    assert ops.fft_fourstep.launches + ops.fft_stockham.launches > before
    assert float((back - x).abs().max() / x.abs().max()) < 5e-5


@pytest.mark.parametrize("wire", ["bfloat16", "bf16", "int8",
                                  "int8_block64"])
def test_wire_on_the_card_matches_the_cpu(gen, wire):
    # encode and decode on CUDA tensors give the CPU's bytes (half-even
    # rounding on both), through a one-shard exchange
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft import schedule as S
    mesh = make_mesh((1,), ("data",))
    x = torch.randn((8, 256), generator=gen, device="cuda") * 10
    st = S.AllToAll("data", -2, -1, 1, wire)
    (got,) = st.apply((x,), mesh)
    (want,) = st.apply((x.cpu(),), make_mesh((1,), ("data",),
                                              device="cpu"))
    assert got.is_cuda and torch.equal(got.cpu(), want)


def test_bluestein_tables_stay_on_the_card_and_clear(gen):
    from repro_torch.core.fft.plan import plan_cache_clear
    plan_cache_clear()
    re, im = _planes(gen, (4, 257))
    fft_fourstep.fft_fourstep(re, im)
    assert fft_fourstep.table_bytes() > 0
    assert all(t.is_cuda for pair in fft_fourstep._CHIRPS.values()
               for t in pair)
    held = torch.cuda.memory_allocated()
    plan_cache_clear()
    assert fft_fourstep.table_bytes() == 0
    assert torch.cuda.memory_allocated() < held


def test_measure_on_the_card_times_the_kernels_and_torch_fft(gen):
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft import plan as P
    P.plan_cache_clear()
    mesh = make_mesh((1,), ("data",))
    p = P.plan_dft((256, 384), "forward", mesh, backend="measure",
                   allow_reduced_wire=False)
    assert p.backend in ("pallas", "jnp")
    assert P.plan_cache_stats()["sweep_candidates_timed"] == 2 * 3
    re, im = _planes(gen, (256, 384))
    want = torch.fft.fftn(torch.complex(re.double(), im.double()))
    assert _rel64(p.execute(re, im), (want.real, want.imag)) < 5e-5
    P.plan_cache_clear()


def _pipe_chain(mode, out_dir, mesh):
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.core.insitu.bridge import GridMeta
    return build_chain({"mode": mode, "chain": [
        {"endpoint": "fft", "direction": "forward", "backend": "pallas"},
        {"endpoint": "bandpass", "keep_frac": 0.1},
        {"endpoint": "fft", "direction": "backward", "backend": "pallas"},
        {"endpoint": "writer", "out_dir": str(out_dir)},
    ]}, mesh=mesh, grid=GridMeta((512, 512)))


def test_pipelined_chain_on_the_card(gen, tmp_path):
    """The pipelined chain on CUDA tensors: each field carries its ready
    event, the worker hands the writer host copies, the fields are
    bit-identical to the insitu chain's, and a steady-state execute
    queued behind a spin kernel returns before the spin ends."""
    from repro_torch.compat import make_mesh
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.pipeline import READY_EVENT
    mesh = make_mesh((1,), ("data",), device="cuda")
    src = RadiatingSourceAdaptor((512, 512), mesh=mesh)
    fields = [src.produce(s) for s in range(5)]
    insitu = _pipe_chain("insitu", tmp_path / "i", mesh)
    piped = _pipe_chain("pipelined", tmp_path / "p", mesh)
    want = [insitu.execute(f) for f in fields]
    outs = [piped.execute(f) for f in fields]
    assert all(isinstance(o.meta[READY_EVENT], torch.cuda.Event)
               for o in outs)
    piped.drain(timeout=60)
    for o, w in zip(outs, want):
        assert torch.equal(o.arrays["field"], w.arrays["field"])
    host = piped._pipeline._last_out.arrays["field"]
    assert host.device.type == "cpu" and host.is_pinned()
    torch.cuda._sleep(int(1.98e9 * 0.05))
    spin = torch.cuda.Event()
    spin.record()
    piped.execute(fields[0])
    assert not spin.query(), "the producer waited on the device"
    piped.drain(timeout=60)
    files = piped.finalize()["writer"]["files"]
    assert [f.rsplit("/", 1)[1] for f in files] == [
        f"field_{s:06d}.npy" for s in (0, 1, 2, 3, 4, 0)]
    pipe = piped.marshaling_report()["pipeline"]
    assert pipe["error"] is None and pipe["completed"] == 6


def test_fft_engine_on_the_card(gen):
    """The engine on a CUDA host mesh runs the FFT kernels: answers
    within 5e-5 of max |X| of float64."""
    import numpy as np
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.fft_engine import FFTServeEngine
    eng = FFTServeEngine(make_host_mesh(), max_batch=4, linger_s=0.0)
    assert eng.mesh.device.type == "cuda"
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal((64, 200)) + 1j * rng.standard_normal(
        (64, 200))).astype(np.complex64) for _ in range(3)]
    before = ops.fft_fourstep.launches
    futs = [eng.submit(x) for x in xs]
    eng.step(force=True)
    eng.drain(timeout=60)
    assert ops.fft_fourstep.launches > before
    for x, fut in zip(xs, futs):
        want = np.fft.fftn(x.astype(np.complex128))
        got = fut.result(timeout=60)
        assert np.abs(got - want).max() <= 5e-5 * np.abs(want).max()
    assert eng.report()["batching"]["executes"] == 1
    eng.stop()


TRANSIT_RANK = '''
import json, os
import torch
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.transit import TransitBridge
from repro_torch.launch.mesh import make_transit_meshes
from repro_torch.runtime.cluster import cluster_info, init_cluster
init_cluster()                   # REPRO_* env; the ranks share the card
pm, cm = make_transit_meshes(1, 1)
bridge = TransitBridge(pm, cm)
gen = torch.Generator(device="cuda").manual_seed(5)
fields = [torch.randn((256, 384), generator=gen, device="cuda")
          for _ in range(3)]
out = {"backend": cluster_info()["backend"], "same": [], "devices": []}
for k, f in enumerate(fields):
    data = BridgeData(arrays={"f": f if bridge.is_producer() else
                              torch.empty(f.shape, device="meta")}, step=k)
    if k == 0:
        got = [bridge.send(data)]
    else:
        bridge.send_async(data, depth=1)
        got = bridge.drain_async()
    if bridge.is_consumer():
        out["same"] += [torch.equal(g.arrays["f"], fields[g.step])
                        for g in got]
        out["devices"] += [str(g.arrays["f"].device) for g in got]
print(json.dumps(out), flush=True)
torch.distributed.barrier()
os._exit(0)
'''


def test_transit_host_hop_between_ranks_sharing_the_card(gen):
    """Two ranks on the card, started by the REPRO_* env contract (gloo:
    they share it): CUDA blocks sent by ``send`` and ``send_async`` (the
    worker's event wait and pinned copy) arrive bit-identical on the
    consumer's device."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", TRANSIT_RANK],
        env=dict(os.environ, PYTHONPATH=src, REPRO_COORDINATOR=coord,
                 REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    producer, consumer = (json.loads(log.strip().splitlines()[-1])
                          for log in logs)
    assert producer["backend"] == consumer["backend"] == "gloo"
    assert producer["same"] == [] and consumer["same"] == [True] * 3
    assert consumer["devices"] == ["cuda:0"] * 3


# ---------------------------------------------------------------------------
# The spectral solvers: steps on the kernels against the same steps on the
# plain versions (the plan's "fourstep"/"stockham" backend, plain PyTorch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver,grid,decomp,real,stepper", [
    ("ns2d", (256, 256), "slab", True, "if_rk4"),
    ("ns2d", (200, 256), "slab", False, "rk4"),
    ("bq3d", (32, 32, 64), "pencil", True, "if_rk4"),
    ("bq3d", (32, 32, 32), "pencil_tf", False, "rk4")])
def test_solver_steps_on_the_kernels_match_plain(gen, solver, grid, decomp,
                                                 real, stepper):
    from repro_torch.compat import make_mesh
    from repro_torch.core.solver import Boussinesq3DSolver, NS2DSolver
    axes = 2 if decomp in ("pencil", "pencil_tf") else 1
    mesh = make_mesh((1,) * axes, ("data", "model")[:axes])
    out = {}
    for backend in ("auto", "fourstep"):
        if solver == "ns2d":
            s = NS2DSolver(grid, mesh, nu=5e-3, dt=5e-3, decomp=decomp,
                           real=real, stepper=stepper, backend=backend)
        else:
            s = Boussinesq3DSolver(grid, mesh, nu=0.02, kappa=0.02,
                                   gravity=1.0, dt=5e-3, decomp=decomp,
                                   real=real, stepper=stepper,
                                   backend=backend)
        s.init_random(seed=3)
        before = ops.fft_fourstep.launches + ops.fft_stockham.launches
        s.step(3)
        torch.cuda.synchronize()
        launched = ops.fft_fourstep.launches + ops.fft_stockham.launches \
            - before
        assert (launched > 0) == (backend == "auto"), (backend, launched)
        out[backend] = (s.vorticity() if solver == "ns2d"
                        else s.field("u0"), s.energy())
    (got, e_got), (want, e_want) = out["auto"], out["fourstep"]
    assert float(abs(got - want).max() / abs(want).max()) < 1e-4
    assert abs(e_got - e_want) / e_want < 1e-5


# ---------------------------------------------------------------------------
# The LM substrate's collectives (sharding/collectives.py) on two ranks
# sharing the card over gloo, forward and backward, against the same ops
# on CPU tensors
# ---------------------------------------------------------------------------

COLLECTIVES_RANK = '''
import datetime, faulthandler, json, os, sys
faulthandler.dump_traceback_later(100, exit=True)   # a hang shows where
import torch
import torch.distributed as dist
from repro_torch.sharding import collectives as C
rank, dev = int(sys.argv[1]), sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[2], 2),
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
g = dist.group.WORLD
gen = torch.Generator().manual_seed(7 + rank)
x = torch.randn((4, 6, 8), generator=gen).to(dev).requires_grad_(True)
w = torch.randn((8, 6, 16), generator=torch.Generator().manual_seed(9))
w = w.to(dev)
ops = {
    "reduce_sum": lambda t: C.reduce_sum(t, g),
    "enter": lambda t: C.enter(t, g) * (rank + 1),
    "gather_slice": lambda t: C.gather(t, 0, 2, rank, g, "slice"),
    "gather_sum": lambda t: C.gather(t, 0, 2, rank, g, "sum") * (rank + 1),
    "split": lambda t: C.split(t, 1, 2, rank, g),
    "all_to_all": lambda t: C.all_to_all(t, 0, 2, 2, g),
    "reduce_scatter": lambda t: C.reduce_scatter(t, 0, 2, g),
}
out = {}
for name, op in ops.items():
    y = op(x)
    grad, = torch.autograd.grad((y * w[:y.shape[0], :y.shape[1],
                                       :y.shape[2]]).sum(), x)
    out[name] = [y.detach().cpu().tolist(), grad.cpu().tolist()]
out["reduce_max"] = C.reduce_max(x, g).cpu().tolist()
out["device"] = str(C.reduce_sum(x, g).device)
if dev != "cpu":
    # a checkpoint saved from a mesh whose axis is the world's group,
    # after CUDA collectives on it: the save's wait must not hang
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.compat import make_mesh
    from repro_torch.sharding.policy import make_policy
    mesh = make_mesh((2,), ("data",), device=dev)
    pol = make_policy(mesh, global_batch=2)
    blk = pol.named(("data", None))(torch.arange(32.0).reshape(8, 4))
    ckpt.save(sys.argv[3], 0, {"w": blk}, mesh=mesh,
              gather={"w": lambda t: pol.gather(t, ("data", None))})
    torch.cuda.synchronize()
print(json.dumps(out), flush=True)
dist.barrier()
os._exit(0)
'''


def _two_ranks(tmp_path, dev):
    """COLLECTIVES_RANK on two ranks with tensors on ``dev``; each
    rank's results."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    store = str(tmp_path / f"store_{dev.replace(':', '')}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", COLLECTIVES_RANK, str(r), store,
         str(tmp_path / "ckpt"), dev],
        env=dict(os.environ, PYTHONPATH=src), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("\n".join(p.communicate()[0] for p in procs))
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


def test_collectives_on_the_card_match_the_cpu(gen, tmp_path):
    """Every collective helper on CUDA tensors over gloo (two ranks on
    cuda:0; the reduce-scatter is staged as an all_to_all_single) equals
    the same helper on CPU tensors over gloo (two ranks), forward and
    backward; a checkpoint saved from a mesh over both ranks after CUDA
    collectives on its group holds the whole array. The two devices run
    in separate pairs of ranks: a pair that ran both on one group hung
    at its last collective."""
    import numpy as np
    cpu = _two_ranks(tmp_path, "cpu")
    card = _two_ranks(tmp_path, "cuda:0")
    for want, got in zip(cpu, card):
        assert got["device"] == "cuda:0" and want["device"] == "cpu"
        pairs = [(name + part, got[name][i], want[name][i])
                 for name in ("reduce_sum", "enter", "gather_slice",
                              "gather_sum", "split", "all_to_all",
                              "reduce_scatter")
                 for i, part in enumerate((" forward", " backward"))]
        pairs.append(("reduce_max", got["reduce_max"], want["reduce_max"]))
        for name, g, w in pairs:
            assert torch.allclose(torch.tensor(g, dtype=torch.float64),
                                  torch.tensor(w, dtype=torch.float64),
                                  rtol=1e-6, atol=1e-6), name
    saved = np.load(tmp_path / "ckpt" / "step_00000000" / "arr_00000.npy")
    np.testing.assert_array_equal(saved, np.arange(32.0).reshape(8, 4))
