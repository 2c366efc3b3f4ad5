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


@pytest.mark.parametrize("n,columns,kind,passes", [
    (64, False, "radix", 1), (8192, False, "radix", 1),
    (16384, False, "radix", 1), (8192, True, "radix", 2),
    (128, True, "radix", 1), (65536, True, "radix", 2),
    (32768, False, "mixed", 2), (65536, False, "mixed", 2),
    (1 << 20, False, "mixed", 3), (1 << 24, False, "mixed", 3),
    (1 << 20, True, "mixed", 3),
    (200, False, "mixed", 1), (200, True, "mixed", 1),
    (360, False, "mixed", 1), (10000, False, "mixed", 1),
    (10000, True, "mixed", 2), (20000, False, "mixed", 2),
    (7, False, "mixed", 1),
    (257, False, "bluestein", 5), (4097, False, "bluestein", 5),
    (10007, False, "bluestein", 7), (257, True, "bluestein", 7)])
def test_route_per_n(n, columns, kind, passes):
    r = fft_plan.route(n, columns)
    assert r.kind == kind
    assert r.launches == passes
    if kind == "mixed":
        assert len(r.lines) == passes and math.prod(r.lines) == n
        limit = (fft_plan.MIXED_LINE_MAX if columns or passes > 1
                 else fft_plan.MIXED_ROW_MAX)
        assert max(r.lines) <= limit
        assert fft_plan.mixed_smem_bytes(
            1 if passes == 1 and not columns else fft_plan.LINE_TILE,
            max(r.lines)) <= fft_plan.SMEM_MAX
        assert list(r.plan)[0] == passes
    if kind == "bluestein":
        assert r.m == fft_plan.bluestein_size(n)
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
    m = fft_plan.bluestein_size(n)
    assert m & (m - 1) == 0 and m >= 2 * n - 1 and (m == 1 or m // 2 < 2 * n - 1)


@pytest.mark.parametrize("n", [7, 257, 4097, 10007])
def test_chirp_table_matches_numpy(n):
    e = np.array(fft_plan.chirp_exponents(n), dtype=np.int64)
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
    a power-of-two circular convolution of M points with conj(chirp)."""
    n = x.shape[-1]
    m = fft_plan.bluestein_size(n)
    e = torch.tensor(fft_plan.chirp_exponents(n), dtype=torch.float64)
    chirp = torch.exp(sign * 1j * math.pi * e / n)
    a = torch.zeros(*x.shape[:-1], m, dtype=torch.complex128)
    a[..., :n] = x * chirp
    b = torch.zeros(m, dtype=torch.complex128)
    b[:n] = chirp.conj()
    b[m - n + 1:] = chirp[1:].conj().flip(0)
    lines = fft_plan.stages(m, False)
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


@pytest.mark.parametrize("n", [7, 257, 4097, 10007])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_bluestein_matches_numpy(n, inverse):
    x = _signal(2, n, seed=n)
    got = _bluestein(torch.from_numpy(x), 1.0 if inverse else -1.0).numpy()
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
