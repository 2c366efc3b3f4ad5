"""``repro_torch.core.fft.dft`` against ``repro.core.fft.dft`` on the same
numpy inputs, plus the DFT properties ``tests/test_fft_local.py`` checks
on the reference."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.fft import dft as jdft
from repro_torch.core.fft import dft

RNG = np.random.default_rng(42)


def _rand(b, n):
    return (RNG.standard_normal((b, n)).astype(np.float32),
            RNG.standard_normal((b, n)).astype(np.float32))


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_split_factor_matches_reference():
    for n in range(2, 1025):
        assert dft.split_factor(n) == jdft.split_factor(n), n
    assert dft.split_factor(200) == (10, 20)
    assert dft.split_factor(360) == (18, 20)
    assert dft.split_factor(257) == (1, 257)


@pytest.mark.parametrize("n", [64, 200, 360, 1024])
def test_fourstep_matches_reference(n):
    re, im = _rand(3, n)
    for inverse in (False, True):
        r, i = dft.fourstep_fft(_t(re), _t(im), inverse=inverse)
        jr, ji = jdft.fourstep_fft(jnp.asarray(re), jnp.asarray(im),
                                   inverse=inverse)
        np.testing.assert_allclose(_c(r, i), _c(jr, ji), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("n", [8, 256])
def test_stockham_matches_reference(n):
    re, im = _rand(3, n)
    for inverse in (False, True):
        r, i = dft.stockham_fft(_t(re), _t(im), inverse=inverse)
        jr, ji = jdft.stockham_fft(jnp.asarray(re), jnp.asarray(im),
                                   inverse=inverse)
        np.testing.assert_allclose(_c(r, i), _c(jr, ji), rtol=1e-5,
                                   atol=1e-4)


def test_stockham_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        dft.stockham_fft(torch.zeros(2, 12), torch.zeros(2, 12))


@pytest.mark.parametrize("backend",
                         ["auto", "fourstep", "stockham", "jnp", "pallas"])
@pytest.mark.parametrize("n", [32, 256])
def test_local_fft_backends_match_reference(backend, n):
    re, im = _rand(4, n)
    r, i = dft.local_fft(_t(re), _t(im), backend=backend)
    jr, ji = jdft.local_fft(jnp.asarray(re), jnp.asarray(im),
                            backend=backend)
    np.testing.assert_allclose(_c(r, i), _c(jr, ji), rtol=1e-4, atol=1e-3)
    ref = np.fft.fft(_c(re, im), axis=-1)
    np.testing.assert_allclose(_c(r, i), ref, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_fft_along_matches_reference(axis, backend):
    re = RNG.standard_normal((2, 64, 48)).astype(np.float32)
    im = RNG.standard_normal((2, 64, 48)).astype(np.float32)
    r, i = dft.fft_along(_t(re), _t(im), axis, backend=backend)
    jr, ji = jdft.fft_along(jnp.asarray(re), jnp.asarray(im), axis,
                            backend=backend)
    np.testing.assert_allclose(_c(r, i), _c(jr, ji), rtol=1e-4, atol=1e-3)
    ref = np.fft.fft(_c(re, im), axis=axis)
    np.testing.assert_allclose(_c(r, i), ref, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n", [8, 64, 128, 200, 256])
@pytest.mark.parametrize("dims,axis", [((5, None), -1), ((None, 4, 3), -3),
                                       ((2, None, 3), -2)])
def test_fft_along_pallas_axes_match_reference(n, dims, axis):
    # 2-D and 3-D, every axis: the pallas backend against the reference's
    # (its Pallas kernels in interpret mode), with the tolerance of
    # test_fft_along_matches_reference
    shape = tuple(n if d is None else d for d in dims)
    re = RNG.standard_normal(shape).astype(np.float32)
    im = RNG.standard_normal(shape).astype(np.float32)
    r, i = dft.fft_along(_t(re), _t(im), axis, backend="pallas")
    jr, ji = jdft.fft_along(jnp.asarray(re), jnp.asarray(im), axis,
                            backend="pallas")
    assert r.shape == shape
    np.testing.assert_allclose(_c(r, i), _c(jr, ji), rtol=1e-4, atol=1e-3)
    ref = np.fft.fft(_c(re, im), axis=axis)
    np.testing.assert_allclose(_c(r, i), ref, rtol=2e-4, atol=2e-3)


def test_dft_helpers_match_reference():
    for n, sign in ((8, -1.0), (20, 1.0), (128, -1.0)):
        for got, want in zip(dft.dft_matrix(n, sign),
                             jdft.dft_matrix(n, sign)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
    for got, want in zip(dft.twiddle(10, 20, -1.0),
                         jdft.twiddle(10, 20, -1.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    z = RNG.standard_normal(6) + 1j * RNG.standard_normal(6)
    re, im = dft.to_pair(torch.from_numpy(z.astype(np.complex64)))
    np.testing.assert_array_equal(dft.to_complex((re, im)).numpy(),
                                  z.astype(np.complex64))


# ---------------------------------------------------------------------------
# Property-based: DFT invariants
# ---------------------------------------------------------------------------

sizes = st.sampled_from([16, 64, 128, 512])
seeds = st.integers(0, 2**31 - 1)
backends = st.sampled_from(["fourstep", "stockham", "pallas"])


@given(n=sizes, seed=seeds, a=st.floats(-3, 3), b=st.floats(-3, 3),
       backend=backends)
@settings(max_examples=20, deadline=None)
def test_linearity(n, seed, a, b, backend):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((2, n)).astype(np.float32))
    y = _t(rng.standard_normal((2, n)).astype(np.float32))
    fx = dft.local_fft(x[:1], x[1:], backend=backend)
    fy = dft.local_fft(y[:1], y[1:], backend=backend)
    a, b = float(np.float32(a)), float(np.float32(b))
    fz = dft.local_fft(a * x[:1] + b * y[:1], a * x[1:] + b * y[1:],
                       backend=backend)
    lhs = _c(*fz)
    rhs = a * _c(*fx) + b * _c(*fy)
    scale = np.abs(rhs).max() + 1.0
    assert np.abs(lhs - rhs).max() / scale < 1e-4


@given(n=sizes, seed=seeds, backend=backends)
@settings(max_examples=20, deadline=None)
def test_parseval(n, seed, backend):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((1, n)).astype(np.float32)
    im = rng.standard_normal((1, n)).astype(np.float32)
    r, i = dft.local_fft(_t(re), _t(im), backend=backend)
    e_time = float((re.astype(np.float64) ** 2
                    + im.astype(np.float64) ** 2).sum())
    e_freq = float((r.double() ** 2 + i.double() ** 2).sum()) / n
    assert abs(e_time - e_freq) / e_time < 1e-4
