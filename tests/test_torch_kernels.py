"""The port's kernel dispatch (``repro_torch.kernels.ops``) against the
reference's Pallas kernels in interpret mode and the ``torch.fft``
oracles. On CPU tensors the wrappers compute their plain versions,
which is what these tests hold against the reference; the CUDA kernels
themselves are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.fft import dft as jdft
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fft_fourstep import fft_fourstep as jax_fft_fourstep
from repro_torch.core.fft import dft
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.fft_fourstep import fft_fourstep_columns
from repro_torch.kernels.fft_stockham import fft_stockham_columns

RNG = np.random.default_rng(7)


def _pair(b, n):
    return (RNG.standard_normal((b, n)).astype(np.float32),
            RNG.standard_normal((b, n)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("b", [1, 4, 64])
@pytest.mark.parametrize("n", [128, 256, 1024])
def test_fft_dispatch_matches_reference(b, n):
    re, im = _pair(b, n)
    gr, gi = ops.fft(_t(re), _t(im))
    jr, ji = jops.fft(jnp.asarray(re), jnp.asarray(im))
    rr, ri = ref.fft_ref(_t(re), _t(im))
    scale = float(rr.abs().max()) + 1e-6
    for got, want in ((gr, np.asarray(jr)), (gi, np.asarray(ji)),
                      (gr, rr.numpy()), (gi, ri.numpy())):
        assert np.abs(got.numpy() - want).max() / scale < 5e-5


@pytest.mark.parametrize("n", [360, 257])
def test_fft_nonpow2_matches_pallas_fourstep(n):
    re, im = _pair(2, n)
    gr, gi = ops.fft(_t(re), _t(im))
    jr, ji = jax_fft_fourstep(jnp.asarray(re), jnp.asarray(im), block_b=2,
                              interpret=True)
    np.testing.assert_allclose(gr.numpy(), np.asarray(jr), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(gi.numpy(), np.asarray(ji), rtol=1e-3,
                               atol=2e-3)


@pytest.mark.parametrize("kernel", ["fourstep", "stockham"])
def test_fft_inverse_roundtrip(kernel):
    re, im = _pair(8, 512)
    fr, fi = ops.fft(_t(re), _t(im), kernel=kernel)
    br, bi = ops.fft(fr, fi, inverse=True, kernel=kernel)
    np.testing.assert_allclose(br.numpy(), re, atol=1e-4)
    np.testing.assert_allclose(bi.numpy(), im, atol=1e-4)


def test_fft_dispatch_takes_strided_views():
    re, im = _pair(16, 128)
    gr, _ = ops.fft(_t(re).t(), _t(im).t())       # (128, 16) views
    want, _ = ref.fft_ref(_t(re).t().contiguous(), _t(im).t().contiguous())
    np.testing.assert_allclose(gr.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-3)


# the column route: any axis of a 2-D or 3-D tensor, against the
# reference's fft_along through its Pallas kernels (interpret mode); the
# tolerance is test_fft_along_matches_reference's
@pytest.mark.parametrize("n", [8, 64, 128, 200, 256])
@pytest.mark.parametrize("dims,axis", [((None, 6), -2), ((3, None, 5), -2),
                                       ((None, 3, 5), -3), ((3, 5, None), -1)])
def test_fft_axis_matches_reference_fft_along(n, dims, axis):
    shape = tuple(n if d is None else d for d in dims)
    re = RNG.standard_normal(shape).astype(np.float32)
    im = RNG.standard_normal(shape).astype(np.float32)
    for inverse in (False, True):
        gr, gi = ops.fft_axis(_t(re), _t(im), axis, inverse=inverse)
        jr, ji = jdft.fft_along(jnp.asarray(re), jnp.asarray(im), axis,
                                backend="pallas", inverse=inverse)
        assert gr.shape == shape and gr.is_contiguous()
        np.testing.assert_allclose(gr.numpy() + 1j * gi.numpy(),
                                   np.asarray(jr) + 1j * np.asarray(ji),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("fn,plain,n", [
    (fft_fourstep_columns, dft.fourstep_fft, 200),
    (fft_fourstep_columns, dft.fourstep_fft, 512),
    (fft_stockham_columns, dft.stockham_fft, 128)])
def test_column_wrappers_on_cpu_take_the_plain_version(fn, plain, n):
    re, im = (_t(RNG.standard_normal((2, n, 3)).astype(np.float32))
              for _ in range(2))
    for inverse in (False, True):
        got = fn(re, im, inverse=inverse)
        want = plain(re.movedim(1, -1), im.movedim(1, -1), inverse=inverse)
        for g, w in zip(got, want):
            assert g.is_contiguous()
            torch.testing.assert_close(g, w.movedim(-1, 1), rtol=0, atol=0)


def test_build_digest_covers_headers(tmp_path):
    # a changed shared header must name a new library, so that it builds
    # anew; no nvcc needed
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    before = _build._digest(csrc)
    assert _build._digest(csrc) == before
    with open(headers[0], "ab") as f:
        f.write(b" ")
    assert _build._digest(csrc) != before
    assert _build._digest(_build.CSRC) == before


@pytest.mark.parametrize("shape", [(64, 64), (256, 200), (128, 1000)])
def test_bandpass_matches_reference(shape):
    R, C = shape
    re = RNG.standard_normal((R, C)).astype(np.float32)
    im = RNG.standard_normal((R, C)).astype(np.float32)
    mask = (RNG.random((R, C)) > 0.3).astype(np.float32)
    outr, outi, kept, tot = ops.bandpass(_t(re), _t(im), _t(mask))
    jr, ji, jk, jt = jops.bandpass(jnp.asarray(re), jnp.asarray(im),
                                   jnp.asarray(mask))
    np.testing.assert_array_equal(outr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(outi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(float(kept), float(jk), rtol=1e-5)
    np.testing.assert_allclose(float(tot), float(jt), rtol=1e-5)
    rr, ri, rk, rt = ref.bandpass_ref(_t(re), _t(im), _t(mask))
    np.testing.assert_array_equal(outr.numpy(), rr.numpy())
    np.testing.assert_allclose(float(kept), float(rk), rtol=1e-5)
    p64 = re.astype(np.float64) ** 2 + im.astype(np.float64) ** 2
    np.testing.assert_allclose(float(kept), (p64 * mask).sum(), rtol=1e-5)
    np.testing.assert_allclose(float(tot), p64.sum(), rtol=1e-5)


def test_bandpass_soft_and_bool_masks():
    re, im = _pair(32, 48)
    soft = RNG.random((32, 48)).astype(np.float32)
    outr, _, kept, _ = ops.bandpass(_t(re), _t(im), _t(soft))
    _, _, jk, _ = jref.bandpass_ref(jnp.asarray(re), jnp.asarray(im),
                                    jnp.asarray(soft))
    np.testing.assert_array_equal(outr.numpy(), re * soft)
    np.testing.assert_allclose(float(kept), float(jk), rtol=1e-5)
    boolean = _t(soft) > 0.5
    outr, _, _, _ = ops.bandpass(_t(re), _t(im), boolean)
    np.testing.assert_array_equal(outr.numpy(),
                                  re * (soft > 0.5).astype(np.float32))


def test_kernel_launch_checks_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_planes("k", torch.zeros(4, 8))
