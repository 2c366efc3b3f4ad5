"""Every mask ``repro_torch.core.fft.filters`` ports equals the
reference's, bit for bit."""
import numpy as np
import pytest
import torch

from repro.core.fft import filters as jfilters
from repro_torch.core.fft import filters

SHAPES = [(8,), (200, 200), (128, 96), (16, 12, 10)]


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.bool


@pytest.mark.parametrize("shape", SHAPES)
def test_box_masks_match_reference(shape):
    for frac in (0.0075, 0.05, 0.2, 0.5):
        _same(filters.lowpass_mask(shape, frac),
              jfilters.lowpass_mask(shape, frac))
        _same(filters.highpass_mask(shape, frac),
              jfilters.highpass_mask(shape, frac))
        _same(filters.radial_lowpass_mask(shape, frac),
              jfilters.radial_lowpass_mask(shape, frac))
    _same(filters.bandpass_mask(shape, 0.05, 0.3),
          jfilters.bandpass_mask(shape, 0.05, 0.3))
    _same(filters.twothirds_mask(shape), jfilters.twothirds_mask(shape))


def test_freq_index_and_transposed_mask_match_reference():
    for n in (1, 2, 7, 8, 200):
        np.testing.assert_array_equal(filters.freq_index(n),
                                      jfilters.freq_index(n))
    _same(filters.mask_transposed_2d(64, 48, keep_frac=0.1),
          jfilters.mask_transposed_2d(64, 48, keep_frac=0.1))
    _same(filters.mask_transposed_2d(64, 48, build=filters.twothirds_mask),
          jfilters.mask_transposed_2d(64, 48,
                                      build=jfilters.twothirds_mask))


@pytest.mark.parametrize("shape, hp", [((16, 16), 9), ((16, 16), 12),
                                       ((10, 15), 8), ((4, 6, 8), 5)])
def test_halfspec_mask_matches_reference(shape, hp):
    full = filters.lowpass_mask(shape, 0.2)
    _same(filters.halfspec_mask(full, hp),
          jfilters.halfspec_mask(jfilters.lowpass_mask(shape, 0.2), hp))
    soft = torch.rand(shape)
    np.testing.assert_array_equal(
        filters.halfspec_mask(soft, hp).numpy(),
        np.asarray(jfilters.halfspec_mask(soft.numpy(), hp)))


def test_apply_filter_matches_reference():
    rng = np.random.default_rng(3)
    re = rng.standard_normal((32, 40)).astype(np.float32)
    im = rng.standard_normal((32, 40)).astype(np.float32)
    mask = filters.lowpass_mask((32, 40), 0.1)
    r, i = filters.apply_filter(torch.from_numpy(re), torch.from_numpy(im),
                                mask)
    jr, ji = jfilters.apply_filter(re, im, jfilters.lowpass_mask((32, 40),
                                                                 0.1))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
