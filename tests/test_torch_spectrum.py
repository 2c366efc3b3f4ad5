"""The port's spectral payloads (``core/fft/spectrum.py``) and the
``stats``, ``spectrum`` and ``spectral_monitor`` endpoints against the
reference on the same seeded inputs, at the reference's tolerances
(``tests/test_insitu.py``: normalised spectra to 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fft import spectrum as jspectrum
from repro.core.insitu.bridge import BridgeData as JBridgeData
from repro.core.insitu.endpoints.spectral_monitor import \
    SpectralMonitorEndpoint as JMonitor
from repro.core.insitu.endpoints.stats import SpectrumEndpoint as JSpectrum
from repro.core.insitu.endpoints.stats import StatsEndpoint as JStats
from repro_torch.compat import make_mesh
from repro_torch.core.fft import spectrum
from repro_torch.core.insitu.bridge import BridgeData, GridMeta
from repro_torch.core.insitu.config import ENDPOINTS, build_chain
from repro_torch.core.insitu.endpoints.spectral_monitor import (
    SpectralMonitorEndpoint, tree_leaves_with_path)

RTOL = 1e-5


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("shape", [(32, 48), (8, 12, 10), (64,)])
def test_energies_and_radial_spectra_match_reference(shape):
    re, im = _pair(shape, sum(shape))
    t, j = (torch.from_numpy(re), torch.from_numpy(im)), \
        (jnp.asarray(re), jnp.asarray(im))
    _close(spectrum.total_energy(*t), jspectrum.total_energy(*j))
    _close(spectrum.band_energies(*t), jspectrum.band_energies(*j))
    for nbins in (8, 32):
        for got, want in zip(spectrum.radial_spectrum(*t, nbins),
                             jspectrum.radial_spectrum(*j, nbins)):
            _close(got, want)
    kmag = np.random.default_rng(1).random(shape) * 7
    w = np.random.default_rng(2).random(shape).astype(np.float32)
    for weights in (None, w):
        got = spectrum.radial_spectrum_k(*t, kmag, 16, weights=weights)
        want = jspectrum.radial_spectrum_k(*j, kmag, 16, weights=weights)
        for g, x in zip(got, want):
            _close(g, x)


@pytest.mark.parametrize("shape", [(4, 100), (2, 3, 256), (7, 64)])
@pytest.mark.parametrize("nbins", [8, 16])
def test_tensor_spectrum_summary_matches_reference(shape, nbins):
    x = np.random.default_rng(nbins).standard_normal(shape).astype(
        np.float32)
    _close(spectrum.tensor_spectrum_summary(torch.from_numpy(x), nbins),
           jspectrum.tensor_spectrum_summary(jnp.asarray(x), nbins))


def test_stats_endpoint_matches_reference():
    re, im = _pair((40, 56), 5)
    re = re * 3 + 1
    for arr_t, arr_j in (((torch.from_numpy(re), torch.from_numpy(im)),
                          (jnp.asarray(re), jnp.asarray(im))),
                         (torch.from_numpy(re), jnp.asarray(re))):
        got = ENDPOINTS["stats"]().execute(BridgeData(arrays={"field": arr_t}))
        want = JStats().execute(JBridgeData(arrays={"field": arr_j}))
        _close(got.arrays["insitu_stats"], want.arrays["insitu_stats"])


def test_spectrum_endpoint_matches_reference():
    re, im = _pair((32, 40), 6)
    got = ENDPOINTS["spectrum"](nbins=12).execute(BridgeData(
        arrays={"field": (torch.from_numpy(re), torch.from_numpy(im))},
        domain="spectral"))
    want = JSpectrum(nbins=12).execute(JBridgeData(
        arrays={"field": (jnp.asarray(re), jnp.asarray(im))},
        domain="spectral"))
    for key in ("insitu_spectrum_k", "insitu_spectrum_e"):
        _close(got.arrays[key], want.arrays[key])
    with pytest.raises(ValueError, match="spectral"):
        ENDPOINTS["spectrum"]().execute(BridgeData(
            arrays={"field": torch.from_numpy(re)}))


def test_spectral_monitor_matches_reference():
    rng = np.random.default_rng(9)
    tree = {"layer": {"w": rng.standard_normal((32, 128)),
                      "b": rng.standard_normal((4,)),
                      "v": rng.standard_normal((2, 3, 96))},
            "emb": [rng.standard_normal((10, 64)),
                    rng.standard_normal((5, 32))]}

    def conv(t, fn):
        if isinstance(t, dict):
            return {k: conv(v, fn) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v, fn) for v in t]
        return fn(t.astype(np.float32))

    for kw in ({}, {"nbins": 8, "max_tensors": 2, "sample_rows": 2}):
        got = SpectralMonitorEndpoint(**kw).execute(BridgeData(
            arrays={"grads": conv(tree, torch.from_numpy)}))
        want = JMonitor(**kw).execute(JBridgeData(
            arrays={"grads": conv(tree, jnp.asarray)}))
        for key in ("insitu_grad_spectra", "insitu_highfreq_frac"):
            _close(got.arrays[key], want.arrays[key])
    # the reference's own case: constant rows are pure DC
    out = SpectralMonitorEndpoint(nbins=8).execute(BridgeData(
        arrays={"grads": {"layer": {"w": torch.ones(32, 128),
                                    "b": torch.ones(4)}}}))
    np.testing.assert_allclose(out.arrays["insitu_grad_spectra"].sum(-1),
                               1.0, atol=1e-5)
    assert float(out.arrays["insitu_highfreq_frac"]) < 1e-6
    assert [p for p, _ in tree_leaves_with_path(tree)] == [
        "['emb'][0]", "['emb'][1]", "['layer']['b']", "['layer']['v']",
        "['layer']['w']"]


def test_chain_with_the_analysis_endpoints():
    """``stats`` and ``spectrum`` in a planned chain, as configured by
    name, on a one-device mesh."""
    re, _ = _pair((32, 32), 11)
    mesh = make_mesh((1,), ("data",), device="cpu")
    chain = build_chain({"mode": "intransit", "chain": [
        {"endpoint": "stats"},
        {"endpoint": "fft", "direction": "forward", "real": True},
        {"endpoint": "spectrum", "nbins": 8},
    ]}, mesh=mesh, grid=GridMeta((32, 32)))
    out = chain.execute(BridgeData(arrays={"field": torch.from_numpy(re)},
                                   grid=GridMeta((32, 32))))
    stats = out.arrays["insitu_stats"].numpy()
    np.testing.assert_allclose(stats[:3], [re.min(), re.max(), re.mean()],
                               rtol=1e-5, atol=1e-6)
    assert out.layout == "transposed-half"
    assert out.arrays["insitu_spectrum_e"].shape == (8,)
    assert set(chain.marshaling_report()["timings_s"]) == {"stats", "fft",
                                                            "spectrum"}
