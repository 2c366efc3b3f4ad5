"""The Fig. 2 in-situ chain in the port against the same chain in the
reference, both on a one-device mesh with ``backend: "pallas"`` FFT
endpoints (the reference's Pallas kernels in interpret mode, the port's
kernel wrappers on CPU tensors), plus the ``local=True`` quickstart."""
import functools

import numpy as np
import pytest
import torch

from repro.compat import make_mesh as jax_make_mesh
from repro.core.insitu.adaptors import RadiatingSourceAdaptor as JaxSource
from repro.core.insitu.config import build_chain as jax_build_chain
from repro_torch.compat import make_mesh
from repro_torch.core.fft.filters import lowpass_mask
from repro_torch.core.insitu import bridge
from repro_torch.core.insitu.adaptors import (RadiatingSourceAdaptor,
                                              radiating_field)
from repro_torch.core.insitu.config import build_chain
from repro_torch.kernels import ops


def fig2(mode, out_dir):
    return {"mode": mode, "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "backend": "pallas"},
        {"endpoint": "bandpass", "array": "field", "keep_frac": 0.05},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "backend": "pallas"},
        {"endpoint": "writer", "array": "field", "out_dir": str(out_dir)},
    ]}


@functools.lru_cache(maxsize=None)
def jax_fig2(dims, out_dir):
    data = JaxSource(dims=dims).produce(step=0)
    chain = jax_build_chain(fig2("intransit", out_dir),
                            mesh=jax_make_mesh((1,), ("data",)),
                            grid=data.grid)
    out = chain.execute(data)
    return (np.asarray(out.arrays["field"]),
            float(out.arrays["insitu_kept_energy"]),
            float(out.arrays["insitu_total_energy"]))


@pytest.mark.parametrize("dims", [(128, 128), (200, 200)])
@pytest.mark.parametrize("mode", ["insitu", "intransit"])
def test_fig2_chain_matches_reference(dims, mode, tmp_path_factory):
    want, jkept, jtotal = jax_fig2(
        dims, str(tmp_path_factory.getbasetemp() / "jax"))
    mesh = make_mesh((1,), ("data",), device="cpu")
    data = RadiatingSourceAdaptor(dims, mesh=mesh).produce(0)
    assert data.arrays["field"].device.type == "cpu"
    out_dir = tmp_path_factory.mktemp("port")
    chain = build_chain(fig2(mode, out_dir), mesh=mesh, grid=data.grid)
    counts = (ops.fft_fourstep.launches, ops.fft_stockham.launches,
              ops.bandpass_filter.launches)
    out = chain.execute(data)
    got = out.arrays["field"].numpy()
    assert got.shape == dims and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(float(out.arrays["insitu_kept_energy"]),
                               jkept, rtol=1e-5)
    np.testing.assert_allclose(float(out.arrays["insitu_total_energy"]),
                               jtotal, rtol=1e-5)
    # CPU tensors take the plain versions: no kernel launched
    assert counts == (ops.fft_fourstep.launches, ops.fft_stockham.launches,
                      ops.bandpass_filter.launches) == (0, 0, 0)
    report = chain.marshaling_report()
    assert report["mode"] == mode and report["reshard_bytes"] == 0
    stages = {"device"} if mode == "insitu" else {"fft", "bandpass"}
    assert stages | {"writer"} == set(report["timings_s"])
    files = chain.finalize()["writer"]["files"]
    np.testing.assert_array_equal(np.load(files[0]), got)


def test_quickstart_local_chain(tmp_path):
    """examples/quickstart.py's chain dict, run by the port, passes the
    quickstart's own asserts."""
    source = RadiatingSourceAdaptor(dims=(200, 200), device="cpu")
    data = source.produce(step=0)
    out_dir = str(tmp_path)
    chain = build_chain({"mode": "intransit", "chain": [
        {"endpoint": "visualize", "array": "field", "out_dir": out_dir,
         "prefix": "a_noisy"},
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "local": True},
        {"endpoint": "visualize", "array": "field", "out_dir": out_dir,
         "prefix": "b_spectrum", "log_scale": True},
        {"endpoint": "bandpass", "array": "field", "keep_frac": 0.05},
        {"endpoint": "visualize", "array": "field", "out_dir": out_dir,
         "prefix": "c_filtered", "log_scale": True},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "local": True},
        {"endpoint": "visualize", "array": "field", "out_dir": out_dir,
         "prefix": "d_denoised"},
        {"endpoint": "writer", "array": "field", "out_dir": out_dir},
    ]}, mesh=None, grid=data.grid)
    out = chain.execute(data)
    clean = data.arrays["clean_reference"].numpy()
    noisy = data.arrays["field"].numpy()
    denoised = out.arrays["field"].numpy()
    mse0 = float(np.mean((noisy - clean) ** 2))
    mse1 = float(np.mean((denoised - clean) ** 2))
    files = chain.finalize()
    n_images = sum(len(v.get("files", ())) for k, v in files.items()
                   if k.startswith("visualize"))
    assert mse1 < 0.5 * mse0, "bandpass failed to denoise"
    assert n_images >= 4, "a visualize stage lost its output"
    names = {p.name for p in tmp_path.iterdir()}
    for prefix in ("a_noisy", "b_spectrum", "c_filtered", "d_denoised"):
        assert f"{prefix}_000000.pgm" in names, names
    # the local path and the planned kernel path denoise alike
    mesh = make_mesh((1,), ("data",), device="cpu")
    planned = build_chain(fig2("insitu", tmp_path / "planned"), mesh=mesh,
                          grid=data.grid).execute(data)
    np.testing.assert_allclose(planned.arrays["field"].numpy(), denoised,
                               atol=1e-4)


def test_source_matches_reference_and_defaults_to_cuda():
    noisy, clean = radiating_field((64, 80), seed=3)
    jdata = JaxSource(dims=(64, 80)).produce(step=3)
    np.testing.assert_array_equal(noisy, np.asarray(jdata.arrays["field"]))
    np.testing.assert_array_equal(
        clean, np.asarray(jdata.arrays["clean_reference"]))
    assert RadiatingSourceAdaptor((4, 4)).device.type == "cuda"
    mesh = make_mesh((1,), ("data",), device="cpu")
    assert RadiatingSourceAdaptor((4, 4), mesh=mesh).device.type == "cpu"


def test_source_publishes_the_block_its_spec_names():
    # rank 2 of a (4,) mesh under ("data", None): rows 32..47 of the
    # seeded field; no spec: the whole field
    from repro_torch.compat import Mesh
    noisy, clean = radiating_field((64, 80), seed=3)
    mesh = Mesh(("data",), {"data": 4}, torch.device("cpu"), {"data": 2})
    data = RadiatingSourceAdaptor((64, 80), mesh=mesh,
                                  spec=("data", None)).produce(3)
    assert data.spec == ("data", None)
    np.testing.assert_array_equal(data.arrays["field"].numpy(),
                                  noisy[32:48])
    np.testing.assert_array_equal(data.arrays["clean_reference"].numpy(),
                                  clean[32:48])
    whole = RadiatingSourceAdaptor((64, 80), mesh=mesh).produce(3)
    assert whole.spec is None
    np.testing.assert_array_equal(whole.arrays["field"].numpy(), noisy)
    with pytest.raises(ValueError, match="mesh"):
        RadiatingSourceAdaptor((64, 80), spec=("data", None), device="cpu")


def test_bridge_numpy_round_trip():
    jdata = JaxSource(dims=(16, 24)).produce(step=1)
    arrays = {k: np.asarray(v) for k, v in jdata.arrays.items()}
    arrays["spec"] = (np.ones((16, 24), np.float32),
                      np.zeros((16, 24), np.float32))
    data = bridge.from_numpy(arrays, jdata.grid.dims, step=1, device="cpu",
                             meta={"primary": "field"})
    assert data.grid == bridge.GridMeta((16, 24)) and data.step == 1
    assert data.primary() == "field"
    back = bridge.to_numpy(data)
    np.testing.assert_array_equal(back["field"], arrays["field"])
    np.testing.assert_array_equal(back["spec"][0], arrays["spec"][0])
    re, im = data.get_pair()
    assert float(im.abs().max()) == 0.0 and re.dtype == torch.float32


def test_unported_chain_features_raise(tmp_path):
    # the pipelined mode, once refused here, has its own tests
    # (tests/test_torch_pipeline.py)
    with pytest.raises(KeyError):
        build_chain({"chain": [{"endpoint": "nope"}]})
    mesh = make_mesh((1,), ("data",), device="cpu")
    grid = bridge.GridMeta((16, 16))
    # the stats endpoint and real FFT plans, once refused, now build
    stats = build_chain({"chain": [{"endpoint": "stats"}]})
    assert [ep.name for ep in stats.endpoints] == ["stats"]
    real = build_chain({"chain": [{"endpoint": "fft", "real": True}]},
                       mesh=mesh, grid=grid)
    assert real.endpoints[0].plan.real
    assert real.endpoints[0].plan.schedule().name == "rfft_slab"
    # bandpass on a digit-permuted layout, once refused: over one shard
    # the four-step digit order is the natural order
    re, im = torch.randn(16, 16), torch.randn(16, 16)
    spectral = bridge.BridgeData(arrays={"field": (re, im)}, grid=grid,
                                 domain="spectral", layout="fourstep")
    chain = build_chain({"chain": [{"endpoint": "bandpass",
                                    "keep_frac": 0.25}]}, mesh=mesh,
                        grid=grid)
    out = chain.execute(spectral)
    m = lowpass_mask((16, 16), 0.25).float()
    assert torch.equal(out.arrays["field"][0], re * m)
    assert torch.equal(out.arrays["field"][1], im * m)
