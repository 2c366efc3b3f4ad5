"""The port's real-input (r2c/c2r) transforms against the reference on the
same seeded inputs: the half-spectrum maps and extents, the five
schedule builders' stage lists, one-device ``rfft2_slab`` /
``irfft2_slab`` / ``rfft_chain_2d`` and the real chain through
``build_chain``; then every r2c/c2r decomposition, forward and back,
batched and not, on four ranks, overlap chunking, and
``examples/insitu_rfft_batched.py``'s chain across the ranks.

The four-rank reference runs once, in a subprocess with four host
devices; the port runs once, over four spawned gloo CPU processes
(``torch_ranks.py``). The bar is the reference's: 1e-4 of max |ref|
(``tests/test_rfft.py:57-59``)."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as T
from repro.compat import make_mesh as jax_make_mesh
from repro.core.fft import rfft as jrfft
from repro.core.fft.filters import lowpass_mask as jlowpass_mask
from repro.core.insitu.bridge import BridgeData as JBridgeData
from repro.core.insitu.bridge import GridMeta as JGridMeta
from repro.core.insitu.config import build_chain as jax_build_chain
from repro_torch.compat import make_mesh
from repro_torch.core.fft import filters, rfft
from repro_torch.core.fft.filters import lowpass_mask
from repro_torch.core.insitu.bridge import BridgeData, GridMeta
from repro_torch.core.insitu.config import build_chain

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-4
FIELD_TOL = 1e-4
ENERGY_TOL = 1e-5


class StubMesh:
    """What the builders and extents read of a mesh: its axis extents."""

    def __init__(self, shape=None):
        self.shape = shape or {"data": 4, "model": 2}


# ---------------------------------------------------------------------------
# Half-spectrum maps and extents (the values of tests/test_rfft.py:64-112)
# ---------------------------------------------------------------------------

def test_half_bins_and_padding():
    for n, p in ((96, 4), (8, 2), (24, 2), (8193, 4), (10000, 4), (7, 3)):
        assert rfft.half_bins(n) == jrfft.half_bins(n)
        assert rfft.padded_half(n, p) == jrfft.padded_half(n, p)
    assert rfft.half_bins(96) == 49
    assert rfft.padded_half(96, 4) == 52
    assert rfft.padded_half(8, 2) == 6


def test_spectral_half_extent_per_decomp():
    mesh, names = StubMesh(), ("data", "model")
    cases = [("slab", 96, ("data",), 52), ("slab3d", 24, ("data",), 13),
             ("pencil", 24, names, 14), ("pencil_tf", 24, names, 14),
             ("pencil2d", 56, names, 32)]
    for decomp, n, axes, want in cases:
        assert rfft.spectral_half_extent(decomp, n, mesh, axes) == want
        assert jrfft.spectral_half_extent(decomp, n, mesh, axes) == want
    with pytest.raises(ValueError, match="fourstep1d"):
        rfft.spectral_half_extent("fourstep1d", 64, mesh, ("data",))


@pytest.mark.parametrize("n,hp", [(24, 14), (24, 13), (9, 8), (96, 52)])
def test_halfspec_maps_match_reference(n, hp):
    freq = rfft.halfspec_freq_of_position(n, hp)
    pos = rfft.halfspec_position_of_freq(n)
    np.testing.assert_array_equal(freq,
                                  jrfft.halfspec_freq_of_position(n, hp))
    np.testing.assert_array_equal(pos, jrfft.halfspec_position_of_freq(n))
    h = rfft.half_bins(n)
    full_mask = np.arange(n) % 3 == 0
    half = np.array([bool(full_mask[k]) if k >= 0 else False for k in freq])
    assert half[:h].tolist() == full_mask[:h].tolist()
    assert not half[h:].any()
    for k in range(n):
        assert freq[pos[k]] == min(k, n - k)


@pytest.mark.parametrize("build", ["r2c", "pencil_tf_r2c", "halfspec"])
def test_half_spectrum_masks_match_reference(build):
    from repro.core.fft import filters as jfilters
    if build == "r2c":
        for shape, hp in (((16, 24), None), ((8, 12, 16), 10)):
            got = filters.mask_r2c(shape, hp, keep_frac=0.2)
            want = jfilters.mask_r2c(shape, hp, keep_frac=0.2)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif build == "pencil_tf_r2c":
        got = filters.mask_pencil_tf_3d_r2c((8, 12, 16), 2, 10,
                                            keep_frac=0.2)
        want = jfilters.mask_pencil_tf_3d_r2c((8, 12, 16), 2, 10,
                                              keep_frac=0.2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        m = lowpass_mask((16, 24), 0.2)
        np.testing.assert_array_equal(
            rfft.half_mask(m).numpy(),
            np.asarray(jrfft.half_mask(jlowpass_mask((16, 24), 0.2))))


# ---------------------------------------------------------------------------
# The five builders' stage lists
# ---------------------------------------------------------------------------

def _stages(sched):
    return [(type(st).__name__, dataclasses.asdict(st))
            for st in sched.stages]


@pytest.mark.parametrize("decomp", sorted(rfft.RFFT_BUILDERS))
@pytest.mark.parametrize("inverse", [False, True])
def test_builders_match_reference(decomp, inverse):
    build, naxes = rfft.RFFT_BUILDERS[decomp]
    jbuild, jnaxes = jrfft.RFFT_BUILDERS[decomp]
    assert naxes == jnaxes
    axes = ("data", "model") if naxes == 2 else "data"
    n_a2a = {"slab": 1, "slab3d": 1, "pencil": 2, "pencil_tf": 2,
             "pencil2d": 3}[decomp]
    for wire in (None, "bfloat16", "int8_block64",
                 ("int8",) + (None,) * (n_a2a - 1)):
        got = build(22, StubMesh(), axes, inverse=inverse, backend="pallas",
                    wire_dtype=wire)
        want = jbuild(22, StubMesh(), axes, inverse=inverse,
                      backend="pallas", wire_dtype=wire)
        assert _stages(got) == _stages(want)
        assert (got.name, got.rank, got.in_spec, got.out_spec,
                got.in_arity, got.out_arity) == (
            want.name, want.rank, want.in_spec, want.out_spec,
            want.in_arity, want.out_arity)


def test_overlap_site_of_real_schedules_matches_reference():
    """A real endcap before the first exchange owns the last axis, so
    chunking along it is refused, as the reference refuses it; the
    builders' schedules chunk elsewhere."""
    from repro.core.fft import schedule as JS
    from repro_torch.core.fft import schedule as S
    for mod in (S, JS):
        bad = mod.Schedule("r", 2, (mod.LocalRFFT(8),
                                    mod.AllToAll("data", -2, -1, 4)),
                           ("data", None), (None, "data"), 1, 2)
        with pytest.raises(ValueError, match="real endcap"):
            mod.overlap_site(bad)

    def site(mod, sched):
        try:
            return mod.overlap_site(sched)
        except ValueError as e:         # ineligible: the same reason
            return str(e)

    for decomp, (build, naxes) in rfft.RFFT_BUILDERS.items():
        axes = ("data", "model") if naxes == 2 else "data"
        for inverse in (False, True):
            got = site(S, build(22, StubMesh(), axes, inverse=inverse))
            want = site(JS, jrfft.RFFT_BUILDERS[decomp][0](
                22, StubMesh(), axes, inverse=inverse))
            assert got == want


# ---------------------------------------------------------------------------
# One device against the reference
# ---------------------------------------------------------------------------

def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(64, 96), (2, 16, 24), (30, 50)])
def test_one_device_slab_round_trip_matches_reference(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    mesh = make_mesh((1,), ("data",), device="cpu")
    jmesh = jax_make_mesh((1,), ("data",))
    re, im = rfft.rfft2_slab(torch.from_numpy(x), mesh, backend="pallas")
    jre, jim = jrfft.rfft2_slab(jnp.asarray(x), jmesh, backend="pallas")
    got, want = (re + 1j * im).numpy(), np.asarray(jre) + 1j * np.asarray(jim)
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    assert _rel(got, np.fft.rfft2(x)) < TOL
    y = rfft.irfft2_slab(re, im, shape[-1], mesh, backend="pallas")
    jy = jrfft.irfft2_slab(jre, jim, shape[-1], jmesh, backend="pallas")
    assert np.abs(y.numpy() - np.asarray(jy)).max() < TOL
    assert np.abs(y.numpy() - x).max() < TOL


def test_one_device_rfft_chain_matches_reference():
    x = np.random.default_rng(4).standard_normal((64, 96)).astype(
        np.float32)
    got = rfft.rfft_chain_2d(torch.from_numpy(x), lowpass_mask((64, 96), 0.2),
                             make_mesh((1,), ("data",), device="cpu"))
    want = jrfft.rfft_chain_2d(jnp.asarray(x), jlowpass_mask((64, 96), 0.2),
                               jax_make_mesh((1,), ("data",)))
    ref = np.real(np.fft.ifft2(np.fft.fft2(x)
                               * lowpass_mask((64, 96), 0.2).numpy()))
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
    assert np.abs(got.numpy() - ref).max() < TOL


def _batch_fields():
    b, n0, n1 = T.RFFT_BATCH
    yy, xx = np.meshgrid(np.arange(n0), np.arange(n1), indexing="ij")
    clean = np.stack([np.sin(2 * np.pi * k * (xx + 2 * yy) / n0) / k
                      for k in (2, 3, 4, 5)]).astype(np.float32)
    rng = np.random.default_rng(0)
    noise = 0.5 * rng.standard_normal((b, n0, n1)).astype(np.float32)
    return clean, clean + noise


def _batch_chain_cfg():
    return {"mode": "insitu", "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "real": True, "batch_ndim": 1},
        {"endpoint": "bandpass", "array": "field",
         "keep_frac": T.RFFT_KEEP_FRAC, "use_kernel": False},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "real": True, "batch_ndim": 1}]}


@pytest.mark.parametrize("mode", ["insitu", "intransit"])
def test_real_chain_batched_matches_reference(mode):
    """The real chain through ``build_chain`` with ``batch_ndim=1`` on a
    one-device mesh: spectra tagged ``*-half``, field and energies as the
    reference's chain gives them."""
    clean, fields = _batch_fields()
    dims = T.RFFT_BATCH[1:]
    cfg = dict(_batch_chain_cfg(), mode=mode)
    jout = jax_build_chain(cfg, mesh=jax_make_mesh((1,), ("data",)),
                           grid=JGridMeta(dims)).execute(
        JBridgeData(arrays={"field": jnp.asarray(fields)},
                    grid=JGridMeta(dims)))
    chain = build_chain(cfg, mesh=make_mesh((1,), ("data",), device="cpu"),
                        grid=GridMeta(dims))
    fwd = chain.endpoints[0].execute(BridgeData(
        arrays={"field": torch.from_numpy(fields)}, grid=GridMeta(dims)))
    assert fwd.layout == "transposed-half" and fwd.domain == "spectral"
    assert fwd.arrays["field"][0].shape == (4, 128, 65)
    out = chain.execute(BridgeData(arrays={"field": torch.from_numpy(fields)},
                                   grid=GridMeta(dims)))
    den = out.arrays["field"].numpy()
    assert den.shape == fields.shape and out.layout == "natural"
    assert np.abs(den - np.asarray(jout.arrays["field"])).max() < FIELD_TOL
    for key in ("insitu_kept_energy", "insitu_total_energy"):
        want = float(jout.arrays[key])
        assert abs(float(out.arrays[key]) - want) / want < ENERGY_TOL
    for b in range(fields.shape[0]):
        assert (np.mean((den[b] - clean[b]) ** 2)
                < np.mean((fields[b] - clean[b]) ** 2))


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, sys.argv[3])
    import torch_ranks as T
    from repro.compat import make_mesh
    from repro.core.fft.plan import plan_rfft
    from repro.core.insitu.bridge import BridgeData, GridMeta
    from repro.core.insitu.config import build_chain

    inputs = dict(np.load(sys.argv[1]))
    meshes = {k: make_mesh(s, n) for k, (s, n) in T.MESHES.items()}
    out = {}
    for decomp, direction, batched in T.RFFT_CASES:
        cid = T.case_id(decomp, direction, batched)
        mesh = meshes[T.RFFT_DECOMPS[decomp][0]]
        plan = plan_rfft(T.RFFT_DECOMPS[decomp][1], direction, mesh,
                         decomp=decomp, backend="pallas",
                         batch_ndim=int(batched))
        y = plan.execute(*plan.place(inputs["rin_" + cid]))
        out["rout_" + cid] = (np.asarray(y[0]) + 1j * np.asarray(y[1])
                              if direction == "forward" else np.asarray(y))
    grid = GridMeta(T.RFFT_BATCH[1:])
    chain = build_chain({"mode": "insitu", "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "real": True, "batch_ndim": 1},
        {"endpoint": "bandpass", "array": "field",
         "keep_frac": T.RFFT_KEEP_FRAC, "use_kernel": False},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "real": True, "batch_ndim": 1}]}, mesh=meshes["1d"], grid=grid)
    res = chain.execute(BridgeData(
        arrays={"field": jnp.asarray(inputs["batch_fields"])}, grid=grid))
    out["batch_field"] = np.asarray(res.arrays["field"])
    out["batch_energies"] = np.array(
        [float(res.arrays["insitu_kept_energy"]),
         float(res.arrays["insitu_total_energy"])])
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(17)
    out = {}
    for decomp, direction, batched in T.RFFT_CASES:
        mkey, grid = T.RFFT_DECOMPS[decomp]
        shape = grid
        if direction == "backward":
            extents, names = T.MESHES[mkey]
            hp = rfft.spectral_half_extent(
                decomp, grid[-1], StubMesh(dict(zip(names, extents))),
                names)
            shape = grid[:-1] + (hp,)
        shape = (T.BATCH,) * batched + shape
        x = rng.standard_normal(shape)
        if direction == "backward":
            x = x + 1j * rng.standard_normal(shape)
            out["rin_" + T.case_id(decomp, direction, batched)] = \
                x.astype(np.complex64)
        else:
            out["rin_" + T.case_id(decomp, direction, batched)] = \
                x.astype(np.float32)
    clean, fields = _batch_fields()
    out["batch_clean"], out["batch_fields"] = clean, fields
    return out


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp("jax")
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(work / "inputs.npz"),
         str(work / "out.npz"), str(Path(__file__).parent)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(work / "out.npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    return T.run_ranks("rfft", tmp_path_factory.mktemp("ranks"), inputs)


@pytest.mark.parametrize("decomp,direction,batched", T.RFFT_CASES,
                         ids=[T.case_id(*c) for c in T.RFFT_CASES])
def test_real_decomposition_matches_reference(decomp, direction, batched,
                                              reference, port):
    cid = T.case_id(decomp, direction, batched)
    got, want = port["rout_" + cid], reference["rout_" + cid]
    assert got.shape == want.shape
    assert got.dtype == (np.complex64 if direction == "forward"
                         else np.float32)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("decomp", sorted(T.RFFT_DECOMPS))
def test_real_overlap_chunking_is_bit_identical(decomp, port):
    assert bool(port[f"roverlap_{decomp}"])


def test_batched_real_chain_across_ranks(inputs, reference, port):
    """examples/insitu_rfft_batched.py's chain on four ranks: its asserts
    (every field's MSE improves), the reference's field and energies, and
    the second step served from the plan cache."""
    clean, fields = inputs["batch_clean"], inputs["batch_fields"]
    for step in (0, 1):
        den = port[f"batch_step{step}_field"]
        assert den.shape == fields.shape and np.isfinite(den).all()
        assert str(port[f"batch_step{step}_layout"]) == "natural"
        assert np.abs(den - reference["batch_field"]).max() < FIELD_TOL
        for b in range(fields.shape[0]):
            assert (np.mean((den[b] - clean[b]) ** 2)
                    < np.mean((fields[b] - clean[b]) ** 2))
        energies = port[f"batch_step{step}_energies"]
        jkept, jtotal = reference["batch_energies"]
        assert np.abs(energies[:, 0] - jkept).max() / jkept < ENERGY_TOL
        assert np.abs(energies[:, 1] - jtotal).max() / jtotal < ENERGY_TOL
    assert int(port["batch_step0_new_plans"]) == 2
    assert int(port["batch_step1_new_plans"]) == 0


@pytest.mark.parametrize("real", [False, True])
def test_analysis_endpoints_across_ranks(real, port):
    """``stats`` and ``spectrum`` on four ranks' blocks publish on every
    rank what one device publishes for the whole field."""
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    dims = T.CHAINS["slab"][1]
    data = RadiatingSourceAdaptor(dims, device="cpu").produce(0)
    chain = build_chain({"mode": "insitu", "chain": [
        {"endpoint": "stats"},
        {"endpoint": "fft", "direction": "forward", "real": real},
        {"endpoint": "spectrum", "nbins": 16}]},
        mesh=make_mesh((1,), ("data",), device="cpu"), grid=data.grid)
    res = chain.execute(data)
    want = [res.arrays[k].numpy() for k in
            ("insitu_stats", "insitu_spectrum_k", "insitu_spectrum_e")]
    if real:
        # the spectrum reads frequencies over the array's global shape,
        # as the reference does: on four ranks the half axis is padded
        # to a multiple of 4 (52), on one device it is not (49)
        from repro_torch.core.fft import spectrum
        hp = rfft.padded_half(dims[-1], 4)
        re, im = (torch.nn.functional.pad(v, (0, hp - v.shape[-1]))
                  for v in res.arrays["field"])
        want[1:] = [v.numpy() for v in spectrum.radial_spectrum(re, im, 16)]
    for rank in port[f"analysis_real{int(real)}"]:
        for got, w in zip(rank, want):
            np.testing.assert_allclose(np.asarray(got), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
