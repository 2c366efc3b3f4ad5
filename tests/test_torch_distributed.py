"""The port's distributed main path against the reference on the same
seeded inputs: every decomposition (slab, slab3d, pencil, pencil_tf,
pencil2d, fourstep1d), forward and backward, batched and not, on a
(4,) or (2, 2) mesh; overlap chunking; and the Fig. 2 chain across
four ranks.

The reference runs once, in a subprocess with four host devices
(``--xla_force_host_platform_device_count=4``, as
``tests/test_fft_distributed.py`` does); the port runs once, over four
spawned gloo CPU processes (``torch_ranks.py``). Each case then
compares the gathered global arrays at the reference's bar: 1e-4 of
max |ref| (``tests/test_fft_distributed.py:110-119``)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_ranks as T
from repro_torch.core.fft import distributed as D
from repro_torch.core.fft import filters

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-4
FIELD_TOL = 1e-4
ENERGY_TOL = 1e-5

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, sys.argv[3])
    import torch_ranks as T
    from repro.compat import make_mesh
    from repro.core.fft.plan import plan_dft
    from repro.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro.core.insitu.bridge import BridgeData, GridMeta
    from repro.core.insitu.config import build_chain

    inputs = dict(np.load(sys.argv[1]))
    meshes = {k: make_mesh(s, n) for k, (s, n) in T.MESHES.items()}
    out = {}
    for decomp, direction, batched in T.CASES:
        cid = T.case_id(decomp, direction, batched)
        mesh = meshes[T.DECOMPS[decomp][0]]
        plan = plan_dft(T.DECOMPS[decomp][1], direction, mesh,
                        decomp=decomp, backend="pallas",
                        batch_ndim=int(batched))
        r, i = plan.execute(*plan.place(inputs["in_" + cid]))
        out["out_" + cid] = np.asarray(r) + 1j * np.asarray(i)
    specs = {"slab": P("data", None), "pencil2d": P("data", "model")}
    for decomp, (mkey, dims) in T.CHAINS.items():
        mesh = meshes[mkey]
        data = RadiatingSourceAdaptor(
            dims, sharding=NamedSharding(mesh, specs[decomp])).produce(0)
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": decomp},
            {"endpoint": "bandpass", "keep_frac": T.KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": decomp}]}, mesh=mesh, grid=data.grid)
        res = chain.execute(data)
        out[f"chain_{decomp}_field"] = np.asarray(res.arrays["field"])
        out[f"chain_{decomp}_energies"] = np.array(
            [float(res.arrays["insitu_kept_energy"]),
             float(res.arrays["insitu_total_energy"])])
    for decomp, (mkey, dims) in T.CYCLIC_CHAINS.items():
        mesh = meshes[mkey]
        spec = plan_dft(dims, "forward", mesh,
                        decomp=decomp).schedule().in_spec
        x = jax.device_put(inputs["cyc_" + decomp],
                           NamedSharding(mesh, P(*spec)))
        data = BridgeData(arrays={"field": (x, jnp.zeros_like(x))},
                          grid=GridMeta(dims), layout="cyclic")
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": decomp},
            {"endpoint": "bandpass", "keep_frac": T.CYCLIC_KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": decomp}]}, mesh=mesh, grid=data.grid)
        res = chain.execute(data)
        out[f"cychain_{decomp}_field"] = np.asarray(res.arrays["field"])
        out[f"cychain_{decomp}_energies"] = np.array(
            [float(res.arrays["insitu_kept_energy"]),
             float(res.arrays["insitu_total_energy"])])
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(16)
    out = {}
    for decomp, direction, batched in T.CASES:
        shape = (T.BATCH,) * batched + T.DECOMPS[decomp][1]
        out["in_" + T.case_id(decomp, direction, batched)] = (
            rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)
    for decomp, (mkey, dims) in T.CYCLIC_CHAINS.items():
        field = rng.standard_normal(dims).astype(np.float32)
        out["nat_" + decomp] = field
        out["cyc_" + decomp] = np.take(
            field, D.cyclic_order(dims[0], T.MESHES[mkey][0][0]), axis=0)
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
    return T.run_ranks("distributed", tmp_path_factory.mktemp("ranks"),
                       inputs)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _oracle(x, decomp, direction):
    """The float64 numpy transform in the decomposition's layouts: the
    cyclic spatial side and the digit-permuted spectral side along axis
    0 for pencil_tf and fourstep1d, natural elsewhere."""
    nd = len(T.DECOMPS[decomp][1])
    axes = tuple(range(-nd, 0))
    x = x.astype(np.complex128)
    if decomp not in D.CYCLIC_DECOMPS:
        return (np.fft.fftn(x, axes=axes) if direction == "forward"
                else np.fft.ifftn(x, axes=axes))
    n0 = x.shape[-nd]
    p0 = T.MESHES[T.DECOMPS[decomp][0]][0][0]
    if direction == "forward":
        nat = np.take(x, D.cyclic_inverse_order(n0, p0), axis=-nd)
        y = np.fft.fftn(nat, axes=axes)
        return np.take(y, D.fourstep_freq_of_position(n0, p0), axis=-nd)
    nat = np.take(x, D.fourstep_position_of_freq(n0, p0), axis=-nd)
    y = np.fft.ifftn(nat, axes=axes)
    return np.take(y, D.cyclic_order(n0, p0), axis=-nd)


@pytest.mark.parametrize("decomp,direction,batched", T.CASES,
                         ids=[T.case_id(*c) for c in T.CASES])
def test_decomposition_matches_reference(decomp, direction, batched,
                                         inputs, reference, port):
    cid = T.case_id(decomp, direction, batched)
    got, want = port["out_" + cid], reference["out_" + cid]
    assert got.shape == want.shape
    assert _rel(got, want) < TOL
    assert _rel(got, _oracle(inputs["in_" + cid], decomp, direction)) < TOL


@pytest.mark.parametrize("decomp", T.OVERLAP)
def test_overlap_chunking_is_bit_identical(decomp, port):
    assert np.array_equal(port[f"overlap2_{decomp}"],
                          port[f"overlap0_{decomp}"])


def test_fourstep_wrappers_round_trip(inputs, port):
    x = inputs["in_" + T.case_id("fourstep1d", "forward", False)]
    assert np.abs(port["fourstep_wrapper_round_trip"] - x).max() < TOL


@pytest.mark.parametrize("decomp", sorted(T.CHAINS))
def test_fig2_chain_across_ranks_matches_reference(decomp, reference, port):
    field = port[f"chain_{decomp}_field"]
    want = reference[f"chain_{decomp}_field"]
    assert field.shape == T.CHAINS[decomp][1] and np.isfinite(field).all()
    assert np.abs(field - want).max() < FIELD_TOL
    # rank 0 wrote the one global field; every rank holds the global sums
    assert np.array_equal(port[f"chain_{decomp}_written"], field)
    energies = port[f"chain_{decomp}_energies"]
    assert list(energies[:, 2]) == [1, 0, 0, 0]
    jkept, jtotal = reference[f"chain_{decomp}_energies"]
    assert np.abs(energies[:, 0] - jkept).max() / jkept < ENERGY_TOL
    assert np.abs(energies[:, 1] - jtotal).max() / jtotal < ENERGY_TOL


@pytest.mark.parametrize("decomp", sorted(T.CYCLIC_CHAINS))
def test_cyclic_chain_across_ranks_matches_reference(decomp, inputs,
                                                     reference, port):
    # fft -> bandpass -> ifft from a cyclic field: the mask is permuted
    # to the digit-permuted spectrum and cut to each rank's block
    mkey, dims = T.CYCLIC_CHAINS[decomp]
    field = port[f"cychain_{decomp}_field"]
    assert str(port[f"cychain_{decomp}_layout"]) == "cyclic"
    assert field.shape == dims and np.isfinite(field).all()
    assert np.abs(field - reference[f"cychain_{decomp}_field"]).max() \
        < FIELD_TOL
    # the float64 oracle: the natural field, the natural mask, then the
    # result in cyclic order
    mask = filters.lowpass_mask(dims, T.CYCLIC_KEEP_FRAC).numpy()
    spec = np.fft.fftn(inputs["nat_" + decomp].astype(np.float64))
    want = np.take(np.fft.ifftn(spec * mask).real,
                   D.cyclic_order(dims[0], T.MESHES[mkey][0][0]), axis=0)
    assert np.abs(field - want).max() < FIELD_TOL
    power = np.abs(spec) ** 2
    kept64, total64 = (power * mask).sum(), power.sum()
    energies = port[f"cychain_{decomp}_energies"]
    jkept, jtotal = reference[f"cychain_{decomp}_energies"]
    for kept, total in list(energies) + [(jkept, jtotal)]:
        assert abs(kept - kept64) / kept64 < ENERGY_TOL
        assert abs(total - total64) / total64 < ENERGY_TOL
    assert np.abs(energies[:, 0] - jkept).max() / jkept < ENERGY_TOL
    assert np.abs(energies[:, 1] - jtotal).max() / jtotal < ENERGY_TOL


def test_pipelined_chain_across_ranks(port):
    """The pipelined Fig. 2 chain on the (4,) slab with a writer, more
    fields than its queue holds: each field bit-identical to the insitu
    chain's on the same ranks and within 1e-4 of max |ref| of the
    reference's one-device chain; the writer's files on rank 0 only, in
    step order, each the gathered field (the worker gathers on the
    chain's own process group while the producer runs the next field's
    exchanges)."""
    from repro.compat import make_mesh as jax_make_mesh
    from repro.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro.core.insitu.config import build_chain
    mkey, dims = T.CHAINS[T.PIPE_DECOMP]
    src = RadiatingSourceAdaptor(dims)
    chain = build_chain({"mode": "insitu", "chain": [
        {"endpoint": "fft", "direction": "forward", "backend": "pallas"},
        {"endpoint": "bandpass", "keep_frac": T.KEEP_FRAC},
        {"endpoint": "fft", "direction": "backward", "backend": "pallas"},
    ]}, mesh=jax_make_mesh((1,), ("data",)), grid=src.produce(0).grid)
    expect = [f"field_{s:06d}.npy" for s in range(T.PIPE_FIELDS)]
    for rank, (same, files, completed, dropped, depth_max) in enumerate(
            port["pipe_ranks"]):
        assert same and completed == T.PIPE_FIELDS and dropped == 0
        assert 1 <= depth_max <= T.PIPE_DEPTH
        assert files == (expect if rank == 0 else [])
    for k in range(T.PIPE_FIELDS):
        want = np.asarray(chain.execute(src.produce(k)).arrays["field"])
        field = port[f"pipe_field_{k}"]
        assert field.shape == dims
        assert np.abs(field - want).max() <= FIELD_TOL * np.abs(want).max()
        assert np.array_equal(port[f"pipe_written_{k}"], field)
