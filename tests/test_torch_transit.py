"""The port's M→N in-transit path on four gloo CPU ranks: the bridge's
bit-identical delivery (2 -> 2 and 3 -> 1, the reference's (16, 8) case
and byte accounting), the lowest-ranked copy winning, ``None`` on
non-consumers, the guards, ``send_async``'s order, backpressure and
failure containment (the keys of ``tests/test_multihost.py:311-338``),
the Fig. 2 chain with the stats endpoint on the 2-rank consumer mesh
against the reference's chain on two host devices, the pipelined chain
and measured planning there, the multi-host mesh on two named hosts, and
a send the ranks disagree on or one rank skips.

The reference's own host transport does not run here (its single-process
leading-axis line, ``transit.py:330-332``, meets jax 0.9's
``process_allgather``, which already adds that axis), so the bridge is
held to the reference's contract and to numpy; the consumers' chain is
held against the reference chain on the same field. The port runs once
over four spawned ranks (``torch_ranks.py`` job ``transit``)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_ranks as T

SRC = str(Path(__file__).resolve().parents[1] / "src")
FIELD_TOL = 1e-4
ENERGY_TOL = 1e-5
ASYNC_KEYS = ["backpressure_s", "completed", "depth", "drain_wait_s",
              "dropped", "error", "hop_busy_s", "overlap_efficiency",
              "producer_blocked_s", "submitted"]
PRODUCERS, CONSUMERS = (0, 1), (2, 3)

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, sys.argv[2])
    import torch_ranks as T
    from repro.compat import make_mesh
    from repro.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro.core.insitu.config import build_chain

    mesh = make_mesh((2,), ("data",))
    data = RadiatingSourceAdaptor(
        T.TRANSIT_CHAIN,
        sharding=NamedSharding(mesh, P("data", None))).produce(0)
    cfg = T.transit_chain("insitu", "slab")
    chain = build_chain(cfg, mesh=mesh, grid=data.grid)
    res = chain.execute(data)
    np.savez(sys.argv[1], field=np.asarray(res.arrays["field"]),
             energies=np.array([float(res.arrays["insitu_kept_energy"]),
                                float(res.arrays["insitu_total_energy"])]),
             stats=np.asarray(res.arrays["insitu_stats"]))
""")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(19)
    out = {"transit_f": rng.standard_normal(T.TRANSIT_FIELD),
           "transit_g": rng.standard_normal(T.TRANSIT_3TO1),
           "transit_mh": rng.standard_normal((8, 12))}
    for k in range(T.TRANSIT_ASYNC):
        out[f"transit_async_{k}"] = rng.standard_normal(T.TRANSIT_FIELD)
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    out = T.run_ranks("transit", tmp_path_factory.mktemp("ranks"), inputs)
    return list(out["transit"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    work = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(work / "out.npz"),
         str(Path(__file__).parent)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(work / "out.npz") as f:
        return dict(f)


def test_two_to_two_is_bit_identical_with_the_reference_accounting(port):
    for r in CONSUMERS:
        same, device, spec, step, block = port[r]["2to2"]
        assert same and device == "cpu"
        assert spec == ["data", None] and block == (8, 8)
        assert step == 3              # the producer's step, passed through
    for rank in port:
        via, fields, nbytes, prod, cons = rank["2to2_report"]
        assert via == "host" and fields == 1
        # f (16*8) + pair (2 * 16*8) float32, as tests/test_multihost.py
        assert nbytes == 3 * 16 * 8 * 4
        assert prod == {"shape": {"data": 2}, "processes": [0, 1]}
        assert cons == {"shape": {"data": 2}, "processes": [2, 3]}


def test_non_consumers_get_none_leaves(port):
    for r in PRODUCERS:
        assert port[r]["2to2"] == (True, 3)
        assert port[r]["3to1"][0] is True


def test_three_to_one_is_bit_identical(port):
    same, spec, nbytes = port[3]["3to1"]
    assert same and spec is None      # one consumer holds the whole field
    assert nbytes == 12 * 8 * 4


def test_replicated_producer_copies_deduplicate(port):
    assert all(port[r]["replicated"] for r in CONSUMERS)


@pytest.mark.parametrize("case,match", [
    ("overlap", "share ranks"), ("device_put", "via='host'"),
    ("coverage", "no rank contributed 64 of 128"),
    ("no_role", "--transit-consumers: ranks \\[2\\]"),
    ("setup", "--transit-consumers 4 leaves no producer ranks")])
def test_transit_guards(port, case, match):
    import re
    idx = ("overlap", "device_put", "coverage", "no_role", "setup").index(
        case)
    for rank in port:
        assert rank["refused"][idx] is not None, case
        assert re.search(match, rank["refused"][idx]), rank["refused"][idx]


def test_async_in_order_bit_identical(port):
    for rank in port:
        order, same, keys, completed, bounded, empty = rank["async"]
        assert order == list(range(T.TRANSIT_ASYNC)) and same
        assert keys == ASYNC_KEYS
        assert completed == T.TRANSIT_ASYNC and bounded and empty


def test_async_backpressure_bounds_the_queue(port):
    for rank in port:
        assert rank["backpressure"] == (6, True, True, 1)


def test_async_failure_contained_on_next_send(port):
    for rank in port:
        err, dropped, error_set = rank["contained"]
        assert err is not None, "failed hop never surfaced"
        assert err[:2] == (1, "transit") and "consumer died" in err[2]
        assert dropped >= 1 and error_set


def test_fig2_chain_on_the_consumer_mesh_matches_reference(port,
                                                           reference):
    from repro_torch.core.insitu.adaptors import radiating_field
    noisy, _ = radiating_field(T.TRANSIT_CHAIN, seed=0)
    ref = reference["field"]
    for r in CONSUMERS:
        field, energies, stats, delivered, *_ = port[r]["chain"]
        assert np.array_equal(delivered, noisy)
        assert np.abs(field - ref).max() <= FIELD_TOL * np.abs(ref).max()
        np.testing.assert_allclose(energies, reference["energies"],
                                   rtol=ENERGY_TOL)
        np.testing.assert_allclose(stats, reference["stats"], rtol=1e-5,
                                   atol=1e-6)


def test_pipelined_chain_on_the_consumer_mesh(port):
    # the host tail gathers on the consumer mesh's own group: the files
    # on the consumer mesh's first rank only, fields as insitu's
    names = ["field_000000.npy", "field_000001.npy"]
    for r in CONSUMERS:
        *_, insitu_files, pipe_files, same = port[r]["chain"]
        assert same
        want = names if r == CONSUMERS[0] else []
        assert insitu_files == want and pipe_files == want
    assert all("chain" not in port[r] for r in PRODUCERS)


def test_measured_planning_agrees_among_the_consumers(port):
    picks = [port[r]["measured"] for r in CONSUMERS]
    assert picks[0] == picks[1]
    assert all("measured" not in port[r] for r in PRODUCERS)


def test_multihost_mesh_on_two_named_hosts(port, inputs):
    x = inputs["transit_mh"].astype(np.float64)
    want = np.fft.fft2(x)
    for rank in port:
        desc, ranks, round_trip, fx, wrong = rank["multihost"]
        assert ranks == (0, 2, 1, 3)      # host-major: a, a, b, b
        assert desc == {"shape": {"dcn": 2, "data": 2},
                        "axis_crosses_hosts": {"dcn": True, "data": False},
                        "processes": [0, 1, 2, 3], "devices": 4}
        assert round_trip
        assert np.abs(fx - want).max() <= 1e-4 * np.abs(want).max()
        assert "needs 8 ranks, cluster has 4" in wrong


def test_a_send_the_ranks_disagree_on_raises_everywhere(port):
    for rank in port:
        assert "disagree" in rank["mismatch"][0]


def test_a_skipped_send_times_out_and_raises(port):
    for r in PRODUCERS:
        msg, seconds = port[r]["mismatch"][1]
        assert "did not all reach it within 3s" in msg and seconds < 60
    assert all(port[r]["mismatch"][1] is None for r in CONSUMERS)
