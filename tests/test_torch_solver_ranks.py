"""The port's spectral solvers across ranks on the CPU.

* Four gloo ranks (``torch_ranks.py`` job ``solver``) step NS2D 64² on
  the (4,) slab and the (2, 2) pencil2d mesh and Boussinesq 16³ on the
  (4,) slab3d and the (2, 2) pencil and pencil_tf meshes, r2c and c2c;
  each is held to the reference's run of the same decomposition on four
  host devices (once, in a subprocess): fields within 1e-4 of max |ref|,
  the energy, and the basis tables every rank cut from its block of
  the forward plan's output spec, gathered, equal to the reference's
  global tables. One rank holds a whole table, so this is the test
  that guards the per-rank cuts.
* ``launch/solver.main`` with ``--transit-consumers 1`` on three ranks
  brought up by the ``REPRO_*`` env contract: the producers (a (2, 1)
  mesh) solve, the consumer writes the spectrum files and the producers
  none, and the final report is the one-rank run's; ``--ckpt-every``
  then ``--restore`` continues from step 10 on the same ranks.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_ranks as T
from repro_torch.launch import solver as launch

SRC = str(Path(__file__).resolve().parents[1] / "src")
FIELD_TOL = 1e-4      # tests/test_solver.py:274, relative to max |ref|
ENERGY_TOL = 1e-5

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    sys.path.insert(0, sys.argv[2])
    import torch_ranks as T
    from repro.compat import make_mesh
    from repro.core.solver import Boussinesq3DSolver, NS2DSolver

    meshes = {k: make_mesh(shape, names)
              for k, (shape, names) in T.MESHES.items()}
    out = {}
    for case in T.SOLVER_CASES:
        solver, decomp, mkey, real = case
        cid = T.solver_id(solver, decomp, real)
        s = T.solver_case(NS2DSolver, Boussinesq3DSolver, case,
                          meshes[mkey])
        got = T.solver_fields(s, solver)
        got["energy"] = np.array(s.energy())
        b = s.basis
        tables = {f"k{ax}": k for ax, k in enumerate(b.k)}
        tables.update({n: getattr(b, n) for n in T.SOLVER_TABLES})
        for name, t in tables.items():
            got["table_" + name] = np.broadcast_to(np.asarray(t),
                                                   b.spectral_shape)
        for k, v in got.items():
            out[f"solver_{cid}_{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return T.run_ranks("solver", tmp_path_factory.mktemp("ranks"), {})


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


CASE_IDS = [T.solver_id(s, d, r) for s, d, _, r in T.SOLVER_CASES]


@pytest.mark.parametrize("cid", CASE_IDS)
def test_four_ranks_match_the_reference(cid, port, reference):
    prefix = f"solver_{cid}_"
    fields = [k[len(prefix):] for k in reference
              if k.startswith(prefix) and not k.startswith(prefix + "table")
              and k != prefix + "energy"]
    assert fields
    for name in fields:
        want, got = reference[prefix + name], port[prefix + name]
        assert got.shape == want.shape
        err = np.max(np.abs(want - got)) / np.max(np.abs(want))
        assert err < FIELD_TOL, (name, err)
    e_ref, e_port = reference[prefix + "energy"], port[prefix + "energy"]
    assert abs(e_port - e_ref) / e_ref < ENERGY_TOL
    tables = [k for k in reference if k.startswith(prefix + "table")]
    assert len(tables) >= 6
    for key in tables:
        np.testing.assert_array_equal(port[key],
                                      reference[key].astype(np.float32),
                                      err_msg=key)


RANK_SCRIPT = textwrap.dedent("""
    import json, os, sys
    from repro_torch.launch import solver
    summary = solver.main(json.loads(sys.argv[1]))
    print(json.dumps(summary, default=str), flush=True)
    os._exit(0)
""")

BASE = ["--device", "cpu", "--grid", "32", "32", "--steps", "10",
        "--monitor-every", "5", "--init", "random", "--seed", "4"]


def _three_ranks(tmp_path, argv_of):
    """``launch/solver.main`` on three ranks started by the env contract;
    each rank's summary."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, json.dumps(argv_of(r))],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                 REPRO_COORDINATOR=coord, REPRO_NUM_PROCESSES="3",
                 REPRO_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(3)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0, 0], "\n".join(
        log[-3000:] for log in logs)
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


def test_launch_in_transit_on_three_ranks(tmp_path):
    one = launch.main(BASE + ["--spectra-dir", str(tmp_path / "one")])

    def argv(r, extra=()):
        return BASE + ["--spectra-dir", str(tmp_path / f"rank{r}"),
                       "--transit-consumers", "1", "--transit-async",
                       "--ckpt-dir", str(tmp_path / "ck"), *extra]
    first = _three_ranks(tmp_path, lambda r: argv(r, ["--ckpt-every", "5"]))
    p0, p1, cons = first
    assert p0["decomp"] == "slab" and cons["role"] == "consumer"
    assert abs(p0["final"]["energy"] - one["final"]["energy"]) \
        / one["final"]["energy"] < ENERGY_TOL
    assert p0["final"] == p1["final"]
    assert (p0["spectra_files"], p1["spectra_files"],
            cons["spectra_files"]) == (0, 0, 2)
    names = ["ns2d_spectrum_000005.npy", "ns2d_spectrum_000010.npy"]
    assert sorted(f.name for f in (tmp_path / "rank2").glob("*.npy")) \
        == names
    assert not list(tmp_path.glob("rank[01]/*.npy"))
    for name in names:
        np.testing.assert_allclose(np.load(tmp_path / "rank2" / name),
                                   np.load(tmp_path / "one" / name),
                                   rtol=FIELD_TOL, atol=1e-12)
    for rep in (p0["transit"], cons["transit"]):
        assert rep["fields"] == 2
        assert rep["producer"]["processes"] == [0, 1]
        assert rep["consumer"]["processes"] == [2]
        assert rep["async"]["completed"] == 2
    # each producer checkpoints into its own directory; none on the
    # consumer
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "proc0", "proc1"]
    second = _three_ranks(tmp_path, lambda r: argv(r, ["--restore"]))
    assert second[0]["final"]["step"] == 20
    assert second[0]["final"] == second[1]["final"]
    straight = launch.main([a if a != "10" else "20" for a in BASE])
    assert abs(second[0]["final"]["energy"] - straight["final"]["energy"]) \
        / straight["final"]["energy"] < ENERGY_TOL


def test_launch_elastic_on_three_ranks(tmp_path):
    """``--transit-consumers 2 --elastic`` on three ranks: one solver
    rank, two consumers under the elastic controller, every rank ticking
    once per report (no lease expires, so no rescale). The spectra, on
    the consumer mesh's first rank only, are those of the run without
    ``--elastic`` (one rank, the same slab decomposition) bit for bit,
    and every summary carries the ``elastic`` block."""
    flags = BASE + ["--decomp", "slab"]
    one = launch.main(flags + ["--spectra-dir", str(tmp_path / "one")])
    ranks = _three_ranks(tmp_path, lambda r: flags + [
        "--spectra-dir", str(tmp_path / f"rank{r}"),
        "--transit-consumers", "2", "--elastic"])
    solver, consumers = ranks[0], ranks[1:]
    assert solver["final"] == one["final"]
    assert [c["role"] for c in consumers] == ["consumer", "consumer"]
    assert [c["spectra_files"] for c in consumers] == [2, 0]
    names = ["ns2d_spectrum_000005.npy", "ns2d_spectrum_000010.npy"]
    assert sorted(f.name for f in (tmp_path / "rank1").glob("*.npy")) \
        == names
    assert not list(tmp_path.glob("rank[02]/*.npy"))
    for name in names:
        assert np.array_equal(np.load(tmp_path / "rank1" / name),
                              np.load(tmp_path / "one" / name))
    for rep in ranks:
        assert "transit" not in rep
        el = rep["elastic"]
        assert el["generation"] == 0 and el["events"] == []
        assert el["bridge"]["fields"] == 2
        assert el["bridge"]["producer"]["processes"] == [0]
        assert el["bridge"]["consumer"]["processes"] == [1, 2]
