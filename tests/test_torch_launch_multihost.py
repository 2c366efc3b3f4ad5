"""The port's cluster launcher (``tools/launch_multihost_torch.py``) and
wisdom CLI (``tools/wisdom_warmup_torch.py``) on CPU ranks.

The launcher runs ``--demo all --nprocs 2`` once (the child demos, the
wisdom demo cold then warm, and the elastic demo on a world of 4 ranks),
and each test holds one part of its output to the reference launcher's
assertions and markers (``tests/test_multihost.py``): the ``--json`` rows
under the reference's names with one device a process, the host-crossing
annotation, each demo's OK line, the warm wisdom boot >= 5x faster, and
each rank's elastic record to the chaos scenario's contract. A run
without ``--device cpu`` on a host without a card fails naming the flag,
and not with the bring-up code 99.

The wisdom CLI populates a cold file, refuses ``--require-hits`` on a
cold file, passes ``--require-hits --require-zero-timed`` warm, and
prints the reference tool's JSON keys (one subprocess run of the
reference's tool)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
LAUNCHER = str(ROOT / "tools" / "launch_multihost_torch.py")
WISDOM = str(ROOT / "tools" / "wisdom_warmup_torch.py")
REF_WISDOM = str(ROOT / "tools" / "wisdom_warmup.py")

# the reference launcher's row names (tools/launch_multihost.py), at two
# processes of one device each; the elastic world has 4 ranks
ROWS = {"multihost_fft_pencil_2x1", "multihost_fft_slab3d_2x1",
        "multihost_fft_slab3d_r2c_2x1", "multihost_fft_pencil_dcnwire_2x1",
        "multihost_transit_2p", "multihost_wire_int8_block8_2x1",
        "multihost_transit_async_2p", "multihost_solver_ns2d_2x1",
        "multihost_wisdom_cold_2x1", "multihost_wisdom_warm_2x1",
        "elastic_rescale_4x1"}


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def demo_all(tmp_path_factory):
    bench = tmp_path_factory.mktemp("launcher") / "BENCH_multihost.json"
    res = subprocess.run(
        [sys.executable, LAUNCHER, "--nprocs", "2", "--device", "cpu",
         "--timeout", "300", "--json", str(bench)],
        env=_env(), capture_output=True, text=True, timeout=420)
    assert res.returncode == 0, res.stdout[-6000:] + res.stderr[-2000:]
    return res.stdout, json.loads(bench.read_text())["rows"]


def test_demo_all_rows_carry_the_reference_names(demo_all):
    _, rows = demo_all
    assert set(rows) == ROWS
    assert all(r["us_per_call"] > 0 for r in rows.values())
    assert rows["multihost_fft_pencil_2x1"]["derived"] == \
        "N=32x16x16;dcn_crossing=True"


def test_demo_all_fft_annotates_the_host_crossing(demo_all):
    out, _ = demo_all
    assert "'dcn': True" in out
    assert "fft demo OK" in out
    assert "measure sweep generated" in out


def test_demo_all_transit_and_wire_markers(demo_all):
    out, _ = demo_all
    assert "transit delivery bit-identical" in out
    assert "transit demo OK" in out
    assert "codec candidate(s)" in out
    assert "sweep winner wire (cluster-agreed):" in out
    assert "wire demo OK" in out


def test_demo_all_solver_spectrum_agreement(demo_all):
    out, _ = demo_all
    assert "solver TG decay" in out
    assert "spectrum cross-process spread" in out
    assert "solver demo OK" in out


def test_demo_all_warm_wisdom_boot_beats_cold(demo_all):
    out, rows = demo_all
    cold = rows["multihost_wisdom_cold_2x1"]
    warm = rows["multihost_wisdom_warm_2x1"]
    assert "timed=0" in warm["derived"] and "timed=0" not in cold["derived"]
    assert "[launcher] wisdom bring-up:" in out
    assert cold["us_per_call"] >= 5 * warm["us_per_call"]


def test_demo_all_elastic_records_hold_the_chaos_contract(demo_all):
    launcher = _launcher()
    out, _ = demo_all
    assert "elastic demo OK" in out and "[launcher] elastic rescale:" in out
    ranks = launcher.marked_records(out)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["detected_at_step"] == 3, r
        shrink, grow = r["events"]
        assert (shrink["generation"], shrink["to_devices"],
                shrink["drain"]) == (1, 1, False), r
        assert shrink["excluded_ids"] == [2] and \
            shrink["consumer_span"] == [3], r
        assert (grow["generation"], grow["to_devices"],
                grow["consumer_span"]) == (2, 2, [2, 3]), r
        assert r["state"] == "serving" and r["generation"] == 2, r
    for r in ranks[2:]:
        assert r["events"][0]["engine"]["failed_pending"] == 3, r
        assert r["pending_errors"] == ["MeshRescaled"], r
        assert r["gen0"]["sweep_candidates_timed"] > 0, r
        assert r["gen2"]["sweep_candidates_timed"] == 0, r
        assert r["gen2"]["wisdom_hits"] > 0 and r["bit_identical"], r
        assert r["chain"]["finite"] and \
            r["chain"]["field_max_abs_err"] < 1e-4, r
        assert r["chain"]["kept_rel_err"] < 1e-5, r
        assert r["engine_across_rel_err"] < 1e-4, r
    assert ranks[3]["gen1"]["rel_err"] < 1e-4
    assert ranks[3]["resubmit_rel_err"] < 1e-4
    for r in ranks[:2]:
        assert r["role"] == "producer"


def _launcher():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import launch_multihost_torch as launcher
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return launcher


def test_rank_probe_measures_each_rank_of_a_demo():
    # REPRO_RANK_PROBE names a file whose rank_probe() wraps each rank's
    # demos: chip_smoke.py's prints one ENTRY_RECORD line a rank
    res = subprocess.run(
        [sys.executable, LAUNCHER, "--nprocs", "4", "--device", "cpu",
         "--demo", "elastic", "--timeout", "240"],
        env=dict(_env(), REPRO_RANK_PROBE=str(ROOT / "chip_smoke.py")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "elastic demo OK" in res.stdout
    launcher = _launcher()
    probes = launcher.marked_records(res.stdout, "ENTRY_RECORD ")
    ranks = launcher.marked_records(res.stdout)
    assert [p["rank"] for p in probes] == [r["rank"] for r in ranks] == \
        [0, 1, 2, 3]
    for p, r in zip(probes, ranks):
        # the consumers' Fig. 2 chain hands its FFTs to kernels.ops
        assert bool(p["fft_shapes"]) == (r["role"] == "consumer"), (p, r)
        assert p["wall_s"] > 0, p
        # CPU tensors take the plain versions: no kernel launches
        assert set(p["launches"]) >= {"fft_fourstep", "fft_stockham",
                                      "bandpass_filter", "flash_attention"}
        assert not any(p["launches"].values()) and p["peak_bytes"] == 0, p


def test_demo_all_every_rank_leaves_through_the_barrier(demo_all):
    out, _ = demo_all
    # 2 ranks of the child demos, 2 + 2 of the wisdom boots, 4 elastic
    assert out.count("CHILD OK") == 10
    assert out.rstrip().endswith("[launcher] 2 process(es) x 1 device on "
                                 "cpu: OK")


def test_launcher_without_a_card_names_the_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for extra in (["--demo", "fft"],
                  ["--", sys.executable, "-c", "print(1)"]):
        res = subprocess.run([sys.executable, LAUNCHER, "--nprocs", "2",
                              *extra], env=_env(), capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 2, (res.returncode, res.stderr)
        assert "--device cpu" in res.stderr


# ---------------------------------------------------------------------------
# wisdom_warmup_torch.py
# ---------------------------------------------------------------------------

def _wisdom(path, *extra, device=("--device", "cpu")):
    return subprocess.run([sys.executable, WISDOM, "--file", str(path),
                           *device, *extra], env=_env(),
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def reference_wisdom(tmp_path_factory):
    """One run of the reference's tool on two host devices, started
    before the port's runs and read by the last test."""
    path = tmp_path_factory.mktemp("ref_wisdom") / "wisdom.json"
    proc = subprocess.Popen(
        [sys.executable, REF_WISDOM, "--file", str(path), "--devices", "2"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def wisdom_runs(tmp_path_factory, reference_wisdom):
    path = tmp_path_factory.mktemp("wisdom") / "wisdom.json"
    cold_hits = _wisdom(tmp_path_factory.mktemp("cold") / "w.json",
                        "--require-hits")
    cold = _wisdom(path)
    warm = _wisdom(path, "--require-hits", "--require-zero-timed")
    return path, cold, cold_hits, warm


def test_wisdom_cold_file_populates(wisdom_runs):
    path, cold, _, _ = wisdom_runs
    assert cold.returncode == 0, cold.stderr[-3000:]
    out = json.loads(cold.stdout)
    assert out["wisdom_hits"] == 0 and out["sweep_candidates_timed"] > 0
    assert out["store"]["writes"] > 0
    assert json.loads(path.read_text())


def test_wisdom_require_hits_fails_on_a_cold_file(wisdom_runs):
    _, _, cold_hits, _ = wisdom_runs
    assert cold_hits.returncode == 1, cold_hits.stderr[-3000:]
    assert "FAIL: --require-hits" in cold_hits.stderr


def test_wisdom_warm_run_plans_from_wisdom_alone(wisdom_runs):
    _, _, _, warm = wisdom_runs
    assert warm.returncode == 0, warm.stderr[-3000:]
    out = json.loads(warm.stdout)
    assert out["wisdom_hits"] > 0 and out["sweep_candidates_timed"] == 0


def test_wisdom_without_a_card_names_the_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _wisdom(tmp_path / "w.json", device=())
    assert res.returncode == 2 and "--device cpu" in res.stderr


def test_wisdom_json_keys_are_the_reference_tools(wisdom_runs,
                                                  reference_wisdom):
    _, cold, _, _ = wisdom_runs
    out, err = reference_wisdom.communicate(timeout=300)
    assert reference_wisdom.returncode == 0, err[-3000:]
    ref, got = json.loads(out), json.loads(cold.stdout)
    assert sorted(got) == sorted(ref)
    assert sorted(got["store"]) == sorted(ref["store"])
    # the same signatures planned: as many sweep candidates timed
    assert got["sweep_candidates_timed"] == ref["sweep_candidates_timed"]
