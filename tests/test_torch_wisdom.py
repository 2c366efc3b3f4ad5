"""The port's persistent wisdom (``core/fft/wisdom.py``) and measured
planning on one device: keys, the file's schema, read and readwrite
modes, versioned invalidation (a file the JAX package wrote reads as
stale, with no raise), the env contract; ``backend="measure"`` and
``decomp="measure"`` (a member of the CPU candidate list, skips
recorded, served single-flight from the cache, the error-budget gate),
and the warm start from wisdom that times no candidate."""
import json
import threading

import numpy as np
import pytest
import torch

from repro.core.fft import wisdom as jwisdom
from repro_torch.compat import Mesh, make_mesh
from repro_torch.core.fft import plan, wisdom
from repro_torch.core.fft.plan import FORWARD, MEASURE, plan_dft

CPU_BACKENDS = ("fourstep", "jnp", "stockham")


@pytest.fixture
def clean_planner():
    plan.plan_cache_clear()
    plan.set_wisdom(None)
    yield
    plan.set_wisdom(None)
    plan.set_wire_sweep_policy("auto")
    plan.plan_cache_clear()


def _mesh():
    return make_mesh((1,), ("data",), device="cpu")


def _hosted(hosts):
    return Mesh(("data", "model"), {"data": 2, "model": 2},
                torch.device("cpu"), {"data": 0, "model": 0}, hosts=hosts)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

def test_store_round_trip_schema_and_modes(tmp_path):
    path = tmp_path / "sub" / "w.json"
    store = wisdom.WisdomStore(path)
    assert store.lookup("tune", "k") is None
    value = {"backend": "jnp", "overlap_chunks": 2,
             "wire_dtype": [None, "bfloat16"]}
    store.record("tune", "k", value)
    store.record("decomp", "d", "slab")
    payload = json.loads(path.read_text())
    assert payload["format"] == "repro-fft-wisdom" and payload["schema"] == 1
    assert payload["software"] == wisdom.software_fingerprint()
    assert set(payload["software"]) == {"torch", "cuda", "device",
                                        "sweep_rev"}
    assert payload["software"]["sweep_rev"] == jwisdom.SWEEP_REV
    assert payload["entries"]["k"] == {"kind": "tune", "value": value}
    # a second instance (a restart) reads the same winners
    again = wisdom.WisdomStore(path, mode="read")
    assert again.lookup("tune", "k") == value
    assert again.lookup("decomp", "d") == "slab"
    assert again.lookup("decomp", "k") is None      # wrong kind: stale
    assert again.stats()["stale"] == 1 and again.size() == 2
    # read mode never writes
    again.record("tune", "new", value)
    assert "new" not in json.loads(path.read_text())["entries"]
    with pytest.raises(ValueError, match="mode"):
        wisdom.WisdomStore(path, mode="sometimes")


def test_key_separates_topology_and_inputs():
    one = _mesh()
    k1 = wisdom.wisdom_key("tune", one, shape=(8, 8), real=False)
    assert k1 == wisdom.wisdom_key("tune", one, shape=[8, 8], real=False)
    assert k1 != wisdom.wisdom_key("tune", one, shape=(8, 16), real=False)
    assert k1 != wisdom.wisdom_key("decomp", one, shape=(8, 8), real=False)
    # the same (2, 2) mesh on one host, across two hosts (one crossing
    # axis), and on two other hosts of the same layout
    same = wisdom.wisdom_key("tune", _hosted(("a",) * 4), shape=(8, 8))
    split = wisdom.wisdom_key("tune", _hosted(("a", "a", "b", "b")),
                              shape=(8, 8))
    moved = wisdom.wisdom_key("tune", _hosted(("x", "x", "y", "y")),
                              shape=(8, 8))
    assert same != split and split == moved
    topo = wisdom.topology_fingerprint(_hosted(("a", "a", "b", "b")))
    assert topo["rank_coordinate_host"] == [[[0, 0], 0], [[0, 1], 0],
                                            [[1, 0], 1], [[1, 1], 1]]
    assert topo["axis_crosses_hosts"] == [("data", True), ("model", False)]
    assert (topo["device_type"], topo["device_name"]) == ("cpu", "cpu")
    assert topo["world_size"] == 1
    assert topo["mesh_shape"] == [["data", 2], ["model", 2]]


def test_versioned_invalidation(tmp_path, monkeypatch):
    path = tmp_path / "w.json"
    wisdom.WisdomStore(path).record("tune", "k", {"backend": "jnp"})
    monkeypatch.setattr(wisdom, "SWEEP_REV", wisdom.SWEEP_REV + 1)
    store = wisdom.WisdomStore(path)
    assert store.lookup("tune", "k") is None
    assert store.stats()["stale"] == 1
    # the next write replaces the stale file with this build's
    store.record("tune", "k2", "slab")
    assert json.loads(path.read_text())["software"]["sweep_rev"] == \
        wisdom.SWEEP_REV


def test_file_the_jax_package_wrote_is_stale_not_an_error(tmp_path):
    path = tmp_path / "w.json"
    jwisdom.WisdomStore(path).record(
        "tune", "k", {"backend": "pallas", "overlap_chunks": 0,
                      "wire_dtype": None})
    assert "jax" in json.loads(path.read_text())["software"]
    store = wisdom.WisdomStore(path)
    assert store.lookup("tune", "k") is None
    assert store.stats()["stale"] == 1 and store.stats()["load_errors"] == 0
    # corrupt and foreign files are cold starts too
    for text in ("{not json", json.dumps({"format": "other"}), "[]"):
        path.write_text(text)
        cold = wisdom.WisdomStore(path)
        assert cold.lookup("tune", "k") is None
        assert cold.stats()["load_errors"] == 1


def test_env_contract(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_WISDOM_FILE", raising=False)
    assert wisdom.store_from_env() is None
    monkeypatch.setenv("REPRO_WISDOM_FILE", str(tmp_path / "w.json"))
    store = wisdom.store_from_env()
    assert store.mode == "readwrite" and store.path == tmp_path / "w.json"
    monkeypatch.setenv("REPRO_WISDOM_MODE", "read")
    assert wisdom.store_from_env().mode == "read"
    monkeypatch.setenv("REPRO_WISDOM_MODE", "off")
    assert wisdom.store_from_env() is None


# ---------------------------------------------------------------------------
# Measured planning on one device
# ---------------------------------------------------------------------------

def test_measure_picks_a_cpu_candidate_and_records_skips(clean_planner):
    # 6 rows do not chunk in 4: those variants are skipped, recorded
    p = plan_dft((6, 64), FORWARD, _mesh(), backend=MEASURE)
    assert p.backend in CPU_BACKENDS and p.overlap_chunks in (0, 2)
    skips = plan.autotune_skips()
    assert any(s.get("overlap_chunks") == 4 and "ValueError" in s["error"]
               for s in skips)
    assert any(s.get("sweep") == "wire-profile" for s in skips)
    stats = plan.plan_cache_stats()
    # 2 backends (6 is no power of two: no Stockham) x 3 chunkings x 2
    # wires, each counted as it starts its timing (4 chunks then fail)
    assert stats["sweep_candidates_timed"] == 2 * 3 * 2
    assert stats["autotune_skipped"] == len(skips)
    # served from the cache: the same plan, no sweep
    again = plan_dft((6, 64), FORWARD, _mesh(), backend=MEASURE)
    assert again is p
    assert plan.plan_cache_stats()["sweep_candidates_timed"] == 12
    # with the exact wire only, the winner transforms as numpy does
    q = plan_dft((6, 60), FORWARD, _mesh(), backend=MEASURE,
                 allow_reduced_wire=False)
    assert q.backend in ("fourstep", "jnp") and q.wire_dtype is None
    x = np.random.default_rng(0).standard_normal((6, 60)).astype(np.float32)
    y = q.execute_complex(x).numpy()
    assert np.abs(y - np.fft.fft2(x)).max() / np.abs(y).max() < 5e-5


def test_measure_is_single_flight_across_threads(clean_planner):
    barrier = threading.Barrier(3)
    got, errs = [None] * 3, []

    def racer(i):
        try:
            barrier.wait()
            got[i] = plan_dft((8, 32), FORWARD, _mesh(), backend=MEASURE,
                              real=True)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in threads)
    assert got[0] is got[1] is got[2] and got[0].real
    stats = plan.plan_cache_stats()
    # one sweep: 3 backends x 3 chunkings x 2 wires, timed once
    assert stats["sweep_candidates_timed"] == 18
    assert stats["misses"] + stats["hits"] == 3 + 1


def test_decomp_measure_races_layout_compatible_decomps(clean_planner):
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    p = plan_dft((8, 8, 8), FORWARD, mesh, decomp=MEASURE)
    assert p.decomp in ("pencil", "slab3d")
    assert plan.plan_cache_stats()["decomp_sweeps"] == 1
    r = plan_dft((8, 16), FORWARD, mesh, decomp=MEASURE, backend=MEASURE,
                 real=True)
    assert r.decomp in ("slab", "pencil2d") and r.real
    x = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    y = r.execute_complex(x).numpy()[:, :9]
    want = np.fft.rfft2(x)
    if r.wire_dtype is None:
        assert np.abs(y - want).max() / np.abs(want).max() < 5e-5


def test_error_budget_gate_skips_an_over_budget_codec(clean_planner):
    plan.set_wire_sweep_policy("always")
    p = plan_dft((16, 64), FORWARD, _mesh(), backend=MEASURE,
                 wire_tol=1e-9)
    skips = [s for s in plan.autotune_skips()
             if s["error"] == "wire-error-budget"]
    # int8 and int8_block64, on each of three backends
    assert len(skips) == 6 and all(s["max_rel_err"] > 1e-9 for s in skips)
    assert plan.plan_cache_stats()["wire_codec_candidates"] == 2
    assert not any("int8" in str(w) for w in np.atleast_1d(p.wire_dtype)
                   if w is not None)


# ---------------------------------------------------------------------------
# The warm start
# ---------------------------------------------------------------------------

def test_warm_start_from_wisdom_times_no_candidate(clean_planner, tmp_path):
    plan.set_wisdom(tmp_path / "w.json")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    cold = plan_dft((6, 96), FORWARD, _mesh(), backend=MEASURE)
    cube = plan_dft((8, 8, 8), FORWARD, mesh, decomp=MEASURE, real=True)
    s = plan.plan_cache_stats()
    assert s["wisdom_misses"] == 2 and s["wisdom_hits"] == 0
    assert s["sweep_candidates_timed"] > 0
    plan.plan_cache_clear()
    warm = plan_dft((6, 96), FORWARD, _mesh(), backend=MEASURE)
    warm_cube = plan_dft((8, 8, 8), FORWARD, mesh, decomp=MEASURE, real=True)
    s = plan.plan_cache_stats()
    assert s["wisdom_hits"] == 2 and s["sweep_candidates_timed"] == 0
    assert (warm.backend, warm.overlap_chunks, warm.wire_dtype) == \
        (cold.backend, cold.overlap_chunks, cold.wire_dtype)
    assert warm_cube.decomp == cube.decomp


def test_stale_recorded_value_falls_back_to_the_sweep(clean_planner,
                                                      tmp_path):
    store = plan.set_wisdom(tmp_path / "w.json")
    plan_dft((6, 96), FORWARD, _mesh(), backend=MEASURE)
    key = next(iter(json.loads((tmp_path / "w.json").read_text())
                    ["entries"]))
    store.record("tune", key, {"backend": "cufft", "overlap_chunks": 0,
                               "wire_dtype": None})
    plan.plan_cache_clear()
    p = plan_dft((6, 96), FORWARD, _mesh(), backend=MEASURE)
    s = plan.plan_cache_stats()
    assert s["wisdom_stale"] == 1 and s["sweep_candidates_timed"] > 0
    assert p.backend in CPU_BACKENDS


def test_bluestein_tables_are_capped_and_cleared(monkeypatch):
    """The Bluestein tables live in a byte-capped LRU on the device that
    asked for them; ``plan_cache_clear()`` empties it."""
    from repro_torch.kernels import fft_fourstep as F
    from repro_torch.kernels import fft_plan
    plan.plan_cache_clear()
    assert F.table_bytes() == 0
    chirp, spec = F._bluestein_tables(257, False, torch.device("cpu"))
    assert chirp.device.type == spec.device.type == "cpu"
    m = fft_plan.bluestein_m(257)          # the route's M for 257
    assert m == fft_plan.route(257, False).m
    assert chirp.shape == (257, 2) and spec.shape == (m, 2)
    assert F.table_bytes() == 8 * (257 + m)
    assert F._bluestein_tables(257, False, "cpu")[0] is chirp   # cached
    # a cap of one 257 table and one 300 table keeps the two most recent
    # of three
    m300 = fft_plan.bluestein_m(300)
    monkeypatch.setattr(F, "CHIRP_CACHE_BYTES", 8 * (257 + m + 300 + m300))
    F._bluestein_tables(257, True, "cpu")
    F._bluestein_tables(257, False, "cpu")          # touched: most recent
    F._bluestein_tables(300, False, "cpu")
    assert F.table_bytes() <= F.CHIRP_CACHE_BYTES
    assert [k[:2] for k in F._CHIRPS] == [(257, False), (300, False)]
    # a table past the cap alone is made for its call and not kept
    monkeypatch.setattr(F, "CHIRP_CACHE_BYTES", 100)
    F._bluestein_tables(1021, False, "cpu")
    assert not [k for k in F._CHIRPS if k[0] == 1021]
    plan.plan_cache_clear()
    assert F.table_bytes() == 0 and not F._CHIRPS
