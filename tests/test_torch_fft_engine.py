"""The port's FFT serving engine (``serve/fft_engine.py``) against the
reference's, on the behaviours of ``tests/test_fft_engine.py``: each
answer against the JAX engine's answer on the same payloads and against
numpy at the reference's ``rtol=2e-4, atol=2e-3``; coalescing, bucket
isolation, synchronous rejection, admission backpressure, failure
containment, custom buckets, threaded traffic, prewarm and the SLO
window; ``rescale_mesh`` by a direct swap (drain and no drain); which
ranks run plan ops, and the collective-only drive on a mesh of several
ranks (run across four ranks by ``tests/test_torch_elastic.py``);
``launch/mesh.make_host_mesh``.

The port runs on ``make_mesh((1, 1), ("data", "model"), device="cpu")``
(its kernels' plain versions), the reference on its one-device host
mesh. Every wait is bounded."""
import threading

import numpy as np
import pytest
import torch

from repro.compat import make_mesh as jax_make_mesh
from repro.serve.fft_engine import FFTServeEngine as JaxEngine
from repro_torch.compat import Mesh, make_mesh
from repro_torch.core.fft import plan as planmod
from repro_torch.core.fft.filters import lowpass_mask
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.fft_engine import (AdmissionFull, FFTServeEngine,
                                          MeshRescaled)

WAIT_S = 60.0
RTOL, ATOL = 2e-4, 2e-3


@pytest.fixture()
def mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh((1, 1), ("data", "model"))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _drain(eng):
    eng.drain(timeout=WAIT_S)


def jax_answers(jmesh, payloads, **kw):
    """The reference engine's answers to ``payloads`` (one batch)."""
    eng = JaxEngine(jmesh, max_batch=8, linger_s=0.0)
    futs = [eng.submit(p, **kw) for p in payloads]
    eng.step(force=True)
    eng.drain(timeout=WAIT_S)
    out = [f.result(timeout=WAIT_S) for f in futs]
    eng.stop()
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# correctness + coalescing
# ---------------------------------------------------------------------------

def test_c2c_batch_correct_and_coalesced(mesh, jmesh):
    eng = FFTServeEngine(mesh, max_batch=8, linger_s=0.0)
    rng = _rng(1)
    fields = [(rng.standard_normal((16, 24))
               + 1j * rng.standard_normal((16, 24))).astype(np.complex64)
              for _ in range(5)]
    futs = [eng.submit(f, op="fft") for f in fields]
    eng.step(force=True)
    _drain(eng)
    for f, fut, j in zip(fields, futs, jax_answers(jmesh, fields, op="fft")):
        got = fut.result(timeout=WAIT_S)
        _close(got, np.fft.fftn(f))
        _close(got, j)
    rep = eng.report()
    assert rep["requests"]["submitted"] == 5
    assert rep["requests"]["completed"] == 5
    assert rep["batching"]["executes"] == 1
    assert rep["batching"]["rows"] == 5
    assert rep["batching"]["padded_rows"] == 3      # 5 rows ran as 8
    assert rep["batching"]["batched_execute_ratio"] < 1.0
    assert rep["latency_ms"]["p99"] >= rep["latency_ms"]["p50"] > 0
    eng.stop()


def test_r2c_serving_trims_half_spectrum(mesh, jmesh):
    eng = FFTServeEngine(mesh, max_batch=4, linger_s=0.0)
    rng = _rng(2)
    fields = [rng.standard_normal((16, 24)).astype(np.float32)
              for _ in range(3)]
    futs = [eng.submit(f, op="fft", real=True) for f in fields]
    eng.step(force=True)
    _drain(eng)
    for f, fut, j in zip(fields, futs,
                         jax_answers(jmesh, fields, op="fft", real=True)):
        got = fut.result(timeout=WAIT_S)
        ref = np.fft.rfftn(f)
        assert got.shape == ref.shape == j.shape   # trimmed, not padded
        _close(got, ref)
        _close(got, j)
    eng.stop()


@pytest.mark.parametrize("real", [False, True])
def test_bandpass_roundtrip_matches_numpy(mesh, jmesh, real):
    eng = FFTServeEngine(mesh, max_batch=4, linger_s=0.0)
    rng = _rng(3)
    shape, keep = (16, 16), 0.25
    x = rng.standard_normal(shape).astype(np.float32)
    payload = x if real else x.astype(np.complex64)
    fut = eng.submit(payload, op="bandpass", real=real, keep_frac=keep)
    eng.step(force=True)
    _drain(eng)
    got = fut.result(timeout=WAIT_S)
    mask = lowpass_mask(shape, keep).numpy()
    ref = np.fft.ifftn(np.fft.fftn(x) * mask)
    ref = ref.real if real else ref
    _close(got, ref)
    [j] = jax_answers(jmesh, [payload], op="bandpass", real=real,
                      keep_frac=keep)
    _close(got, j)
    eng.stop()


def test_per_request_identity_is_ordered(mesh):
    """Each future gets ITS OWN row back — no cross-request mixing even
    when everything batches into one execute."""
    eng = FFTServeEngine(mesh, max_batch=8, linger_s=0.0)
    fields = [np.full((8, 8), k, np.complex64) for k in range(1, 7)]
    futs = [eng.submit(f) for f in fields]
    eng.step(force=True)
    _drain(eng)
    for k, fut in enumerate(futs, start=1):
        got = fut.result(timeout=WAIT_S)
        np.testing.assert_allclose(got[0, 0], 64.0 * k, rtol=1e-5)
        assert abs(got[1, 1]) < 1e-2
    eng.stop()


# ---------------------------------------------------------------------------
# bucketing rules
# ---------------------------------------------------------------------------

def test_mixed_shapes_never_cross_batch(mesh):
    eng = FFTServeEngine(mesh, max_batch=8, linger_s=0.0)
    a = [np.ones((16, 16), np.complex64) for _ in range(3)]
    b = [np.ones((8, 32), np.complex64) for _ in range(3)]
    futs = [eng.submit(f) for f in a + b]
    eng.step(force=True)
    _drain(eng)
    for fut in futs:
        fut.result(timeout=WAIT_S)
    rep = eng.report()
    assert rep["batching"]["executes"] == 2
    assert len(rep["buckets"]) == 2
    for brep in rep["buckets"].values():
        assert brep["requests"] == 3
        assert brep["executes"] == 1
    eng.stop()


def test_r2c_and_c2c_same_shape_are_isolated(mesh):
    eng = FFTServeEngine(mesh, max_batch=8, linger_s=0.0)
    real = [np.ones((16, 16), np.float32) for _ in range(2)]
    cplx = [np.ones((16, 16), np.complex64) for _ in range(2)]
    futs = ([eng.submit(f, real=True) for f in real]
            + [eng.submit(f) for f in cplx])
    eng.step(force=True)
    _drain(eng)
    rep = eng.report()
    assert rep["batching"]["executes"] == 2
    kinds = {k.split("|")[2] for k in rep["buckets"]}
    assert kinds == {"r2c", "c2c"}
    assert futs[0].result(timeout=WAIT_S).shape == (16, 9)
    assert futs[2].result(timeout=WAIT_S).shape == (16, 16)
    eng.stop()


def test_invalid_requests_rejected_synchronously(mesh):
    eng = FFTServeEngine(mesh)
    with pytest.raises(ValueError, match="rank >= 2"):
        eng.submit(np.ones(64, np.complex64))
    with pytest.raises(ValueError, match="forward"):
        eng.submit(np.ones((8, 8), np.float32), real=True,
                   direction="backward")
    with pytest.raises(ValueError, match="round-trip"):
        eng.submit(np.ones((8, 8)), op="bandpass", direction="backward")
    with pytest.raises(ValueError, match="op must be"):
        eng.submit(np.ones((8, 8)), op="dct")
    with pytest.raises(ValueError, match="unknown bucket"):
        eng.submit("x", bucket="nope")
    with pytest.raises(ValueError, match="real field"):
        eng.submit(np.ones((8, 8), np.complex64), real=True)
    assert eng.stats()["submitted"] == 0
    eng.stop()


# ---------------------------------------------------------------------------
# admission backpressure
# ---------------------------------------------------------------------------

def test_admission_backpressure_bounds_queue(mesh):
    eng = FFTServeEngine(mesh, max_pending=2, linger_s=0.0)
    eng.submit(np.ones((8, 8), np.complex64))
    eng.submit(np.ones((8, 8), np.complex64))
    with pytest.raises(AdmissionFull):
        eng.submit(np.ones((8, 8), np.complex64), block=False)
    with pytest.raises(AdmissionFull):
        eng.submit(np.ones((8, 8), np.complex64), timeout=0.05)
    assert eng.stats()["rejected"] == 2
    eng.step(force=True)
    fut = eng.submit(np.ones((8, 8), np.complex64), block=False)
    eng.step(force=True)
    _drain(eng)
    fut.result(timeout=WAIT_S)
    rep = eng.report()
    assert rep["queue"]["depth_max"] == 2
    assert rep["requests"]["rejected"] == 2
    eng.stop()


def test_blocked_submit_wakes_when_scheduler_launches(mesh):
    with FFTServeEngine(mesh, max_pending=2, max_batch=2,
                        linger_s=0.0005) as eng:
        futs = [eng.submit(np.ones((8, 8), np.complex64), timeout=WAIT_S)
                for _ in range(6)]
        for fut in futs:
            fut.result(timeout=WAIT_S)
        rep = eng.report()
    assert rep["requests"]["completed"] == 6
    assert rep["batching"]["executes"] >= 3
    assert rep["queue"]["depth_max"] <= 2


# ---------------------------------------------------------------------------
# failure containment
# ---------------------------------------------------------------------------

def test_poisoned_request_spares_batch_mates(mesh):
    calls = []

    def batch_exec(payloads, step):
        calls.append(list(payloads))
        if any(p == "poison" for p in payloads):
            raise RuntimeError("poisoned batch")
        return [p.upper() for p in payloads]

    eng = FFTServeEngine(mesh, linger_s=0.0)
    eng.register_bucket("txt", batch_exec, flush_at=4)
    futs = [eng.submit(p, bucket="txt") for p in ("a", "poison", "b")]
    eng.step(force=True)
    _drain(eng)
    assert futs[0].result(timeout=WAIT_S) == "A"
    assert futs[2].result(timeout=WAIT_S) == "B"
    with pytest.raises(RuntimeError, match="poisoned"):
        futs[1].result(timeout=WAIT_S)
    assert len(calls) == 4
    rep = eng.report()
    assert rep["requests"]["completed"] == 2
    assert rep["requests"]["failed"] == 1
    assert rep["batching"]["single_retries"] == 3
    with pytest.raises(ValueError, match="already registered"):
        eng.register_bucket("txt", batch_exec)
    eng.stop()


def test_failed_plan_batch_is_retried_per_request(mesh, monkeypatch):
    """A plan batch whose launch fails is retried request by request on
    the same dispatch path; a request that fails alone fails only its
    own future."""
    eng = FFTServeEngine(mesh, max_batch=4, linger_s=0.0)
    dispatch = eng._dispatch
    seen = []

    def flaky(bucket, batch):
        seen.append(batch.shape[0])
        if batch.shape[0] > 1 or float(batch.abs().max()) > 100:
            raise RuntimeError("launch failed")
        return dispatch(bucket, batch)

    monkeypatch.setattr(eng, "_dispatch", flaky)
    rng = _rng(5)
    good = [rng.standard_normal((8, 8)).astype(np.complex64)
            for _ in range(2)]
    bad = np.full((8, 8), 1e3, np.complex64)
    futs = [eng.submit(f) for f in (good[0], bad, good[1])]
    eng.step(force=True)
    _drain(eng)
    assert seen == [4, 1, 1, 1]
    for f, fut in zip(good, (futs[0], futs[2])):
        _close(fut.result(timeout=WAIT_S), np.fft.fftn(f))
    with pytest.raises(RuntimeError, match="launch failed"):
        futs[1].result(timeout=WAIT_S)
    rep = eng.report()
    assert rep["requests"]["failed"] == 1
    assert rep["batching"]["single_retries"] == 3
    eng.stop()


def test_custom_bucket_coalesces_and_flushes(mesh):
    calls = []

    def sink(payloads, step):
        calls.append(len(payloads))
        return None                   # fire-and-forget

    eng = FFTServeEngine(mesh, linger_s=10.0)   # linger never expires
    eng.register_bucket("mon", sink, flush_at=4)
    futs = [eng.submit(i, bucket="mon") for i in range(4)]
    eng.step()                        # full bucket: no force needed
    assert calls == [4]
    futs += [eng.submit(i, bucket="mon") for i in range(3)]
    eng.step()                        # partial + long linger: holds
    assert calls == [4]
    eng.flush()                       # the one trailing-flush helper
    assert calls == [4, 3]
    _drain(eng)
    assert all(f.result(timeout=WAIT_S) is None for f in futs)
    eng.stop()


# ---------------------------------------------------------------------------
# threaded end-to-end + shared warm plan cache
# ---------------------------------------------------------------------------

def test_threaded_mixed_traffic_end_to_end(mesh, jmesh):
    planmod.plan_cache_clear()          # deterministic miss accounting
    rng = _rng(7)
    shapes = [(16, 16), (8, 32)]
    with FFTServeEngine(mesh, max_batch=4, linger_s=0.001) as eng:
        work = []
        for k in range(10):
            shape = shapes[k % 2]
            f = (rng.standard_normal(shape)
                 + 1j * rng.standard_normal(shape)).astype(np.complex64)
            work.append((f, eng.submit(f)))
        errs = []

        def check(f, fut):
            try:
                _close(fut.result(timeout=WAIT_S), np.fft.fftn(f))
            except Exception as e:  # noqa: BLE001 — collected for assert
                errs.append(e)

        threads = [threading.Thread(target=check, args=wf, daemon=True)
                   for wf in work]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        rep = eng.report()
    assert not errs
    for (f, fut), j in zip(work, [jax_answers(jmesh, [f])[0]
                                  for f, _ in work]):
        _close(fut.result(timeout=WAIT_S), j)
    assert rep["requests"]["completed"] == 10
    assert rep["batching"]["executes"] < 10
    assert rep["throughput_rps"] > 0
    # the shared plan cache: 2 buckets -> 2 misses, everything else hits
    assert rep["plan_cache"]["misses"] == 2


# ---------------------------------------------------------------------------
# prewarm: plan-ladder warm-up + SLO window reset
# ---------------------------------------------------------------------------

def test_prewarm_runs_ladder_and_resets_slo_window(mesh):
    planmod.plan_cache_clear()          # deterministic miss accounting
    eng = FFTServeEngine(mesh, max_batch=4, linger_s=0.0)
    summary = eng.prewarm([
        {"shape": (16, 16)},
        {"shape": (16, 16), "real": True},
    ])
    assert summary["signatures"] == 2
    assert summary["batch_sizes"] == [1, 2, 4]
    assert summary["requests"] == 2 * (1 + 2 + 4)
    assert summary["errors"] == []
    assert summary["wall_s"] >= 0
    assert summary["plan_cache"]["misses"] > 0
    rep = eng.report()
    assert rep["requests"]["submitted"] == 0
    assert rep["requests"]["completed"] == 0
    for brep in rep["buckets"].values():
        assert brep["requests"] == 0 and brep["executes"] == 0
    assert rep["plan_cache"]["misses"] == summary["plan_cache"]["misses"]

    rng = _rng(11)
    fields = [(rng.standard_normal((16, 16))
               + 1j * rng.standard_normal((16, 16))).astype(np.complex64)
              for _ in range(4)]
    futs = [eng.submit(f) for f in fields]
    eng.step(force=True)
    _drain(eng)
    for f, fut in zip(fields, futs):
        _close(fut.result(timeout=WAIT_S), np.fft.fftn(f))
    rep = eng.report()
    assert rep["requests"]["completed"] == 4
    assert rep["plan_cache"]["misses"] == summary["plan_cache"]["misses"], \
        "prewarmed traffic must not build new plans"
    eng.stop()


def test_prewarm_report_carries_wisdom_counters(mesh):
    eng = FFTServeEngine(mesh, max_batch=2, linger_s=0.0)
    summary = eng.prewarm([{"shape": (8, 8)}], ladder=False)
    assert summary["batch_sizes"] == [1]
    assert summary["requests"] == 1
    for key in ("wisdom_hits", "wisdom_misses", "wisdom_stale"):
        assert key in summary["plan_cache"]
        assert key in eng.report()["plan_cache"]
    eng.stop()


def test_prewarm_respects_admission_bound(mesh):
    eng = FFTServeEngine(mesh, max_batch=8, max_pending=2, linger_s=0.0)
    summary = eng.prewarm([{"shape": (8, 8)}])
    assert summary["batch_sizes"] == [1, 2]
    assert summary["errors"] == []
    eng.stop()


def test_stop_rejects_new_submits(mesh):
    eng = FFTServeEngine(mesh)
    eng.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(np.ones((8, 8), np.complex64))


# ---------------------------------------------------------------------------
# rescale_mesh: a direct swap (the elastic controller drives it across
# ranks in tests/test_torch_elastic.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drain", [True, False])
def test_rescale_mesh_swaps_and_replans(mesh, drain):
    eng = FFTServeEngine(mesh, max_batch=4, linger_s=10.0)
    rng = _rng(13)
    f = (rng.standard_normal((8, 8))
         + 1j * rng.standard_normal((8, 8))).astype(np.complex64)
    done = eng.submit(f)
    eng.step(force=True)
    _drain(eng)
    pending = [eng.submit(f) for _ in range(2)]   # admitted, not launched
    new = make_mesh((1, 1), ("data", "model"), device="cpu")
    out = eng.rescale_mesh(new, drain=drain, timeout=WAIT_S)
    assert out == {"drained": drain, "failed_pending": 0 if drain else 2,
                   "buckets_reset": 1}
    assert eng.mesh is new
    assert all(not b.state for b in eng._buckets.values())
    for fut in pending:
        if drain:
            _close(fut.result(timeout=WAIT_S), np.fft.fftn(f))
        else:
            with pytest.raises(MeshRescaled):
                fut.result(timeout=WAIT_S)
    # the next request re-plans on the new mesh
    again = eng.submit(f)
    eng.step(force=True)
    _drain(eng)
    _close(again.result(timeout=WAIT_S), done.result(timeout=WAIT_S))
    bucket = next(iter(eng._buckets.values()))
    assert "fwd" in bucket.state
    rep = eng.report()
    assert rep["rescales"] == 1
    assert rep["requests"]["failed"] == (0 if drain else 2)
    eng.stop()


def test_engine_runs_plan_ops_on_one_rank_only(mesh):
    """Plan ops run only on the ranks of the engine's mesh. A mesh of
    several ranks is taken, at construction and at a swap, and is driven
    by collective ``step()`` calls: a scheduler thread is refused there,
    and a threaded engine cannot move onto one. A rank outside the mesh
    (here a one-rank mesh over rank 1) neither plans nor executes: its
    plan-op submit raises at once, while its custom buckets serve."""
    wide = Mesh(("data",), {"data": 2}, torch.device("cpu"), {"data": 0},
                ranks=(0, 1))
    eng = FFTServeEngine(wide)
    assert eng.mesh is wide
    with pytest.raises(ValueError, match="collective step"):
        eng.start()
    eng.stop(drain=False)
    threaded = FFTServeEngine(mesh).start()
    with pytest.raises(ValueError, match="no scheduler thread"):
        threaded.rescale_mesh(wide)
    assert threaded.mesh is mesh
    threaded.stop()
    other = Mesh(("data",), {"data": 1}, torch.device("cpu"), None,
                 ranks=(1,))
    eng = FFTServeEngine(other)
    with pytest.raises(ValueError, match="outside the engine's mesh"):
        eng.submit(np.ones((8, 8), np.complex64))
    eng.register_bucket("sink", lambda p, s: [x * 2 for x in p])
    fut = eng.submit(3, bucket="sink")
    eng.step(force=True)
    assert fut.result(timeout=WAIT_S) == 6
    assert eng.stats()["submitted"] == 1
    eng.stop()


def test_make_host_mesh_is_one_device(mesh):
    """The engine's lazy default: one device on every axis, on the CPU
    only when asked; without a card the default raises."""
    m = make_host_mesh(device="cpu")
    assert m.axis_names == ("data", "model")
    assert dict(m.shape) == {"data": 1, "model": 1}
    assert m.device.type == "cpu" and m.size == 1
    assert make_host_mesh((4,), ("data",), device="cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match="axis"):
        make_host_mesh((2, 2), ("data",), device="cpu")
    eng = FFTServeEngine()            # custom buckets build no mesh
    eng.register_bucket("sink", lambda p, s: None)
    eng.submit(1, bucket="sink")
    eng.step(force=True)
    assert eng._mesh is None
    if torch.cuda.is_available():
        assert make_host_mesh().device.type == "cuda"
    else:
        with pytest.raises(ValueError, match="does not exist"):
            make_host_mesh()
        with pytest.raises(ValueError, match="does not exist"):
            eng.submit(np.ones((8, 8), np.complex64))
    eng.stop()
