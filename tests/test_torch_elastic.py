"""The port's elastic consumer mesh (``runtime/elastic.py``, the engine
across ranks, ``launch/mesh.make_elastic_setup``) and
``distributed.reshard``, against the reference.

* ``FFTServeEngine.rescale_mesh`` on a one-rank CPU mesh: the
  reference's three cases (``tests/test_elastic.py:403``, ``:432``,
  ``:460``), each answer against the JAX engine's on the same payloads.
* ``tests/torch_ranks.py`` job ``elastic`` on four gloo CPU ranks (2
  producers, a pool of 2 consumers) runs the reference's chaos scenario
  (``test_elastic.py:497-600``), the engine across the grown two-rank
  mesh, the async chaos (``:654-716``) and ``reshard``; the reference runs
  the same scenarios once in a subprocess on four host devices (2
  producer devices, a pool of 2), and the two are held field for field
  where they define the same thing: the pool is global ranks in the port
  and device ids in the reference, and plan and eviction counts differ
  between the packages' planners.
* The guards: ``make_elastic_setup`` and the controller refuse a split
  with no producer, as the reference's do.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_ranks as R
from repro.compat import make_mesh as jax_make_mesh
from repro.serve.fft_engine import FFTServeEngine as JaxEngine
from repro_torch.compat import make_mesh
from repro_torch.runtime.fault import KILL_AT_STEP, InjectedFailure
from repro_torch.serve.fft_engine import FFTServeEngine, MeshRescaled

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
WAIT_S = 60.0
# the reference's bars (tests/test_elastic.py)
RTOL, ATOL = 2e-4, 2e-3
ERR_TOL = 1e-4
# the port's plan of the same field against the reference's, relative to
# max |X| (float32 transforms by different kernels)
PARITY_TOL = 1e-5


@pytest.fixture()
def mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh((1, 1), ("data", "model"))


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _jax_answers(jmesh, payloads):
    eng = JaxEngine(jmesh, max_batch=8, linger_s=0.0)
    futs = [eng.submit(p) for p in payloads]
    eng.step(force=True)
    eng.drain(timeout=WAIT_S)
    out = [np.asarray(f.result(timeout=WAIT_S)) for f in futs]
    eng.stop()
    return out


# ---------------------------------------------------------------------------
# FFTServeEngine.rescale_mesh on one rank (reference :403, :432, :460)
# ---------------------------------------------------------------------------

def test_engine_rescale_drain_completes_then_swaps(mesh, jmesh):
    eng = FFTServeEngine(mesh, max_batch=4, linger_s=10.0)
    rng = np.random.default_rng(2)
    fields = [_complex(rng, (16, 8)) for _ in range(3)]
    futs = [eng.submit(f) for f in fields]
    new_mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    info = eng.rescale_mesh(new_mesh, drain=True)
    assert info == {"drained": True, "failed_pending": 0,
                    "buckets_reset": 1}
    pre = [np.asarray(f.result(timeout=30)) for f in futs]
    for f, got, want in zip(fields, pre, _jax_answers(jmesh, fields)):
        np.testing.assert_allclose(got, np.fft.fftn(f), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert eng.mesh is new_mesh
    # the same request class on the new mesh's rebuilt plans: the results
    # are bit-identical — the rescale is transparent
    futs2 = [eng.submit(f) for f in fields]
    eng.step(force=True)
    eng.drain(timeout=WAIT_S)
    for got, f2 in zip(pre, futs2):
        assert np.array_equal(got, np.asarray(f2.result(timeout=30)))
    assert eng.report()["rescales"] == 1
    eng.stop()


def test_engine_rescale_failfast_contains_pending(mesh, jmesh):
    eng = FFTServeEngine(mesh, max_batch=8, linger_s=10.0)
    f = _complex(np.random.default_rng(3), (8, 8))
    doomed = [eng.submit(f) for _ in range(3)]
    info = eng.rescale_mesh(make_mesh((1, 1), ("data", "model"),
                                      device="cpu"), drain=False)
    assert info["failed_pending"] == 3 and not info["drained"]
    for fut in doomed:
        with pytest.raises(MeshRescaled, match="resubmit"):
            fut.result(timeout=5)
    st = eng.stats()
    assert st["failed"] == 3 and st["unlaunched"] == 0
    # the failure is per request: a resubmit lands on the new mesh
    fut = eng.submit(f)
    eng.step(force=True)
    eng.drain(timeout=WAIT_S)
    got = np.asarray(fut.result(timeout=30))
    np.testing.assert_allclose(got, np.fft.fftn(f), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _jax_answers(jmesh, [f])[0], rtol=RTOL,
                               atol=ATOL)
    rep = eng.report()
    assert rep["rescales"] == 1
    assert rep["requests"]["completed"] == 1
    eng.stop()


def test_engine_mid_batch_death_contained(mesh):
    """A batch whose executor dies mid-flight (an injected
    ``InjectedFailure``) is retried request by request: batch-mates
    complete, only the poisoned payload fails, on its own future."""
    calls = {"batched": 0}

    def flaky(payloads, step):
        if len(payloads) > 1:
            calls["batched"] += 1
            raise InjectedFailure("consumer died mid-batch",
                                  mode=KILL_AT_STEP, step=step)
        if payloads[0] == "poison":
            raise ValueError("poisoned payload")
        return [f"ok:{p}" for p in payloads]

    eng = FFTServeEngine(mesh, max_batch=8, linger_s=10.0)
    eng.register_bucket("chaos", flaky)
    futs = [eng.submit(p, bucket="chaos") for p in ("a", "poison", "b")]
    eng.step(force=True)
    eng.drain(timeout=WAIT_S)
    assert calls["batched"] == 1
    assert futs[0].result(timeout=5) == "ok:a"
    assert futs[2].result(timeout=5) == "ok:b"
    with pytest.raises(ValueError, match="poisoned"):
        futs[1].result(timeout=5)
    st = eng.stats()
    assert st["single_retries"] == 3
    assert st["completed"] == 2 and st["failed"] == 1
    eng.stop()


# ---------------------------------------------------------------------------
# Guards (one process: no producer is left)
# ---------------------------------------------------------------------------

def test_make_elastic_setup_rejects_consumer_only_split():
    from repro_torch.launch.mesh import make_elastic_setup
    with pytest.raises(SystemExit) as ei:
        make_elastic_setup(1, noun="decode", device="cpu")
    assert "--elastic" in str(ei.value) and "decode" in str(ei.value)


def test_elastic_controller_validates_pool_size():
    from repro_torch.runtime.elastic import ElasticController
    with pytest.raises(ValueError) as ei:
        ElasticController(0, device="cpu")
    assert "n_consumers" in str(ei.value)


def test_reshard_on_one_rank_moves_the_whole_field():
    from repro_torch.core.fft import distributed as D
    one = make_mesh((1,), ("data",), device="cpu")
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    got = D.reshard(D.shard(x, one, ("data", None)), one, ("data", None),
                    one, (None, "data"))
    assert np.array_equal(got.numpy(), x)
    with pytest.raises(ValueError, match="no rank of the source mesh"):
        D.reshard(np.zeros((4, 6), np.float32), one, ("data", None), one,
                  (None, "data"))


# ---------------------------------------------------------------------------
# The scenarios: four gloo ranks against the reference on four devices
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.pop("REPRO_WISDOM_FILE", None)
    import json, pickle
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import make_mesh
    from repro.core.fft import plan as plan_mod
    from repro.core.fft.distributed import reshard
    from repro.core.insitu.bridge import BridgeData
    from repro.core.insitu.pipeline import PipelineError
    from repro.launch.mesh import make_elastic_setup, make_transit_meshes
    from repro.runtime.fault import (HEARTBEAT_DROP, KILL_AT_STEP,
                                     SLOW_RANK, FaultSchedule,
                                     InjectedFault, StragglerMonitor)
    from repro.serve.fft_engine import FFTServeEngine

    workdir = sys.argv[1]
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    plan_mod.set_wisdom(os.path.join(workdir, "ref_wisdom.json"),
                        "readwrite")
    step_box = [0]
    pm, ctl = make_elastic_setup(
        2, lease=1.0, max_misses=2, clock=lambda: float(step_box[0]),
        plan_kwargs={"decomp": "slab", "backend": "measure",
                     "allow_reduced_wire": False})
    out["producer_devices"] = int(pm.devices.size)
    out["pool"] = {str(r): v["device_id"]
                   for r, v in ctl.consumer_ranks().items()}
    field = inp["elastic_field"]
    ref = np.fft.fftn(field)
    rel = lambda a, b: float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    run_fft = lambda: np.asarray(ctl.plan(field.shape)
                                 .execute_complex(field))
    out0 = run_fft()
    s = ctl.plan_stats()
    out.update(cold_timed=s["sweep_candidates_timed"],
               cold_wisdom_hits=s["wisdom_hits"], cold_err=rel(out0, ref),
               out0=out0)
    eng = FFTServeEngine(ctl.consumer_mesh, max_batch=4, linger_s=10.0,
                         plan_kwargs={"decomp": "slab"})
    ctl.attach_engine(eng)
    pend = [eng.submit((field + i).astype(np.complex64))
            for i in range(__PENDING__)]
    sched = FaultSchedule([
        InjectedFault(mode=HEARTBEAT_DROP, step=2, rank=0),
        InjectedFault(mode=SLOW_RANK, step=1, rank=1, duration=2,
                      slow_factor=1.5)])
    mon = StragglerMonitor()
    ev = None
    for step in range(1, __STEPS__):
        step_box[0] = step
        for r in ctl.active_ranks():
            mon.observe(step, 0.1 * sched.slow_factor(step, r), rank=r)
        ctl.heartbeat_all(drop=[r for r in ctl.active_ranks()
                                if sched.drops_heartbeat(step, r)])
        ev = ctl.tick(straggler_report=mon.rank_report())
        if ev is not None:
            break
    out["detected_at_step"] = step_box[0]
    out["shrink"] = None if ev is None else {
        k: ev[k] for k in ("generation", "to_devices", "drain",
                           "plans_evicted", "engine", "reason")}
    out["rank1_alive"] = 1 in ctl.detector.alive_ranks()
    out["pending_errors"] = sorted({type(f.exception(5)).__name__
                                    for f in pend})
    out["straggler_resets"] = mon.resets
    f2 = eng.submit(field.astype(np.complex64))
    eng.step(force=True)
    eng.drain(timeout=120.0)
    out["resubmit_err"] = rel(np.asarray(f2.result(timeout=30)), ref)
    out["engine_rescales"] = eng.report()["rescales"]
    out["shrunk_err"] = rel(run_fft(), ref)
    ev2 = ctl.rescale(n=2, rejoin_ranks=[0], drain=True,
                      reason="capacity rejoined")
    out2 = run_fft()
    s = ctl.plan_stats()
    out.update(warm_timed=s["sweep_candidates_timed"],
               warm_wisdom_hits=s["wisdom_hits"],
               grow={"generation": ev2["generation"],
                     "to_devices": ev2["to_devices"]},
               bit_identical=bool(np.array_equal(out0, out2)))
    rep = ctl.report()
    out["state"], out["n_events"] = rep["state"], len(rep["events"])
    eng.stop()

    # the async chaos
    pm2, ctl2 = make_elastic_setup(2, lease=1e9)
    afield = inp["elastic_async_field"]
    def payload(step):
        x = jax.device_put(jnp.asarray(afield + step),
                           NamedSharding(pm2, P("data", None)))
        return BridgeData(arrays={"f": x}, step=step)
    kill = FaultSchedule([InjectedFault(mode=KILL_AT_STEP, step=__KILL__,
                                        rank=0)])
    delivered = []
    def consume(data):
        kill.check_kill(data.step, 0)
        delivered.append(data.step)
    err = None
    try:
        for i in range(4):
            ctl2.send_async(payload(i), on_result=consume, depth=2)
        ctl2.drain_async(raise_error=False)
        ctl2.send_async(payload(9))
    except PipelineError as e:
        err = {"step": e.step, "endpoint": e.endpoint,
               "cause": type(e.cause).__name__}
    hop = ctl2.bridge.report()["async"]
    old = ctl2.bridge
    ev3 = ctl2.rescale(n=1, reason="operator shrink")
    got = []
    for i in range(3):
        ctl2.send_async(payload(i), on_result=lambda d: got.append(d),
                        depth=2)
    ctl2.drain_async()
    out["async"] = {
        "delivered_before_kill": delivered, "contained": err,
        "dropped": hop["dropped"], "rescaled_to": ev3["to_devices"],
        "old_hop_closed": old._async._closed,
        "new_bridge": ctl2.bridge is not old,
        "post_rescale_delivered": [g.step for g in got],
        "post_rescale_bit_identical": all(
            np.array_equal(np.asarray(g.arrays["f"]), afield + g.step)
            for g in got),
        "new_async_clean": ctl2.bridge.report()["async"]["error"] is None}

    # reshard: (4,) rows -> the consumer mesh's columns
    rf = inp["reshard_field"]
    m4 = make_mesh((4,), ("data",))
    _, cm = make_transit_meshes(2, 2)
    x = jax.device_put(jnp.asarray(rf), NamedSharding(m4, P("data", None)))
    y = reshard(x, NamedSharding(cm, P(None, "data")))
    z = reshard(x, NamedSharding(m4, P(None, "data")))
    out["reshard"] = {
        "to_consumers": {int(s.device.id): np.asarray(s.data)
                         for s in y.addressable_shards},
        "same_mesh": {int(s.device.id): np.asarray(s.data)
                      for s in z.addressable_shards},
        "global": np.asarray(y)}
    with open(os.path.join(workdir, "reference.pkl"), "wb") as fh:
        pickle.dump(out, fh)
""").replace("__PENDING__", str(R.ELASTIC_PENDING)) \
    .replace("__STEPS__", str(R.ELASTIC_STEPS)) \
    .replace("__KILL__", str(R.ELASTIC_ASYNC_KILL))


def _inputs():
    rng = np.random.default_rng(3)
    return {
        "elastic_field": rng.standard_normal(R.ELASTIC_FIELD)
        .astype(np.float32),
        "elastic_async_field": rng.standard_normal(R.ELASTIC_ASYNC_FIELD)
        .astype(np.float32),
        "reshard_field": np.arange(np.prod(R.RESHARD_FIELD),
                                   dtype=np.float32)
        .reshape(R.RESHARD_FIELD)}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def port(tmp_path_factory, inputs):
    got = R.run_ranks("elastic", tmp_path_factory.mktemp("elastic"), inputs)
    return list(got["elastic_ranks"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory, inputs):
    import pickle
    work = tmp_path_factory.mktemp("elastic_ref")
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(work)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(work / "reference.pkl", "rb") as fh:
        return pickle.load(fh)


PRODUCERS, POOL = (0, 1), (2, 3)


def test_chaos_cold_bringup_measures_and_is_correct(port, reference):
    assert reference["producer_devices"] == 2
    assert reference["pool"] == {"0": 2, "1": 3}
    for res in port:
        assert res["producer_devices"] == reference["producer_devices"]
        # a pool position is a global rank here, a device in the reference
        assert res["pool"] == reference["pool"]
    for r in POOL:
        res = port[r]
        assert res["cold_timed"] > 0 and reference["cold_timed"] > 0
        assert res["cold_wisdom_hits"] == reference["cold_wisdom_hits"] == 0
        assert res["cold_err"] < ERR_TOL and reference["cold_err"] < ERR_TOL
        ref = reference["out0"]
        err = np.max(np.abs(res["out0"] - ref)) / np.max(np.abs(ref))
        assert err < PARITY_TOL, err
    assert np.array_equal(port[2]["out0"], port[3]["out0"])


def test_chaos_heartbeat_drop_triggers_contained_shrink(port, reference):
    want = reference["shrink"]
    for r, res in enumerate(port):
        ev = res["shrink"]
        assert ev is not None, "injected heartbeat drop never detected"
        # drop at step 2, lease 1, max_misses 2: dead at step 3, exactly
        assert res["detected_at_step"] == reference["detected_at_step"] == 3
        for k in ("generation", "to_devices", "drain", "reason"):
            assert ev[k] == want[k], (r, k, ev[k], want[k])
        assert ev["drain"] is False and "rank(s) [0]" in ev["reason"]
        assert ev["excluded_ids"] == [2] and ev["consumer_span"] == [3]
        assert ev["wall_s"] > 0
        assert res["rank1_alive"] is reference["rank1_alive"] is True
        assert res["straggler_resets"] == reference["straggler_resets"]
        assert res["engine_rescales"] == 1
    assert want["plans_evicted"] > 0 and want["engine"]["failed_pending"] \
        == R.ELASTIC_PENDING
    for r in POOL:
        # every member of the old mesh fails the same pending requests
        ev = port[r]["shrink"]
        assert ev["plans_evicted"] > 0
        assert ev["engine"] == want["engine"]
        assert port[r]["pending_errors"] == reference["pending_errors"] \
            == ["MeshRescaled"]
    for r in PRODUCERS:
        assert port[r]["shrink"]["engine"]["failed_pending"] == 0
    # the resubmit and the shrunk mesh's plan, on the surviving consumer
    assert port[3]["resubmit_err"] < ERR_TOL
    assert reference["resubmit_err"] < ERR_TOL
    assert port[3]["shrunk_err"] < ERR_TOL
    assert reference["shrunk_err"] < ERR_TOL
    # the excluded rank and the producers neither plan nor execute
    for r in (0, 1, 2):
        assert "outside the engine's mesh" in port[r]["outside_submit"]


def test_chaos_grow_warm_starts_from_wisdom_bit_identical(port, reference):
    for res in port:
        assert res["grow"]["generation"] == \
            reference["grow"]["generation"] == 2
        assert res["grow"]["to_devices"] == reference["grow"]["to_devices"]
        assert res["grow"]["excluded_ids"] == []
        assert res["grow"]["consumer_span"] == list(POOL)
        assert res["state"] == reference["state"] == "serving"
        assert res["n_events"] == reference["n_events"] == 2
    assert reference["warm_wisdom_hits"] > 0
    assert reference["warm_timed"] == 0 and reference["bit_identical"]
    for r in POOL:
        assert port[r]["warm_wisdom_hits"] > 0
        assert port[r]["warm_timed"] == 0
        assert port[r]["bit_identical"] is True


def test_engine_across_the_grown_mesh(port):
    """The first consumer decides each tick: the full batch of 4 at once,
    the partial and the bandpass only when forced; every answer right on
    both ranks; a scheduler thread refused; a request on one rank alone
    fails the tick on both, with its future failed, instead of hanging
    the mesh."""
    for r in POOL:
        a = port[r]["across"]
        assert a["ticks"] == [1, 2]
        assert a["fft_err"] < ERR_TOL
        assert a["bandpass_err"] < PARITY_TOL
        assert "collective step" in a["start"]
        # the batch of 4, the partial of 1, the bandpass
        assert a["executes"] == 3
        assert "hold different pending requests" in a["diverged"]
    assert port[2]["across"]["lone"] == "RuntimeError"
    assert port[3]["across"]["lone"] is None


def test_async_consumer_death_contained(port, reference):
    want = reference["async"]
    assert want["delivered_before_kill"] == [0, 1]
    assert want["contained"] == {"step": 2, "endpoint": "transit",
                                 "cause": "InjectedFailure"}
    for res in port:
        got = res["async"]
        for k in ("delivered_before_kill", "contained"):
            assert got[k] == want[k], (k, got[k], want[k])
        assert got["dropped"] >= 1 and want["dropped"] >= 1


def test_async_drain_on_rescale(port, reference):
    want = reference["async"]
    for res in port:
        got = res["async"]
        for k in ("rescaled_to", "old_hop_closed", "new_bridge",
                  "post_rescale_delivered", "new_async_clean"):
            assert got[k] == want[k], (k, got[k], want[k])
    assert want["post_rescale_delivered"] == [0, 1, 2]
    assert want["post_rescale_bit_identical"] is True
    assert port[3]["async"]["post_rescale_bit_identical"] is True


def test_reshard_against_the_reference(port, reference, inputs):
    rf = inputs["reshard_field"]
    want = reference["reshard"]
    assert np.array_equal(want["global"], rf)
    for r, res in enumerate(port):
        got = res["reshard"]
        assert np.array_equal(got["same_mesh"], want["same_mesh"][r])
        if r in POOL:
            assert np.array_equal(got["to_consumers"],
                                  want["to_consumers"][r])
            assert np.array_equal(got["global"], rf)
            assert got["to_producers"] is None
        else:
            assert got["to_consumers"] is None
            # back from the consumers' columns to the producers' rows
            half = rf.shape[0] // 2
            assert np.array_equal(got["to_producers"],
                                  rf[r * half:(r + 1) * half])
