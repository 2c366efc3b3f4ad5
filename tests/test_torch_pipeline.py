"""The port's pipelined chain (``InSituChain(mode="pipelined")`` over
``core/insitu/pipeline.py``) against the reference's, on the behaviours
of ``tests/test_pipeline.py``: per-field outputs and written files
against the JAX pipelined chain on the same seeded fields (1e-4 of max
|ref|) and bit for bit against the port's own ``insitu`` chain; the
overlap accounting and its definitions; failure containment;
re-initialize; backpressure; the multi-worker declarations; duplicate
endpoint names; ``donate_buffers``; a device-only chain; the wall clock
frozen at drain. On the CPU every tensor is host data, so the worker
takes each field as it is (the CUDA event and pinned-copy branch runs in
``tests/test_torch_cuda.py``). Every wait here is bounded."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh as jax_make_mesh
from repro.core.insitu.adaptors import RadiatingSourceAdaptor as JaxSource
from repro.core.insitu.bridge import BridgeData as JaxBridgeData
from repro.core.insitu.config import build_chain as jax_build_chain
from repro.core.insitu.pipeline import overlap_stats as jax_overlap_stats
from repro_torch.compat import make_mesh
from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.chain import InSituChain
from repro_torch.core.insitu.config import build_chain
from repro_torch.core.insitu.endpoint import Endpoint
from repro_torch.core.insitu.endpoints.writer import WriterEndpoint
from repro_torch.core.insitu.pipeline import (READY_EVENT, HostPipeline,
                                              PipelineError, overlap_stats)

DIMS = (64, 64)
FIELD_DIMS = (256, 256)
WAIT_S = 30.0
TOL = 1e-4


def chain_cfg(mode, out_dir, planned=False, **extra):
    fft = ({"backend": "pallas"} if planned else {"local": True})
    return {
        "mode": mode,
        "chain": [
            {"endpoint": "fft", "array": "field", "direction": "forward",
             **fft},
            {"endpoint": "bandpass", "array": "field", "keep_frac": 0.1},
            {"endpoint": "fft", "array": "field", "direction": "backward",
             **fft},
            {"endpoint": "writer", "array": "field", "out_dir": out_dir},
        ],
        **extra,
    }


def run_fields(chain, fields):
    outs = [chain.execute(d) for d in fields]
    chain.drain(timeout=WAIT_S)
    return outs


def jax_run_fields(chain, fields):
    """The reference's chain over ``fields`` (its drain takes no
    timeout)."""
    outs = [chain.execute(d) for d in fields]
    chain.drain()
    return outs


def _field(step):
    return BridgeData(arrays={"field": torch.ones(DIMS) * step}, step=step)


@pytest.mark.parametrize("planned", [False, True],
                         ids=["local", "planned"])
def test_pipelined_matches_reference_and_insitu(planned, tmp_path):
    """Six 256² fields through the pipelined chain: each output and each
    written file within 1e-4 of max |ref| of the JAX pipelined chain's,
    and bit-identical to the port's insitu chain's."""
    steps = range(6)
    jsrc = JaxSource(dims=FIELD_DIMS)
    jmesh = jax_make_mesh((1,), ("data",)) if planned else None
    jchain = jax_build_chain(
        chain_cfg("pipelined", str(tmp_path / "jax"), planned), jmesh,
        jsrc.produce(0).grid)
    jouts = jax_run_fields(jchain, [jsrc.produce(s) for s in steps])
    want = [np.asarray(o.arrays["field"]) for o in jouts]
    jfiles = jchain.finalize()["writer"]["files"]

    mesh = make_mesh((1,), ("data",), device="cpu") if planned else None
    src = RadiatingSourceAdaptor(FIELD_DIMS, device="cpu")
    fields = [src.produce(s) for s in steps]
    insitu = build_chain(chain_cfg("insitu", str(tmp_path / "ins"), planned),
                         mesh, src.grid)
    piped = build_chain(chain_cfg("pipelined", str(tmp_path / "pip"),
                                  planned), mesh, src.grid)
    outs_i = [insitu.execute(d) for d in fields]
    outs_p = run_fields(piped, fields)
    files_i = insitu.finalize()["writer"]["files"]
    files_p = piped.finalize()["writer"]["files"]
    assert len(files_p) == len(jfiles) == len(fields)
    assert files_p == sorted(files_p), "writer output must be step-ordered"
    for a, b, w, fp, fi, fj in zip(outs_p, outs_i, want, files_p, files_i,
                                   jfiles):
        got = a.arrays["field"].numpy()
        assert torch.equal(a.arrays["field"], b.arrays["field"])
        assert np.abs(got - w).max() <= TOL * np.abs(w).max()
        np.testing.assert_array_equal(np.load(fp), np.load(fi))
        assert np.abs(np.load(fp) - np.load(fj)).max() <= \
            TOL * np.abs(w).max()


def test_pipelined_overlap_accounting(tmp_path):
    """The report carries the reference's keys with the reference's
    invariants."""
    fields = [RadiatingSourceAdaptor(DIMS, device="cpu").produce(s)
              for s in range(4)]
    chain = build_chain(chain_cfg("pipelined", str(tmp_path / "p")), None,
                        fields[0].grid)
    run_fields(chain, fields)
    rep = chain.marshaling_report()
    jsrc = JaxSource(dims=DIMS)
    jchain = jax_build_chain(chain_cfg("pipelined", str(tmp_path / "j")),
                             None, jsrc.produce(0).grid)
    jax_run_fields(jchain, [jsrc.produce(s) for s in range(4)])
    jrep = jchain.marshaling_report()
    assert set(rep) == set(jrep) and set(rep["pipeline"]) == set(
        jrep["pipeline"])
    assert rep["mode"] == "pipelined"
    pipe = rep["pipeline"]
    assert pipe["submitted"] == pipe["completed"] == len(fields)
    assert pipe["dropped"] == 0
    assert pipe["error"] is None
    assert 0.0 <= pipe["overlap_efficiency"] < 1.0
    assert pipe["wall_s"] > 0 and pipe["serialized_s"] > 0
    assert pipe["queue_depth_max"] <= pipe["depth"]
    assert "writer" in pipe["host_timings_s"]
    assert "writer" in rep["timings_s"]
    chain.finalize()
    jchain.finalize()
    assert chain.marshaling_report()["pipeline"]["completed"] == len(fields)


class _FailsAt(Endpoint):
    """Host endpoint that raises on one configured step."""
    name = "fails_at"
    host = True

    def __init__(self, *, step: int):
        super().__init__(step=step)
        self.fail_step = step
        self.seen = []

    def execute(self, data):
        step = int(data.step)
        if step == self.fail_step:
            raise RuntimeError(f"boom at {step}")
        self.seen.append(step)
        return data

    def finalize(self):
        return {"seen": self.seen}


def test_exception_mid_pipeline_surfaces_and_finalize_is_clean():
    ep = _FailsAt(step=1)
    chain = InSituChain([ep], mode="pipelined", pipeline_depth=1)
    chain.initialize()
    with pytest.raises(PipelineError) as exc:
        for s in range(8):
            chain.execute(_field(s))
        chain.drain(timeout=WAIT_S)
    assert "fails_at" in str(exc.value)
    assert exc.value.step == 1 and "boom" in str(exc.value.cause)
    fin = chain.finalize()
    assert fin["fails_at"] == {"seen": ep.seen}
    pipe = chain.marshaling_report()["pipeline"]
    assert pipe["error"] is not None and "boom" in pipe["error"]
    assert pipe["dropped"] >= 1
    assert pipe["completed"] == len(ep.seen)
    assert ep.seen[:1] == [0]
    with pytest.raises((RuntimeError, PipelineError)):
        chain.execute(_field(99))


def test_materialize_failure_is_a_pipeline_error(monkeypatch):
    """A failure while the worker waits on a field or copies it (a CUDA
    error at the event or the copy) is the field's PipelineError, named
    after the materialization step, re-raised at the next call; later
    fields are dropped and counted."""
    class Recorder(Endpoint):
        name = "recorder"
        host = True

        def execute(self, data):
            return data

    p = HostPipeline([Recorder()], depth=1)
    calls = []

    def fail(data):
        calls.append(int(data.step))
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(p, "_materialize", fail)
    p.submit(_field(0))
    with pytest.raises(PipelineError) as exc:
        p.drain(timeout=WAIT_S)
    assert exc.value.endpoint == "<device_get>" and exc.value.step == 0
    assert "illegal memory access" in str(exc.value)
    with pytest.raises(PipelineError):
        p.submit(_field(1))
    p.close()
    rep = p.report()
    assert calls == [0] and rep["completed"] == 0 and rep["dropped"] == 1
    assert "illegal memory access" in rep["error"]


def test_reinitialize_drains_and_invalidates_inflight():
    class Recorder(Endpoint):
        name = "recorder"
        host = True

        def __init__(self):
            super().__init__()
            self.steps = []

        def execute(self, data):
            self.steps.append(int(data.step))
            return data

    rec = Recorder()
    chain = InSituChain([rec], mode="pipelined", pipeline_depth=2)
    chain.initialize()
    for s in range(5):
        chain.execute(_field(s))
    chain.initialize()            # must drain the 5 in-flight fields
    assert rec.steps == list(range(5))
    assert chain._pipeline is None
    chain.execute(_field(100))
    chain.drain(timeout=WAIT_S)
    assert rec.steps[-1] == 100
    assert chain.marshaling_report()["pipeline"]["submitted"] == 1
    chain.finalize()


def test_backpressure_bounds_queue():
    release = threading.Event()

    class Slow(Endpoint):
        name = "slow"
        host = True

        def execute(self, data):
            release.wait(timeout=WAIT_S)
            return data

    chain = InSituChain([Slow()], mode="pipelined", pipeline_depth=1)
    chain.initialize()
    # 1 in the worker + 1 queued fit; the 3rd submit blocks until released
    chain.execute(_field(0))
    chain.execute(_field(1))
    t = threading.Thread(target=lambda: chain.execute(_field(2)),
                         daemon=True)
    t.start()
    t.join(timeout=0.1)
    assert t.is_alive(), "3rd submit should be blocked by backpressure"
    release.set()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    chain.drain(timeout=WAIT_S)
    rep = chain.marshaling_report()["pipeline"]
    assert rep["backpressure_s"] > 0
    assert rep["queue_depth_max"] <= 1
    chain.finalize()


def test_multi_worker_requires_declarations():
    class Unordered(Endpoint):
        name = "unordered"
        host = True
        thread_safe = True
        ordered = False

        def execute(self, data):
            return data

    class Ordered(Endpoint):
        name = "ordered"
        host = True

        def execute(self, data):
            return data

    with pytest.raises(ValueError, match="ordered"):
        HostPipeline([Ordered()], workers=2)
    # the writer declares ordered, as the reference's does
    assert WriterEndpoint.ordered and not WriterEndpoint.thread_safe
    with pytest.raises(ValueError, match="ordered"):
        HostPipeline([WriterEndpoint(out_dir="unused")], workers=2)
    for bad in ({"depth": 0}, {"workers": 0}):
        with pytest.raises(ValueError, match="must be >= 1"):
            HostPipeline([Unordered()], **bad)
    p = HostPipeline([Unordered()], workers=2)
    p.submit(_field(0))
    p.submit(_field(1))
    p.drain(timeout=WAIT_S)
    assert p.report()["completed"] == 2
    p.close()


@pytest.mark.parametrize("wall_s,host,probe", [
    (1.0, 1.0, 0.25), (2.0, 1.0, 0.25), (1e-9, 1.0, 0.25), (0.5, 0.0, 0.0)])
def test_overlap_stats_definitions(wall_s, host, probe):
    """The port's derivation equals the reference's on the same inputs
    (4 fields at 0.25 s device and 1 s host: 2 s serial estimate)."""
    pr = {"completed": 4, "host_timings_s": {"w": host}}
    got = overlap_stats(wall_s=wall_s, dispatch_s=0.1, device_probe_s=probe,
                        pipeline_report=pr)
    want = jax_overlap_stats(wall_s=wall_s, dispatch_s=0.1,
                             device_probe_s=probe, pipeline_report=pr)
    assert got == pytest.approx(want)
    assert 0.0 <= got["overlap_efficiency"] <= 1.0
    if (wall_s, host) == (1.0, 1.0):
        assert got["serialized_s"] == 2.0
        assert got["overlap_efficiency"] == pytest.approx(0.5)
    if wall_s == 2.0:
        assert got["overlap_efficiency"] == 0.0


def test_finalize_keeps_duplicate_endpoint_names(tmp_path):
    cfg = {"mode": "pipelined", "chain": [
        {"endpoint": "writer", "array": "field",
         "out_dir": str(tmp_path / "a"), "prefix": "a"},
        {"endpoint": "writer", "array": "field",
         "out_dir": str(tmp_path / "b"), "prefix": "b"},
    ]}
    chain = build_chain(cfg, None, None)
    chain.execute(BridgeData(arrays={"field": torch.ones((4, 4))}))
    chain.drain(timeout=WAIT_S)
    fin = chain.finalize()
    assert len(fin["writer"]["files"]) == 1
    assert len(fin["writer#1"]["files"]) == 1


def test_pipelined_donate_buffers_changes_nothing(tmp_path):
    """``donate_buffers=True`` is accepted (PyTorch has no donation) and
    gives the same fields bit for bit, within 1e-4 of the reference's
    donating chain."""
    src = RadiatingSourceAdaptor(DIMS, device="cpu")
    fields = [src.produce(s) for s in range(4)]
    plain = build_chain(chain_cfg("pipelined", str(tmp_path / "p")), None,
                        fields[0].grid)
    donating = build_chain(chain_cfg("pipelined", str(tmp_path / "d"),
                                     donate_buffers=True), None,
                           fields[0].grid)
    assert donating.donate_buffers and not plain.donate_buffers
    outs_p = run_fields(plain, fields)
    outs_d = run_fields(donating, fields)
    jsrc = JaxSource(dims=DIMS)
    jchain = jax_build_chain(chain_cfg("pipelined", str(tmp_path / "j"),
                                       donate_buffers=True), None,
                             jsrc.produce(0).grid)
    outs_j = jax_run_fields(jchain, [jsrc.produce(s) for s in range(4)])
    for a, b, j in zip(outs_p, outs_d, outs_j):
        assert torch.equal(a.arrays["field"], b.arrays["field"])
        want = np.asarray(j.arrays["field"])
        assert np.abs(b.arrays["field"].numpy() - want).max() <= \
            TOL * np.abs(want).max()
    for c in (plain, donating, jchain):
        c.finalize()


def test_pipelined_device_only_chain_needs_no_pipeline():
    chain = build_chain({"mode": "pipelined", "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "local": True},
    ]}, None, None)
    x = np.random.default_rng(3).standard_normal(DIMS).astype(np.float32)
    out = chain.execute(BridgeData(arrays={"field": torch.from_numpy(x)}))
    assert chain.drain() is None
    assert out.domain == "spectral"
    # host data: no CUDA event rides with the field
    assert READY_EVENT not in out.meta
    jout = jax_build_chain({"mode": "pipelined", "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "local": True}]}, None, None).execute(
            JaxBridgeData(arrays={"field": jnp.asarray(x)}))
    re, im = out.arrays["field"]
    jre, jim = (np.asarray(v) for v in jout.arrays["field"])
    scale = np.abs(jre + 1j * jim).max()
    assert np.abs(re.numpy() - jre).max() <= TOL * scale
    assert np.abs(im.numpy() - jim).max() <= TOL * scale
    chain.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        chain.execute(BridgeData(arrays={"field": torch.ones(DIMS)}))
    chain.initialize()
    chain.execute(BridgeData(arrays={"field": torch.ones(DIMS)}))


def test_report_wall_freezes_at_drain(tmp_path):
    src = RadiatingSourceAdaptor(DIMS, device="cpu")
    chain = build_chain(chain_cfg("pipelined", str(tmp_path)), None,
                        src.grid)
    run_fields(chain, [src.produce(s) for s in range(3)])
    wall0 = chain.marshaling_report()["pipeline"]["wall_s"]
    time.sleep(0.1)
    wall1 = chain.marshaling_report()["pipeline"]["wall_s"]
    assert wall1 == pytest.approx(wall0), \
        "idle time after drain() leaked into wall_s"
    # a second batch after idle accumulates ACTIVE windows only
    t0 = time.perf_counter()
    run_fields(chain, [src.produce(s) for s in range(3, 6)])
    active = time.perf_counter() - t0
    wall2 = chain.marshaling_report()["pipeline"]["wall_s"]
    assert wall2 > wall0
    assert wall2 < wall0 + active + 0.05, \
        "idle time between batches leaked into wall_s"
    chain.finalize()

