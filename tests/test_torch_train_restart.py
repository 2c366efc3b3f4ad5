"""Fault tolerance of the port's training path, and ``launch/train.py``
(counterparts of ``tests/test_train_restart.py`` and the reference
launcher's contract).

The contract: deterministic data + a checkpoint at step k => a job
killed and restarted mid-run ends bit-identical to one that never
failed, on the CPU where every kernel is deterministic. The launcher
runs at ``--reduced`` on the CPU: its JSON summary, the spectra written
through the pipelined chain (once a report, across restarts too), its
refusals of a producer mesh of more than one rank (ROADMAP queue 1 item
18 part 5), ``--transit-consumers 1 --transit-async`` on two gloo CPU
ranks started by the ``REPRO_*`` env contract, and ``--elastic
--transit-consumers 2`` on three."""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime.fault import StragglerMonitor, run_with_restarts
from repro_torch.sharding.policy import make_policy
from repro_torch.train import step as train_step_mod
from repro_torch.tree_util import tree_leaves

SRC = str(Path(__file__).resolve().parents[1] / "src")
CPU = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16"]


def _setup():
    cfg = registry.get_reduced("qwen3-4b")
    opt = AdamW(warmup_cosine(1e-3, 2, 50))
    policy = make_policy(make_host_mesh(device="cpu"), global_batch=2)
    step_fn = train_step_mod.make_train_step(cfg, policy, opt, loss_chunk=16)
    place = train_step_mod.state_shardings(
        policy, train_step_mod.train_state_shapes(cfg, opt))

    def make_state():
        return train_step_mod.init_train_state(
            cfg, opt, torch.Generator().manual_seed(0))

    def batch_fn(step):
        b = synthetic.batch_at(step, global_batch=2, seq_len=32,
                               vocab=cfg.vocab_size, seed=0)
        return {k: torch.from_numpy(v) for k, v in b.items()}

    return step_fn, make_state, batch_fn, place


def test_resume_equivalence(tmp_path):
    step_fn, make_state, batch_fn, place = _setup()
    sA, _ = run_with_restarts(
        make_state=make_state, train_step=step_fn, batch_fn=batch_fn,
        total_steps=12, ckpt_dir=tmp_path / "a", ckpt_every=4,
        state_place=place)
    sB, rep = run_with_restarts(
        make_state=make_state, train_step=step_fn, batch_fn=batch_fn,
        total_steps=12, ckpt_dir=tmp_path / "b", ckpt_every=4,
        state_place=place, fail_at=[6, 10])
    assert rep["restarts"] == 2
    for a, b in zip(tree_leaves(sA), tree_leaves(sB)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert int(sA["step"]) == int(sB["step"]) == 12
    assert int(sB["opt"]["count"]) == 12


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(alpha=0.3, threshold=3.0)
    for s in range(20):
        m.observe(s, 0.1)
    assert m.observe(100, 1.5) is True
    assert not m.observe(101, 0.1)
    rep = m.report()
    assert rep["slow_steps"] and rep["slow_steps"][0]["step"] == 100


def _last_manifest(ckpt_dir):
    last = sorted(Path(ckpt_dir).glob("step_*"))[-1]
    return last.name, [leaf["sha256"] for leaf in json.loads(
        (last / "manifest.json").read_text())["leaves"]]


def test_launcher_summary_spectra_and_restart(tmp_path, capsys):
    """The reference's summary keys; a report every 2 steps written once
    (files 0, 2, 4, 6), a restart included; the final checkpoint of the
    run that failed twice is the straight run's, byte for byte."""
    out = {}
    for name, extra in (("straight", []), ("failed", ["--fail-at", "3",
                                                      "6"])):
        out[name] = train.main(CPU + [
            "--steps", "8", "--insitu-every", "2", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / name / "ckpt"),
            "--insitu-spectra-dir", str(tmp_path / name / "spectra")]
            + extra)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["restarts"] == 2
    for rep in out.values():
        assert set(rep) == {"arch", "steps", "first_loss", "final_loss",
                            "wall_s", "restarts", "straggler",
                            "spectra_files", "spectra_backpressure_ms"}
        assert rep["arch"] == "qwen3-4b" and rep["steps"] == 8
        assert rep["spectra_files"] == 4
        assert np.isfinite(rep["final_loss"])
    assert out["straight"]["restarts"] == 0
    assert out["failed"]["restarts"] == 2
    assert out["straight"]["final_loss"] == out["failed"]["final_loss"]
    assert _last_manifest(tmp_path / "straight" / "ckpt") == \
        _last_manifest(tmp_path / "failed" / "ckpt")
    for name in out:
        files = sorted(f.name for f in (tmp_path / name / "spectra").glob(
            "*.npy"))
        assert files == [f"spectra_{s:06d}.npy" for s in (0, 2, 4, 6)]
        spectra = np.load(tmp_path / name / "spectra" / files[0])
        assert spectra.shape == (4, 8)
        np.testing.assert_allclose(spectra.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("argv,match", [
    pytest.param(["--num-processes", "2", "--process-id", "0",
                  "--coordinator", "localhost:1", "--transit-consumers",
                  "2"], "leaves no training",
                 id="argv2-leaves no training"),
    pytest.param(["--elastic"], "requires --transit-consumers",
                 id="argv3-requires --transit-consumers"),
    pytest.param(["--transit-async"], "requires --transit-consumers",
                 id="argv4-requires --transit-consumers"),
])
def test_launcher_refusals(argv, match, tmp_path):
    """The reference's flag checks, before any process group. (A world
    of several ranks trains on its mesh: ``test_torch_lm_ranks.py``.)"""
    with pytest.raises(SystemExit, match=match):
        train.main(CPU + ["--steps", "1", "--ckpt-dir",
                          str(tmp_path / "c")] + argv)


def test_launcher_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])


@pytest.mark.parametrize("preset", ["cpu", "100m"])
def test_example_trains_on_cuda_unless_asked(preset, tmp_path):
    """examples/train_insitu_torch.py runs on the card by default, for
    either preset: without one it raises, and falls back to nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "examples" \
        / "train_insitu_torch.py"
    spec = importlib.util.spec_from_file_location("train_insitu_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--preset", preset, "--steps", "1", "--out",
                  str(tmp_path)])


RANK = textwrap.dedent("""
    import json, os, sys
    from repro_torch.launch import train
    report = train.main(json.loads(sys.argv[1]))
    print(json.dumps(report, default=str), flush=True)
    os._exit(0)
""")


def _train_ranks(world, argv_of):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, json.dumps(argv_of(r))],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                 REPRO_COORDINATOR=coord, REPRO_NUM_PROCESSES=str(world),
                 REPRO_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(
        log[-3000:] for log in logs)
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


def test_transit_training_on_two_ranks(tmp_path):
    """``--transit-consumers 1 --transit-async``: rank 0 trains (the
    in-place run's losses), rank 1 trains nothing and writes the spectra
    it is sent — the in-place run's bytes — and rank 0 writes none."""
    base = CPU + ["--steps", "4", "--insitu-every", "2"]
    inplace = train.main(base + [
        "--ckpt-dir", str(tmp_path / "inplace_ckpt"),
        "--insitu-spectra-dir", str(tmp_path / "inplace")])
    producer, consumer = _train_ranks(2, lambda r: base + [
        "--ckpt-dir", str(tmp_path / "ckpt"),
        "--insitu-spectra-dir", str(tmp_path / f"rank{r}"),
        "--transit-consumers", "1", "--transit-async"])
    assert producer["final_loss"] == inplace["final_loss"]
    assert producer["spectra_files"] == 0
    assert consumer["role"] == "consumer" and consumer["spectra_files"] == 2
    for rep in (producer["transit"], consumer["transit"]):
        assert rep["fields"] == 2
        assert rep["producer"]["processes"] == [0]
        assert rep["consumer"]["processes"] == [1]
    assert (tmp_path / "ckpt" / "proc0").is_dir()
    assert not list((tmp_path / "rank0").glob("*.npy"))
    got = sorted((tmp_path / "rank1").glob("*.npy"))
    want = sorted((tmp_path / "inplace").glob("*.npy"))
    assert [f.name for f in got] == [f.name for f in want] == [
        "spectra_000000.npy", "spectra_000002.npy"]
    for g, w in zip(got, want):
        assert np.array_equal(np.load(g), np.load(w))


def test_elastic_training_on_three_ranks(tmp_path):
    """``--elastic --transit-consumers 2``: the controller stands in for
    the bridge; rank 0 trains, both consumers tick once a report, and
    the first consumer writes the spectra."""
    base = CPU + ["--steps", "4", "--insitu-every", "2", "--ckpt-dir",
                  str(tmp_path / "ckpt")]
    reports = _train_ranks(3, lambda r: base + [
        "--insitu-spectra-dir", str(tmp_path / f"rank{r}"),
        "--transit-consumers", "2", "--elastic"])
    assert np.isfinite(reports[0]["final_loss"])
    assert [r.get("role") for r in reports[1:]] == ["consumer"] * 2
    assert [r["spectra_files"] for r in reports] == [0, 2, 0]
    for rep in reports:
        assert rep["elastic"]["generation"] == 0
        assert rep["elastic"]["consumer_devices"] == 2
