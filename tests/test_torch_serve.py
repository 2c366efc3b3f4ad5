"""The port's continuous-batching engine and serve entry point on CPU: the
engine's tokens against the reference engine's on the same weights and
prompts (those of ``tests/test_engine.py``), and against the port's own
serial greedy decoding; slot reuse; the entry point's report; the pipelined
logits monitor (``--monitor-every``) against the run without it and its
chain against the reference's; the cluster and ``--transit-consumers``
flags (two gloo CPU ranks for the M→N monitor); the flags that need
modules not ported yet."""
import argparse
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import ContinuousBatcher, Request

SRC = str(Path(__file__).resolve().parents[1] / "src")


def serial_greedy(cfg, params, prompt, max_new):
    toks = torch.from_numpy(np.asarray(prompt, np.int64))[None]
    logits, state = lm.prefill(cfg, params, {"tokens": toks},
                               cache_len=len(prompt) + max_new + 2)
    out = []
    tok = int(logits[0, -1].argmax())
    for _ in range(max_new):
        out.append(tok)
        logits, state = lm.decode_step(cfg, params, torch.tensor([[tok]]),
                                       state)
        tok = int(logits[0, -1].argmax())
    return out


def _run(batcher, requests):
    for req in requests:
        batcher.submit(req)
    return batcher.run()


def test_engine_matches_reference_engine_and_serial_decode():
    jcfg, cfg = (jregistry.get_reduced("qwen3-4b"),
                 registry.get_reduced("qwen3-4b"))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=p).astype(np.int32)
               for p in (5, 7, 4, 6, 5)]
    max_new = 6
    want = _run(jengine.ContinuousBatcher(jcfg, jparams, slots=2,
                                          cache_len=64),
                [jengine.Request(rid=i, prompt=p, max_new=max_new)
                 for i, p in enumerate(prompts)])
    eng = ContinuousBatcher(cfg, params, slots=2, cache_len=64)
    got = _run(eng, [Request(rid=i, prompt=p, max_new=max_new)
                     for i, p in enumerate(prompts)])
    assert len(got) == len(prompts)
    for i, p in enumerate(prompts):
        assert got[i].out == want[i].out, (i, got[i].out, want[i].out)
        assert got[i].out == serial_greedy(cfg, params, p, max_new)


def test_engine_slot_reuse():
    """More requests than slots: slots must be reused, and a reused
    slot's cache rows are reset."""
    cfg = registry.get_reduced("qwen3-4b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(1),
                            torch.float32)
    rng = np.random.default_rng(1)
    eng = ContinuousBatcher(cfg, params, slots=2, cache_len=32)
    n = 5
    finished = _run(eng, [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, 4).astype(np.int32), max_new=3)
        for i in range(n)])
    assert len(finished) == n
    assert all(len(r.out) == 3 and r.done for r in finished.values())
    eng._reset_slot_cache(0)
    cache = eng.state["caches"]["l0"]
    assert bool((cache.positions[:, 0] == -1).all())
    assert not bool(cache.k[:, 0].any())
    assert bool((cache.positions[:, 1] >= 0).any())


def test_serve_main_runs_on_cpu_and_reports(tmp_path, capsys):
    out = tmp_path / "bench.json"
    report = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "12", "--tokens", "5",
                         "--bench-out", str(out)])
    assert report["arch"] == "qwen3-4b" and report["device"] == "cpu"
    for key in ("prefill_ms", "decode_ms_per_token", "tokens_per_s"):
        assert report[key] > 0
    assert len(report["sample"]) == 5
    rows = json.loads(out.read_text())
    assert set(rows["rows"]) == {"serve_run_prefill",
                                 "serve_run_decode_token"}
    assert rows["source"] == "repro_torch.launch.serve"
    # the same seed gives the same greedy tokens; '' prints the report
    again = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "12", "--tokens", "5",
                        "--bench-out", ""])
    assert again["sample"] == report["sample"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "sample"] == report["sample"]


# explicit ids: the ones these cases had while the list still held the
# monitor flag (flags0), the transit and cluster flags (flags1, flags4-6),
# the wisdom flag (flags3), the elastic flag (flags2) and the MoE arch
# (flags7), all now ported; the name is kept from when they raised. The
# MoE case serves a reduced dbrx; the other flags are tested below
@pytest.mark.parametrize("flags,item", [
    pytest.param(["--arch", "dbrx-132b"], "item 18", id="flags7-item 18"),
])
def test_serve_flags_not_ported_raise(flags, item):
    report = serve.main(["--reduced", "--device", "cpu", "--bench-out", "",
                         "--batch", "2", "--prompt-len", "12", "--tokens",
                         "3", *flags])
    assert report["arch"] == "dbrx-132b" and len(report["sample"]) == 3


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "grok-1-314b", "internvl2-2b"])
def test_serve_main_serves_every_decoder_family(arch):
    report = serve.main(["--reduced", "--device", "cpu", "--bench-out", "",
                         "--arch", arch, "--batch", "2", "--prompt-len",
                         "20", "--tokens", "3"])
    assert report["arch"] == arch and len(report["sample"]) == 3


def test_serve_main_refuses_the_encoder_decoder():
    with pytest.raises(SystemExit, match="encdec"):
        serve.main(["--reduced", "--device", "cpu", "--bench-out", "",
                    "--arch", "whisper-medium"])


# The int8 cache against the dense one, at the reference's bar
# (tests/test_serve.py::test_int8_cache_close_to_dense): max |dlogit| <
# 0.05, total variation < 0.01, the same argmax; and against the
# reference's int8 cache on the same weights (its quantization, to the
# int8 value, and its logits at 1e-5 / 1e-4).
def _int8_runs(arch, B=2, S=16, seed=8):
    jcfg, cfg = jregistry.get_reduced(arch), registry.get_reduced(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    step = jax.jit(lambda p, t, s: jlm.decode_step(jcfg, p, t, s))
    runs = {}
    for impl in ("dense", "int8"):
        js = jlm.init_decode_state(jcfg, B, S + 2, jnp.float32,
                                   cache_impl=impl)
        ts = lm.init_decode_state(cfg, B, S + 2, torch.float32,
                                  cache_impl=impl, device="cpu")
        for t in range(S):
            jl, js = step(jparams, jnp.asarray(tokens[:, t:t + 1]), js)
            tl, ts = lm.decode_step(cfg, params,
                                    torch.from_numpy(tokens[:, t:t + 1]), ts)
        runs[impl] = (tl, ts, np.asarray(jl), js)
    return runs


@pytest.mark.parametrize("arch", ["gemma2-27b", "internvl2-2b",
                                  "zamba2-2.7b"])
def test_int8_cache_close_to_dense(arch):
    runs = _int8_runs(arch)
    ld, lq = runs["dense"][0][:, 0], runs["int8"][0][:, 0]
    assert float((ld - lq).abs().max()) < 0.05
    pd, pq = torch.softmax(ld, -1), torch.softmax(lq, -1)
    assert float(0.5 * (pd - pq).abs().sum(-1).max()) < 0.01
    assert torch.equal(ld.argmax(-1), lq.argmax(-1))
    caches = runs["int8"][1]["caches"]
    assert all(c.k.dtype == c.v.dtype == torch.int8 for c in
               caches.values())
    # against the reference's int8 cache: the same int8 values (a value
    # may sit one step off where the two float32 K/V round either side
    # of a half) and the same logits
    for key, c in caches.items():
        jc = runs["int8"][3]["caches"][key]
        for name in ("k", "v"):
            diff = np.abs(getattr(c, name).numpy().astype(np.int32)
                          - np.asarray(getattr(jc, name), np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3
        np.testing.assert_array_equal(c.positions.numpy(),
                                      np.asarray(jc.positions))
    np.testing.assert_allclose(lq.numpy(), runs["int8"][2][:, 0],
                               atol=1e-5, rtol=1e-4)


def test_update_any_cache_matches_reference_on_both_paths():
    from repro.serve import kvcache as jkv
    from repro_torch.serve import kvcache
    rng = np.random.default_rng(9)
    knew = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    for window, pos in ((0, 4), (0, [1, 5, 0]), (6, [7, 2, 11])):
        want = jkv.update_any_cache(
            jkv.init_quant_cache(3, 6, 2, 8, window=window),
            jnp.asarray(knew), jnp.asarray(-2 * knew), jnp.asarray(pos))
        got = kvcache.update_any_cache(
            kvcache.init_quant_cache(3, 6, 2, 8, window=window,
                                     device="cpu"),
            torch.from_numpy(knew), torch.from_numpy(-2 * knew),
            torch.tensor(pos) if isinstance(pos, list) else pos)
        for name in ("k", "v", "positions"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(
                getattr(got, name).float().numpy(),
                np.asarray(getattr(want, name), np.float32))
        k, v = kvcache.read_kv(got, torch.float32)
        jk, jv = jkv.read_kv(want, jnp.float32)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _alone(cfg, params, req, state=None):
    """The request's tokens from a one-slot engine of its own."""
    eng = ContinuousBatcher(cfg, params, slots=1, cache_len=32)
    if state is not None:
        eng.state = state(1)
    return _run(eng, [Request(rid=0, prompt=req.prompt,
                              max_new=req.max_new)])[0].out


@pytest.mark.parametrize("arch,impl", [("zamba2-2.7b", "dense"),
                                       ("qwen3-4b", "int8"),
                                       ("zamba2-2.7b", "int8")])
def test_engine_slot_reset_clears_ssm_and_int8_state(arch, impl):
    """Six requests on two slots: each reused slot's rows of every cache
    (K/V, an int8 cache's scales, positions) and SSM state start empty,
    so each request's tokens equal a run of it alone."""
    cfg = registry.get_reduced(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(2),
                            torch.float32)

    def state(slots):
        return lm.init_decode_state(cfg, slots, 32, torch.float32,
                                    cache_impl=impl, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(
        rng.integers(3, 7))).astype(np.int32), max_new=4) for i in range(6)]
    eng = ContinuousBatcher(cfg, params, slots=2, cache_len=32)
    eng.state = state(2)
    finished = _run(eng, reqs)
    assert len(finished) == 6
    for r in reqs:
        assert finished[r.rid].out == _alone(cfg, params, r, state)
    eng._reset_slot_cache(1)
    for c in eng.state["caches"].values():
        for name, t in vars(c).items():
            if torch.is_tensor(t):
                want = -1 if name == "positions" else 0
                assert bool((t[:, 1] == want).all()), name
                assert bool((t[:, 0] != want).any()), name
    for st in eng.state["ssm"].values():
        for t in st:
            assert not bool(t[:, 1].any()) and bool(t[:, 0].any())


CPU = ["--reduced", "--device", "cpu", "--bench-out", ""]


class _BroughtUp(Exception):
    pass


@pytest.mark.parametrize("flags,want", [
    (["--process-id", "1"], ("h:1", 2, 1)),
    (["--coordinator", "f:2", "--num-processes", "3", "--process-id", "2"],
     ("f:2", 3, 2))])
def test_serve_brings_the_cluster_up_from_flags_over_env(monkeypatch, flags,
                                                         want):
    monkeypatch.setenv("REPRO_COORDINATOR", "h:1")
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
    seen = []

    def fake(cfg, device=None):
        seen.append(((cfg.coordinator, cfg.num_processes, cfg.process_id),
                     device))
        raise _BroughtUp
    monkeypatch.setattr(serve, "init_cluster", fake)
    with pytest.raises(_BroughtUp):
        serve.main(CPU + flags)
    assert seen == [(want, torch.device("cpu"))]


def test_serve_refuses_a_producer_mesh_of_several_ranks(monkeypatch):
    """No longer refused: three ranks with one consumer leave a two-rank
    decode mesh, and serve goes on to bring the cluster up (the run
    itself: ``test_torch_lm_ranks.py``)."""
    def fake(cfg, device=None):
        assert (cfg.num_processes, cfg.process_id) == (3, 0)
        raise _BroughtUp
    monkeypatch.setattr(serve, "init_cluster", fake)
    with pytest.raises(_BroughtUp):
        serve.main(CPU + ["--coordinator", "localhost:1", "--num-processes",
                          "3", "--process-id", "0", "--transit-consumers",
                          "1"])


@pytest.mark.parametrize("flags", [
    ["--transit-consumers", "1"],
    ["--coordinator", "localhost:1", "--num-processes", "2", "--process-id",
     "0", "--transit-consumers", "2"]], ids=["one-process", "all-ranks"])
def test_serve_refuses_transit_consumers_leaving_no_decode_rank(flags):
    with pytest.raises(SystemExit, match="--transit-consumers .* leaves no "
                                         "decode ranks"):
        serve.main(CPU + flags)


@pytest.mark.parametrize("tokens,every,batch,want", [
    (8, 2, 2, [2, 2]), (5, 2, 2, [2, 1]), (7, 3, 4, [3])])
def test_consumers_send_as_often_as_the_monitor_executes(
        tmp_path, tokens, every, batch, want):
    """A consumer rank calls ``send`` once per monitor execute, counted
    from the flags: the same count, and the same batch extents, as the
    engine's executes in place."""
    args = argparse.Namespace(tokens=tokens, monitor_every=every,
                              monitor_batch=batch)
    assert serve._monitor_fields(args) == want
    report = serve.main(CPU + [
        "--batch", "2", "--prompt-len", "8", "--tokens", str(tokens),
        "--monitor-every", str(every), "--monitor-batch", str(batch),
        "--monitor-dir", str(tmp_path)])
    assert report["monitor"]["submits"] == len(want)
    assert report["monitor"]["snapshots"] == sum(want)


TRANSIT_RANK = textwrap.dedent("""
    import json, os, sys
    from repro_torch.launch import serve
    report = serve.main(json.loads(sys.argv[1]))
    print(json.dumps(report), flush=True)
    os._exit(0)
""")


def _serve_ranks(world, argv_of):
    """``serve.main`` on ``world`` gloo CPU ranks started by the
    ``REPRO_*`` env contract; each rank's report."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", TRANSIT_RANK, json.dumps(argv_of(r))],
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


def test_serve_transit_consumers_on_two_ranks(tmp_path):
    """``--transit-consumers 1`` on two gloo CPU ranks started by the
    ``REPRO_*`` env contract: rank 0 decodes the tokens of the run
    without transit, rank 1 runs the monitor chain on the logits it is
    sent and writes the files (the same bytes as the monitor in place),
    rank 0 writes none, and both reports carry the ``transit`` block."""
    base = CPU + ["--batch", "2", "--prompt-len", "8", "--tokens", "8",
                  "--monitor-every", "2", "--monitor-batch", "2"]
    inplace = serve.main(base + ["--monitor-dir", str(tmp_path / "inplace")])
    decode, consume = _serve_ranks(2, lambda r: base + [
        "--monitor-dir", str(tmp_path / f"rank{r}"),
        "--transit-consumers", "1"])
    assert decode["sample"] == inplace["sample"]
    assert consume["role"] == "consumer" and "sample" not in consume
    assert (decode["monitor"]["submits"], decode["monitor"]["files"]) == \
        (2, 0)
    assert (consume["monitor"]["submits"], consume["monitor"]["files"]) == \
        (2, 2)
    cfg = registry.get_reduced("qwen3-4b")
    for rep in (decode["transit"], consume["transit"]):
        assert rep["via"] == "host" and rep["fields"] == 2
        assert rep["bytes_moved"] == 2 * 2 * 2 * cfg.vocab_size * 4
        assert rep["producer"]["processes"] == [0]
        assert rep["consumer"]["processes"] == [1]
    assert not list((tmp_path / "rank0").glob("*.npy"))
    got = sorted((tmp_path / "rank1").glob("logit_stats_*.npy"))
    want = sorted((tmp_path / "inplace").glob("logit_stats_*.npy"))
    assert [f.name for f in got] == [f.name for f in want] == [
        "logit_stats_000000.npy", "logit_stats_000001.npy"]
    for g, w in zip(got, want):
        assert np.array_equal(np.load(g), np.load(w))


@pytest.mark.parametrize("mode", ["read", "readwrite", "off"])
def test_serve_wisdom_installs_the_store(mode, tmp_path):
    """``--wisdom FILE --wisdom-mode M`` installs the FFT planner's
    wisdom store before serving, as the reference's serve does (once it
    raised: the wisdom flag's case above)."""
    from repro_torch.core.fft import plan as plan_mod
    path = tmp_path / "w.json"
    try:
        report = serve.main(["--reduced", "--device", "cpu", "--batch", "1",
                             "--prompt-len", "4", "--tokens", "2",
                             "--bench-out", "", "--wisdom", str(path),
                             "--wisdom-mode", mode])
        store = plan_mod.wisdom_store()
        assert len(report["sample"]) == 2
        if mode == "off":
            assert store is None
        else:
            assert store.path == path and store.mode == mode
    finally:
        plan_mod.set_wisdom(None)


def test_serve_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--bench-out", ""])


def test_serve_main_serves_given_params():
    """Parameters handed to ``main`` are the ones served: its greedy
    tokens are those of serial decoding with them."""
    cfg = registry.get_reduced("qwen3-4b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(7),
                            torch.float32)
    report = serve.main(["--reduced", "--device", "cpu", "--batch", "1",
                         "--prompt-len", "6", "--tokens", "4", "--seed",
                         "3", "--bench-out", ""], params=params)
    prompt = torch.randint(0, cfg.vocab_size, (1, 6),
                           generator=torch.Generator().manual_seed(3))
    assert report["sample"] == serial_greedy(cfg, params, prompt[0].numpy(),
                                             4)


def test_loaders_default_to_the_card():
    """Like every entry point of the port, weights and caches go to the
    CUDA device unless the caller asks for the CPU."""
    import inspect
    from repro_torch.serve import kvcache
    for fn in (params_from_jax, lm.init_decode_state, kvcache.init_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            kvcache.init_cache(1, 4, 1, 16)


def test_serve_monitor_keeps_tokens_and_writes_stats(tmp_path):
    """``--monitor-every 2 --monitor-batch 2``: the same tokens as the
    run without the monitor, one stats file a chain execute, the
    reference's ``monitor`` report keys and the submit row."""
    base = ["--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--tokens", "8"]
    plain = serve.main(base + ["--bench-out", ""])
    out = tmp_path / "bench.json"
    report = serve.main(base + [
        "--bench-out", str(out), "--monitor-every", "2",
        "--monitor-batch", "2", "--monitor-dir", str(tmp_path / "mon")])
    assert report["sample"] == plain["sample"]
    mon = report["monitor"]
    assert {"submits", "snapshots", "snapshot_batch", "files",
            "overlap_efficiency", "host_busy_ms", "backpressure_ms",
            "engine"} <= set(mon)
    assert set(mon["engine"]) == {"batched_execute_ratio", "submit_us_p50",
                                  "submit_us_p99", "queue_depth_max"}
    # decode steps 0, 2, 4, 6 -> 4 snapshots -> 2 executes of 2
    assert (mon["snapshots"], mon["submits"], mon["files"],
            mon["snapshot_batch"]) == (4, 2, 2, 2)
    assert mon["engine"]["batched_execute_ratio"] == 0.5
    files = sorted((tmp_path / "mon").glob("logit_stats_*.npy"))
    assert [f.name for f in files] == ["logit_stats_000000.npy",
                                       "logit_stats_000001.npy"]
    for f in files:
        stats = np.load(f)
        assert stats.shape == (5,) and np.isfinite(stats).all()
        lo, hi, mean, std, rms = stats
        assert lo <= mean <= hi and std >= 0 and rms >= abs(mean)
    rows = json.loads(out.read_text())["rows"]
    assert set(rows) == {"serve_run_prefill", "serve_run_decode_token",
                         "serve_run_monitor_submit"}
    assert rows["serve_run_monitor_submit"]["derived"] == \
        "submits=2 coalesced=4->2"


def test_monitor_chain_matches_reference(tmp_path):
    """The chain the port's ``_build_monitor`` builds and the chain the
    reference's builds, fed the same numpy logits batch: the same
    statistics and band energies (1e-5 of the largest), and the same
    written file."""
    import argparse

    from repro.core.insitu.bridge import BridgeData as JaxBridgeData
    from repro.launch.serve import _build_monitor as jax_build_monitor
    from repro_torch.core.insitu.bridge import BridgeData
    jcfg, cfg = (jregistry.get_reduced("qwen3-4b"),
                 registry.get_reduced("qwen3-4b"))
    jchain = jax_build_monitor(argparse.Namespace(
        batch=2, monitor_batch=3, monitor_dir=str(tmp_path / "jax")), jcfg)
    chain = serve._build_monitor(argparse.Namespace(
        batch=2, monitor_batch=3, monitor_dir=str(tmp_path / "port")), cfg,
        torch.device("cpu"))
    assert chain.mode == "pipelined"
    assert [ep.name for ep in chain.endpoints] == [
        ep.name for ep in jchain.endpoints]
    logits = (np.random.default_rng(4).standard_normal(
        (3, 2, cfg.vocab_size)) * 3 + 0.5).astype(np.float32)
    jout = jchain.execute(JaxBridgeData(
        arrays={"field": jnp.asarray(logits)}, step=7,
        meta={"primary": "field"}))
    out = chain.execute(BridgeData(arrays={"field": torch.from_numpy(logits)},
                                   step=7, meta={"primary": "field"}))
    jchain.drain()
    chain.drain(timeout=60)
    for key in ("insitu_stats", "insitu_kept_energy", "insitu_total_energy"):
        want = np.asarray(jout.arrays[key], np.float64)
        got = out.arrays[key].double().numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
    jfiles = jchain.finalize()["writer"]["files"]
    files = chain.finalize()["writer"]["files"]
    assert [f.rsplit("/", 1)[1] for f in files] == \
        [f.rsplit("/", 1)[1] for f in jfiles] == ["logit_stats_000007.npy"]
    want = np.load(jfiles[0]).astype(np.float64)
    assert np.abs(np.load(files[0]) - want).max() <= \
        1e-5 * np.abs(want).max()


def test_serve_elastic_needs_transit_consumers():
    """``--elastic`` alone has no consumer mesh to rescale: the
    reference's message, before any bring-up."""
    with pytest.raises(SystemExit, match="--elastic requires "
                                         "--transit-consumers"):
        serve.main(CPU + ["--elastic"])


def test_serve_elastic_on_three_ranks(tmp_path):
    """``--elastic --transit-consumers 2`` on three gloo CPU ranks: rank 0
    decodes the tokens of in-place serving; the two consumers run the
    monitor under the elastic controller, every rank ticking at each
    snapshot (no lease expires, so no rescale); every report carries the
    ``elastic`` block in place of ``transit``."""
    base = CPU + ["--batch", "2", "--prompt-len", "8", "--tokens", "8",
                  "--monitor-every", "2", "--monitor-batch", "2"]
    inplace = serve.main(base + ["--monitor-dir", str(tmp_path / "inplace")])
    reports = _serve_ranks(3, lambda r: base + [
        "--monitor-dir", str(tmp_path / f"rank{r}"),
        "--transit-consumers", "2", "--elastic"])
    decode, consumers = reports[0], reports[1:]
    assert decode["sample"] == inplace["sample"]
    assert (decode["monitor"]["submits"], decode["monitor"]["files"]) == \
        (2, 0)
    for rep in reports:
        assert "transit" not in rep
        el = rep["elastic"]
        assert el["state"] == "serving" and el["generation"] == 0
        assert el["events"] == [] and el["detector"]["dead"] == {}
        assert el["producer_devices"] == 1 and el["consumer_devices"] == 2
        assert el["bridge"]["fields"] == 2
        assert el["bridge"]["consumer"]["processes"] == [1, 2]
    for r, rep in enumerate(consumers, start=1):
        assert rep["role"] == "consumer" and "sample" not in rep
        assert rep["monitor"]["submits"] == 2
        # each consumer's monitor writes its own statistics
        assert sorted(f.name for f in (tmp_path / f"rank{r}").glob(
            "logit_stats_*.npy")) == ["logit_stats_000000.npy",
                                      "logit_stats_000001.npy"]
    assert not list((tmp_path / "rank0").glob("*.npy"))
