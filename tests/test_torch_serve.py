"""The port's continuous-batching engine and serve entry point on CPU: the
engine's tokens against the reference engine's on the same weights and
prompts (those of ``tests/test_engine.py``), and against the port's own
serial greedy decoding; slot reuse; the entry point's report; the pipelined
logits monitor (``--monitor-every``) against the run without it and its
chain against the reference's; the flags that need modules not ported
yet."""
import json

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
# monitor flag (flags0) and the wisdom flag (flags3), both now ported and
# tested below
@pytest.mark.parametrize("flags,item", [
    pytest.param(["--transit-consumers", "1"], "item 14",
                 id="flags1-item 14"),
    pytest.param(["--elastic"], "item 17", id="flags2-item 17"),
    pytest.param(["--coordinator", "localhost:1234"], "item 14",
                 id="flags4-item 14"),
    pytest.param(["--num-processes", "2"], "item 14", id="flags5-item 14"),
    pytest.param(["--process-id", "0"], "item 14", id="flags6-item 14"),
    pytest.param(["--arch", "dbrx-132b"], "item 18", id="flags7-item 18"),
])
def test_serve_flags_not_ported_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main(["--reduced", "--device", "cpu", "--bench-out", "",
                    *flags])


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
