"""Serving entry point: prefill + batched greedy decode with the KV cache
(counterpart of ``repro/launch/serve.py``), on one device.

    python -m repro_torch.launch.serve --arch qwen3-4b --reduced --device cpu

runs a random prompt batch through prefill, then greedy decode, and
reports the prefill time, the decode time per token and tokens per
second. Parameters (unless the caller passes its own) and prompts are
drawn on the device from a seeded ``torch.Generator``. It runs on the CUDA device unless ``--device cpu``
is given; a missing card is an error, never a move to the CPU. Times on
the card are host clock around work that ends in
``torch.cuda.synchronize()``.

No mesh and no sharding policy are built (one device). ``--wisdom FILE``
(with ``--wisdom-mode off|read|readwrite``) installs the FFT planner's
persistent wisdom store before anything is planned, as the reference
does.

``--monitor-every K`` attaches a **pipelined in-situ chain** to the
decode loop (stats → FFT → bandpass on the last-token logits, host
writer at the tail): every K decode steps the last-token logits are
*submitted to an* :class:`~repro_torch.serve.fft_engine.FFTServeEngine`
``monitor`` bucket, and the engine coalesces ``--monitor-batch``
snapshots into ONE stacked field handed to the chain. The decode loop
never waits on the monitor: the chain's device stages are queued on the
decode stream behind the step that made the logits, the writer runs on
the pipeline worker once the field's CUDA event completes, and the
engine's bounded admission backpressures only if the analysis falls far
behind. The trailing partial batch goes through the same
``engine.flush()`` path as the in-loop submits. The report gains a
``monitor`` block (the chain's overlap numbers and the engine's
coalescing and queue accounting) and ``--bench-out`` a
``serve_run_monitor_submit`` row.

The reference's M→N transit, elastic consumer mesh and multi-process
cluster flags are accepted and raise ``NotImplementedError`` naming
their ROADMAP items.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.core.fft import plan as plan_mod
from repro_torch.models import lm

# flag -> (its "off" value, what it needs that the port does not have)
_CLUSTER = "multi-process clusters (ROADMAP queue 1 item 14)"
NOT_PORTED = {
    "transit_consumers": (0, "M→N transit (ROADMAP queue 1 item 14)"),
    "elastic": (False, "the elastic consumer mesh (ROADMAP queue 1 "
                       "item 17)"),
    "coordinator": (None, _CLUSTER),
    "num_processes": (None, _CLUSTER),
    "process_id": (None, _CLUSTER),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_monitor(args, cfg, device: torch.device):
    """The pipelined in-situ chain the decode loop feeds: one batched
    field of ``--monitor-batch`` stacked last-token logits per submit.
    Warmed on zeros before returning — plan/allocator warm-up and the
    chain's device-probe calibration must not land inside the timed
    decode loop."""
    from repro_torch.core.insitu.bridge import BridgeData, GridMeta
    from repro_torch.core.insitu.config import build_chain

    chain = build_chain({
        "mode": "pipelined",
        "chain": [
            {"endpoint": "stats", "array": "field"},
            {"endpoint": "fft", "array": "field", "direction": "forward",
             "local": True, "batch_ndim": 1},
            {"endpoint": "bandpass", "array": "field", "keep_frac": 0.25},
            {"endpoint": "writer", "array": "insitu_stats",
             "out_dir": args.monitor_dir, "prefix": "logit_stats"},
        ],
    }, mesh=None, grid=GridMeta((args.batch, cfg.vocab_size)))
    warm = BridgeData(
        arrays={"field": torch.zeros(
            (args.monitor_batch, args.batch, cfg.vocab_size),
            dtype=torch.float32, device=device)},
        step=0, meta={"primary": "field"})
    chain.execute(warm)           # first field: masks and allocations
    chain.execute(warm)           # consume the device-probe wait
    chain.drain()
    chain.reset_stats()
    writer = chain.endpoints[-1]  # drop the warm-up artifacts
    for f in writer.written:
        Path(f).unlink(missing_ok=True)
    writer.written.clear()
    return chain


def _attach_monitor_engine(args, chain):
    """Wire the chain behind an :class:`FFTServeEngine` ``monitor``
    bucket: the decode loop submits last-token logits; the engine
    coalesces ``--monitor-batch`` of them into one stacked ``BridgeData``
    per chain execute. Returns the engine in manual tick mode (the
    decode thread steps it, so ``chain.execute`` queues its kernels on
    the decode thread's stream)."""
    from repro_torch.core.insitu.bridge import BridgeData
    from repro_torch.serve.fft_engine import FFTServeEngine

    def execute_batch(payloads, step_idx):
        field = torch.stack(list(payloads))
        chain.execute(BridgeData(arrays={"field": field}, step=step_idx,
                                 meta={"primary": "field"}))
        return None

    engine = FFTServeEngine(max_pending=4 * args.monitor_batch,
                            linger_s=float("inf"))  # flush-at only
    engine.register_bucket("monitor", execute_batch,
                           flush_at=args.monitor_batch)
    return engine


def _emit_report_rows(report: dict, path: str) -> None:
    """End-of-run report as BENCH rows (the schema of
    ``benchmarks/run.py``): one row per headline latency, the full report
    under ``report``."""
    rows = {
        "serve_run_prefill": {
            "us_per_call": report["prefill_ms"] * 1e3,
            "derived": f"batch={report['batch']}"},
        "serve_run_decode_token": {
            "us_per_call": report["decode_ms_per_token"] * 1e3,
            "derived": f"tokens_per_s={report['tokens_per_s']}"},
    }
    if "monitor" in report:
        mon = report["monitor"]
        rows["serve_run_monitor_submit"] = {
            "us_per_call": mon["engine"]["submit_us_p50"],
            "derived": (f"submits={mon['submits']} "
                        f"coalesced={mon['snapshots']}->"
                        f"{mon['submits']}")}
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        {"rows": rows, "unit": "us_per_call",
         "source": "repro_torch.launch.serve", "report": report},
        indent=2, sort_keys=True) + "\n")


def main(argv=None, *, params=None):
    """Serve as the flags say; return the report. ``params`` (the port's
    parameters for the chosen config, on ``--device``) are served instead
    of random ones drawn from ``--seed``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--bench-out", default="results/BENCH_serve_run.json",
                    help="end-of-run report lands here as BENCH rows "
                         "('' prints it as JSON instead)")
    ap.add_argument("--monitor-every", type=int, default=0,
                    help="attach the pipelined in-situ logits monitor "
                         "every K decode steps (0 = off)")
    ap.add_argument("--monitor-batch", type=int, default=4,
                    help="snapshots batched into one chain execute")
    ap.add_argument("--monitor-dir", default="results/serve_monitor")
    ap.add_argument("--transit-consumers", type=int, default=0)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--wisdom", default=None, metavar="FILE",
                    help="persistent FFT autotune wisdom: measured sweep "
                         "winners are read at bring-up and new ones "
                         "written, so restarts skip the timed sweeps "
                         "(overrides REPRO_WISDOM_FILE)")
    ap.add_argument("--wisdom-mode", default="readwrite",
                    choices=("off", "read", "readwrite"),
                    help="read = consult wisdom but never write it")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    for flag, (off, needs) in NOT_PORTED.items():
        if getattr(args, flag) != off:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} needs {needs}, not ported yet")
    if args.wisdom:
        # before any measured planning, so a restart warm-starts from it
        plan_mod.set_wisdom(args.wisdom, args.wisdom_mode)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to serve on "
                           "the CPU")
    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if params is None:
        params = lm.init_params(cfg, gen, torch.float32)
    cache_len = args.prompt_len + args.tokens
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    monitor = (_build_monitor(args, cfg, device)
               if args.monitor_every else None)
    engine = (_attach_monitor_engine(args, monitor)
              if monitor is not None else None)
    snapshots = 0

    _sync(device)
    t0 = time.perf_counter()
    logits, state = lm.prefill(cfg, params, {"tokens": prompts},
                               cache_len=cache_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    t0 = time.perf_counter()
    for step in range(args.tokens):
        out_tokens.append(tok)
        logits, state = lm.decode_step(cfg, params, tok, state)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        if engine is not None and step % args.monitor_every == 0:
            # submit the last-token logits (still being computed) to the
            # monitor bucket; the engine coalesces --monitor-batch of
            # them into ONE chain execute per tick — the decode loop
            # never waits for the analysis
            engine.submit(logits[:, -1], bucket="monitor")
            snapshots += 1
            engine.step()
    _sync(device)
    t_decode = time.perf_counter() - t0
    if engine is not None:
        # trailing partial batch: the same flush helper as the in-loop
        # ticks, forced, outside the timed decode window
        engine.flush()
        engine.drain()

    gen_tokens = torch.cat(out_tokens, dim=1).cpu()
    report = {
        "arch": cfg.name,
        "batch": args.batch,
        "prompt_len": args.prompt_len,
        "tokens": args.tokens,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_token": t_decode / args.tokens * 1e3,
        "tokens_per_s": args.batch * args.tokens / t_decode,
        "sample": gen_tokens[0, :8].tolist(),
    }
    if monitor is not None:
        monitor.drain()
        erep = engine.report()
        engine.stop()
        mrep = monitor.marshaling_report()
        files = monitor.finalize()["writer"]["files"]
        pipe = mrep.get("pipeline", {})
        report["monitor"] = {
            "submits": erep["batching"]["executes"],
            "snapshots": snapshots,
            "snapshot_batch": args.monitor_batch,
            "files": len(files),
            "overlap_efficiency": pipe.get("overlap_efficiency", 0.0),
            "host_busy_ms": pipe.get("host_busy_s", 0.0) * 1e3,
            "backpressure_ms": pipe.get("backpressure_s", 0.0) * 1e3,
            "wait_ms": pipe.get("wait_s", 0.0) * 1e3,
            "dispatch_ms": pipe.get("dispatch_s", 0.0) * 1e3,
            "engine": {
                "batched_execute_ratio":
                    erep["batching"]["batched_execute_ratio"],
                "submit_us_p50": erep["latency_ms"]["p50"] * 1e3,
                "submit_us_p99": erep["latency_ms"]["p99"] * 1e3,
                "queue_depth_max": erep["queue"]["depth_max"],
            },
        }
    if args.bench_out:
        _emit_report_rows(report, args.bench_out)
        print(f"serve: decode {report['decode_ms_per_token']} ms/token, "
              f"{report['tokens_per_s']} tok/s -> {args.bench_out}")
    else:
        print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
