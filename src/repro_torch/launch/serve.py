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
does. The reference's in-situ logits monitor, M→N transit, elastic
consumer mesh and multi-process cluster flags are accepted and raise
``NotImplementedError`` naming their ROADMAP items.
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
    "monitor_every": (0, "the pipelined in-situ chain and the FFT serving "
                         "engine (ROADMAP queue 1 items 11 and 15)"),
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
    ap.add_argument("--monitor-every", type=int, default=0)
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

    _sync(device)
    t0 = time.perf_counter()
    logits, state = lm.prefill(cfg, params, {"tokens": prompts},
                               cache_len=cache_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        out_tokens.append(tok)
        logits, state = lm.decode_step(cfg, params, tok, state)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
    _sync(device)
    t_decode = time.perf_counter() - t0

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
    if args.bench_out:
        _emit_report_rows(report, args.bench_out)
        print(f"serve: decode {report['decode_ms_per_token']} ms/token, "
              f"{report['tokens_per_s']} tok/s -> {args.bench_out}")
    else:
        print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
