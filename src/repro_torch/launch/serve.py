"""Serving entry point: prefill + batched greedy decode with the KV cache
(counterpart of ``repro/launch/serve.py``), on one device or across the
world's ranks.

    python -m repro_torch.launch.serve --arch qwen3-4b --reduced --device cpu

serves any decoder arch of the registry (dense, MoE, SSM, hybrid, and
the VLM on text tokens; whisper's enc-dec is refused, as in the
reference, and is served through ``models/encdec.py``). It runs a
random prompt batch through prefill, then greedy decode, and
reports the prefill time, the decode time per token and tokens per
second. Parameters (unless the caller passes its own) and prompts are
drawn on the device from a seeded ``torch.Generator``. It runs on the CUDA device unless ``--device cpu``
is given; a missing card is an error, never a move to the CPU. Times on
the card are host clock around work that ends in
``torch.cuda.synchronize()``.

One process builds no mesh and no sharding policy, so prefill takes
the flash kernel on the card. A world of several ranks decodes on the
mesh over them (``launch/mesh.make_host_mesh``: (2, 2) ``("data",
"model")`` on four ranks) under ``make_policy(mesh,
global_batch=--batch)``, as the reference does: TP over ``model``, the
batch and FSDP over ``data``. Every rank draws the same seeded
parameters and prompts and keeps its blocks, every rank decodes, the
logits are gathered whole for the greedy pick, and rank 0 prints (and
writes) the report. ``--wisdom FILE`` (with ``--wisdom-mode
off|read|readwrite``) installs the FFT planner's persistent wisdom store
before anything is planned, as the reference does.

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

Multi-process runs come up through ``runtime.cluster`` (``--coordinator
--num-processes --process-id``, or the ``REPRO_*`` env contract; flags
win). ``--transit-consumers N`` is the M→N in-transit split: the world's
last N ranks form the consumer mesh, the rest the producer mesh
(``launch/mesh.make_transit_setup``), and the monitor's warm-up and
every engine execute ride ``TransitBridge.send`` to the consumers, which
run the monitor chain and write its files. The first world − N ranks
decode, on a ``("data", "model")`` mesh of extent world − N along
``data`` (one rank: no policy); each of them submits the gathered
logits, so each sends. Without transit, across ranks, the mesh's first
rank alone runs the monitor. Consumer ranks do not
decode, yet each ``send`` is collective, so they call it exactly as
often, and in the same order, as the producer's monitor executes: the
warm-up, one per ``--monitor-batch`` snapshots, and the trailing flush,
counted from the flags (``_monitor_fields``); the bridge checks every
send's shapes and sequence number on every rank, and a rank missing a
send fails at the bridge's timeout, never hangs silently. The report
gains a ``transit`` block.

``--elastic`` (with ``--transit-consumers``) puts the consumer mesh under
a ``runtime.elastic.ElasticController`` (``make_elastic_setup``), which
stands in for the bridge. At every monitor snapshot each rank renews the
consumers' leases and calls the collective ``tick()``: the decode rank
after its engine tick, the consumers at the same snapshot, counted from
the flags as their sends are. As in the reference, each rank renews
every lease just before it ticks, so these ticks expire none. The
report's ``elastic`` block (``ElasticController.report()``) replaces
``transit``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.core.fft import plan as plan_mod
from repro_torch.models import lm
from repro_torch.runtime.cluster import (add_cluster_args, config_from_args,
                                         init_cluster)
from repro_torch.sharding.policy import make_policy


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _monitor_fields(args) -> list:
    """The leading extent of every field the monitor executes after its
    warm-up, in order: one per ``--monitor-batch`` snapshots, then the
    trailing flush's partial batch. The decode loop snapshots at steps
    0, K, 2K, ... below ``--tokens``."""
    snapshots = -(-args.tokens // args.monitor_every)
    full, rest = divmod(snapshots, args.monitor_batch)
    return [args.monitor_batch] * full + ([rest] if rest else [])


def _field(lead: int, args, cfg, device) -> "BridgeData":
    from repro_torch.core.insitu.bridge import BridgeData
    return BridgeData(
        arrays={"field": torch.zeros((lead, args.batch, cfg.vocab_size),
                                     dtype=torch.float32, device=device)},
        step=0, meta={"primary": "field"})


def _build_monitor(args, cfg, device: torch.device, bridge=None):
    """The pipelined in-situ chain the decode loop feeds: one batched
    field of ``--monitor-batch`` stacked last-token logits per submit.
    Warmed on zeros before returning — plan/allocator warm-up and the
    chain's device-probe calibration must not land inside the timed
    decode loop. With ``bridge`` (the M→N split) the warm-up rides the
    bridge too: every rank sends it (``send`` is collective), only the
    consumers build and warm the chain, and producers get None."""
    from repro_torch.core.insitu.bridge import GridMeta
    from repro_torch.core.insitu.config import build_chain

    warm = _field(args.monitor_batch, args, cfg,
                  "meta" if bridge is not None and not bridge.is_producer()
                  else device)
    if bridge is not None:
        warm = bridge.send(warm)
        if not bridge.is_consumer():
            bridge.reset_stats()  # warm-up must not skew the report
            return None
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
    chain.execute(warm)           # first field: masks and allocations
    chain.execute(warm)           # consume the device-probe wait
    chain.drain()
    chain.reset_stats()
    if bridge is not None:
        bridge.reset_stats()      # warm-up must not skew the report
    writer = chain.endpoints[-1]  # drop the warm-up artifacts
    for f in writer.written:
        Path(f).unlink(missing_ok=True)
    writer.written.clear()
    return chain


def _attach_monitor_engine(args, chain, bridge=None):
    """Wire the chain behind an :class:`FFTServeEngine` ``monitor``
    bucket: the decode loop submits last-token logits; the engine
    coalesces ``--monitor-batch`` of them into one stacked ``BridgeData``
    per chain execute (on the producer with ``bridge``: one ``send`` to
    the consumers). Returns the engine in manual tick mode (the decode
    thread steps it, so ``chain.execute`` queues its kernels on the
    decode thread's stream)."""
    from repro_torch.core.insitu.bridge import BridgeData
    from repro_torch.serve.fft_engine import FFTServeEngine

    def execute_batch(payloads, step_idx):
        payload = BridgeData(arrays={"field": torch.stack(list(payloads))},
                             step=step_idx, meta={"primary": "field"})
        if bridge is not None:
            payload = bridge.send(payload)
            if not bridge.is_consumer():
                return None       # producers hold None leaves, no chain
        chain.execute(payload)
        return None

    engine = FFTServeEngine(max_pending=4 * args.monitor_batch,
                            linger_s=float("inf"))  # flush-at only
    engine.register_bucket("monitor", execute_batch,
                           flush_at=args.monitor_batch)
    return engine


def _monitor_report(args, chain, engine, snapshots) -> dict:
    """The report's ``monitor`` block: the engine's coalescing on the
    rank that decodes, the chain's files and overlap on the rank that
    runs it (one rank does both without transit)."""
    rep = {"snapshots": snapshots, "snapshot_batch": args.monitor_batch,
           "files": 0}
    if engine is not None:
        erep = engine.report()
        engine.stop()
        rep["submits"] = erep["batching"]["executes"]
        rep["engine"] = {
            "batched_execute_ratio":
                erep["batching"]["batched_execute_ratio"],
            "submit_us_p50": erep["latency_ms"]["p50"] * 1e3,
            "submit_us_p99": erep["latency_ms"]["p99"] * 1e3,
            "queue_depth_max": erep["queue"]["depth_max"],
        }
    if chain is not None:
        chain.drain()
        pipe = chain.marshaling_report().get("pipeline", {})
        rep["files"] = len(chain.finalize()["writer"]["files"])
        rep.update({
            "overlap_efficiency": pipe.get("overlap_efficiency", 0.0),
            "host_busy_ms": pipe.get("host_busy_s", 0.0) * 1e3,
            "backpressure_ms": pipe.get("backpressure_s", 0.0) * 1e3,
            "wait_ms": pipe.get("wait_s", 0.0) * 1e3,
            "dispatch_ms": pipe.get("dispatch_s", 0.0) * 1e3})
    return rep


def _consume(args, cfg, bridge, device, elastic=None) -> dict:
    """A consumer rank's serve: no decode; the monitor chain on every
    field the producer's monitor sends, as many as it sends, and with
    ``elastic`` one tick a snapshot, as the decode rank ticks."""
    chain = _build_monitor(args, cfg, device, bridge)
    fields = _monitor_fields(args)

    def deliver(lead):
        chain.execute(bridge.send(_field(lead, args, cfg, "meta")))

    snapshots = sum(fields)
    for k in range(1, snapshots + 1):
        # the decode rank's engine sends when a batch fills, then ticks
        if k % args.monitor_batch == 0:
            deliver(args.monitor_batch)
        if elastic is not None:
            elastic.heartbeat_all()
            elastic.tick()
    if snapshots % args.monitor_batch:
        deliver(snapshots % args.monitor_batch)     # the trailing flush
    report = {"arch": cfg.name, "role": "consumer",
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "monitor": _monitor_report(args, chain, None, snapshots)}
    report["monitor"]["submits"] = len(fields)
    return report


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
    ap.add_argument("--transit-consumers", type=int, default=0,
                    metavar="N",
                    help="in-transit M→N split: decode on the first rank "
                         "and run the logits monitor on the last N ranks "
                         "(0 = analyse in place)")
    ap.add_argument("--elastic", action="store_true",
                    help="put the monitor's consumer mesh under an "
                         "ElasticController: leases renewed and failures "
                         "polled at every snapshot, a missed lease "
                         "rescales the consumer mesh without a restart "
                         "(requires --transit-consumers)")
    ap.add_argument("--elastic-lease", type=float, default=30.0,
                    metavar="SECONDS",
                    help="heartbeat lease; a consumer rank missing 3 "
                         "leases is declared dead")
    ap.add_argument("--wisdom", default=None, metavar="FILE",
                    help="persistent FFT autotune wisdom: measured sweep "
                         "winners are read at bring-up and new ones "
                         "written, so restarts skip the timed sweeps "
                         "(overrides REPRO_WISDOM_FILE)")
    ap.add_argument("--wisdom-mode", default="readwrite",
                    choices=("off", "read", "readwrite"),
                    help="read = consult wisdom but never write it")
    add_cluster_args(ap)
    args = ap.parse_args(argv)
    if args.elastic and not args.transit_consumers:
        raise SystemExit("--elastic requires --transit-consumers N "
                         "(there is no consumer mesh to rescale)")
    cluster = config_from_args(args)
    if args.transit_consumers:
        n, world = args.transit_consumers, cluster.num_processes
        if n >= world:
            raise SystemExit(f"--transit-consumers {n} leaves no decode "
                             f"ranks (have {world})")
    if args.wisdom:
        # before any measured planning, so a restart warm-starts from it
        plan_mod.set_wisdom(args.wisdom, args.wisdom_mode)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to serve on "
                           "the CPU")
    # multi-process bring-up (flags over env; one process: a no-op)
    init_cluster(cluster, device=device)
    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    if cfg.family == "encdec":
        raise SystemExit(f"{cfg.name} is an encoder-decoder: serve it "
                         f"through repro_torch.models.encdec.prefill and "
                         f"decode_step (frames and a decoder prompt)")
    bridge = elastic = mesh = None
    if args.transit_consumers:
        from repro_torch.launch.mesh import (make_elastic_setup,
                                             make_transit_setup)
        if args.elastic:
            # the controller duck-types the bridge: the monitor's warm-up
            # and every engine execute route to the newest consumer mesh
            mesh, elastic = make_elastic_setup(
                args.transit_consumers, noun="decode",
                lease=args.elastic_lease, device=device)
            bridge = elastic
        else:
            mesh, bridge = make_transit_setup(args.transit_consumers,
                                              noun="decode", device=device)
        if not bridge.is_producer():
            report = _consume(args, cfg, bridge, device, elastic) \
                if args.monitor_every else {"arch": cfg.name,
                                            "role": "consumer"}
            report["elastic" if elastic is not None else "transit"] = \
                bridge.report()
            print(json.dumps(report))
            return report
    elif cluster.multiprocess:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(device=device)
    policy = (make_policy(mesh, global_batch=args.batch)
              if mesh is not None and mesh.size > 1 else None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if params is None:
        params = lm.init_params(cfg, gen, torch.float32, policy=policy)
    cache_len = args.prompt_len + args.tokens
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    lead = policy is None or bridge is not None or \
        dist.get_rank() == mesh.first_rank
    monitor = engine = None
    if args.monitor_every and lead:
        monitor = _build_monitor(args, cfg, device, bridge)
        engine = _attach_monitor_engine(args, monitor, bridge)
    snapshots = 0

    def rows(t):       # this rank's rows of a global (B, ...) batch
        return t if policy is None else policy.named(
            policy.act_rows(t.dim()))(t)

    def whole(logits):  # the logits of every row and the whole vocab
        return logits if policy is None else policy.gather(
            logits, policy.act_logits(cfg.vocab_size))

    _sync(device)
    t0 = time.perf_counter()
    logits, state = lm.prefill(cfg, params, {"tokens": rows(prompts)},
                               policy, cache_len=cache_len)
    logits = whole(logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    t0 = time.perf_counter()
    for step in range(args.tokens):
        out_tokens.append(tok)
        logits, state = lm.decode_step(cfg, params, rows(tok), state, policy)
        logits = whole(logits)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        if engine is not None and step % args.monitor_every == 0:
            # submit the last-token logits (still being computed) to the
            # monitor bucket; the engine coalesces --monitor-batch of
            # them into ONE chain execute per tick — the decode loop
            # never waits for the analysis
            engine.submit(logits[:, -1], bucket="monitor")
            snapshots += 1
            engine.step()
            if elastic is not None:
                # lease renewal and the failure poll at monitor cadence;
                # tick() is collective, and every rank reaches it at the
                # same snapshot
                elastic.heartbeat_all()
                elastic.tick()
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
        "mesh": {} if policy is None else dict(mesh.shape),
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_token": t_decode / args.tokens * 1e3,
        "tokens_per_s": args.batch * args.tokens / t_decode,
        "sample": gen_tokens[0, :8].tolist(),
    }
    if engine is not None:
        report["monitor"] = _monitor_report(args, monitor, engine,
                                            snapshots)
    if bridge is not None:
        report["elastic" if elastic is not None else "transit"] = \
            bridge.report()
    if policy is not None and dist.get_rank() != 0:
        return report             # rank 0 reports
    if args.bench_out:
        _emit_report_rows(report, args.bench_out)
        print(f"serve: decode {report['decode_ms_per_token']} ms/token, "
              f"{report['tokens_per_s']} tok/s -> {args.bench_out}")
    else:
        print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
