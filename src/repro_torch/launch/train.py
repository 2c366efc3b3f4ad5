"""Training driver (counterpart of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch qwen3-4b --reduced --device cpu

Wires every layer together: config registry → model → train step under
the sharding policy of the live mesh → deterministic data → AdamW →
checkpoint/restart loop with straggler monitoring
(``runtime.fault.run_with_restarts``, the state placed back on the
device through ``train.step.state_shardings``) → the in-situ spectral
monitor running inside the step, its spectra optionally persisted
through a pipelined writer chain (``--insitu-spectra-dir``). The flags,
defaults, progress lines, validation messages and JSON summary are the
reference's; ``--device`` is the port's (``cuda`` unless ``cpu`` is
given; a missing card is an error, never a move to the CPU).

Meshes: one process trains on a one-rank host mesh; a world of several
ranks trains on the mesh over them (``make_host_mesh``: (2, 2)
``("data", "model")`` on four ranks; ``--production-mesh`` the (16, 16)
one), under ``make_policy(mesh, global_batch=--batch)``: TP over
``model``, FSDP and DP over ``data`` (``train/step.py``). Each rank
draws the same seeded init and keeps its blocks, and takes its rows of
each global batch (``data/pipeline.place_rows``). ``--transit-consumers
N`` trains on the first world − N ranks (a ``("data", "model")`` mesh
of extent world − N along ``data``) and ships each report's spectra to
the last N ranks (``launch/mesh.make_transit_setup``, or
``make_elastic_setup`` under ``--elastic``), where the writer chain
runs. Consumer ranks do not
train: they call ``send`` (or ``send_async``) once per report,
collectively, the count taken from ``--steps`` and ``--insitu-every``
and the spectra's shapes from the monitor run on ``meta`` tensors of
the model's shapes. Every rank renews the consumers' leases and ticks
the elastic controller once per report (a report replayed after a
restart sends nothing and ticks nothing, so producer and consumers
stay in step). A training mesh of several ranks checkpoints into
``--ckpt-dir`` itself: every rank gathers each leaf, the mesh's first
rank writes the whole arrays (a one-rank run's files), and a restart
cuts every rank's blocks from them. A one-rank training mesh in a world
of several ranks checkpoints into ``<ckpt-dir>/proc<rank>``. Without
``--transit-consumers`` only the mesh's first rank writes
``--insitu-spectra-dir``'s files.
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
from repro_torch.core.insitu.bridge import BridgeData
from repro_torch.core.insitu.chain import InSituChain
from repro_torch.core.insitu.endpoints.spectral_monitor import (
    SpectralMonitorEndpoint)
from repro_torch.core.insitu.endpoints.writer import WriterEndpoint
from repro_torch.data import synthetic
from repro_torch.data.pipeline import place_rows
from repro_torch.launch.mesh import (make_elastic_setup, make_host_mesh,
                                     make_production_mesh, make_transit_setup)
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime.cluster import (add_cluster_args, config_from_args,
                                         init_cluster)
from repro_torch.runtime.fault import run_with_restarts
from repro_torch.sharding.policy import make_policy
from repro_torch.train import step as train_step_mod


def _discard(_data):
    """--transit-async on_result for producer ranks: their send() result
    holds None leaves — drop it instead of keeping it until the drain."""


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _monitor() -> SpectralMonitorEndpoint:
    return SpectralMonitorEndpoint(source="grads", nbins=8, max_tensors=4)


def _spectra_chain(args, mesh=None) -> InSituChain:
    """The host offload of the monitor's spectra: the writer runs on the
    pipeline worker, so disk I/O overlaps the next train step."""
    return InSituChain(
        [WriterEndpoint(array="insitu_grad_spectra",
                        out_dir=args.insitu_spectra_dir, prefix="spectra")],
        mesh=mesh, mode="pipelined", pipeline_depth=2).initialize()


def _elastic_tick(args, bridge, elastic) -> None:
    """Lease renewal and the failure poll, once per report (collective
    on every rank): pending async sends drain first, so the transit
    worker's hop never runs beside the tick's collectives."""
    if args.transit_async:
        bridge.drain_async()
    elastic.heartbeat_all()
    elastic.tick()


def _consume(args, cfg, opt, bridge, elastic=None) -> dict:
    """A consumer rank's run: no model; the writer chain on each report
    the producer sends (one ``send`` per report, one elastic tick per
    report, as the producer)."""
    chain = None
    placeholder = None
    if args.insitu_spectra_dir and not args.no_insitu:
        chain = _spectra_chain(args, bridge.consumer_mesh)
        shapes = train_step_mod.train_state_shapes(cfg, opt,
                                                   max_target=args.seq)
        grads = train_step_mod.cast_params(shapes["params"], torch.bfloat16)
        arrays = _monitor().execute(BridgeData(arrays={"grads": grads})) \
            .arrays
        placeholder = BridgeData(arrays={
            k: v for k, v in arrays.items() if k.startswith("insitu_")})
    for step in range(0, args.steps, args.insitu_every):
        if chain is not None:
            data = placeholder.replace(step=step)
            if args.transit_async:
                bridge.send_async(data, on_result=chain.execute)
            else:
                chain.execute(bridge.send(data))
        if elastic is not None:
            _elastic_tick(args, bridge, elastic)
    out = {"arch": cfg.name, "role": "consumer", "steps": args.steps}
    if chain is not None:
        if args.transit_async:
            bridge.drain_async()
        chain.drain()
        out["spectra_files"] = len(chain.finalize()["writer"]["files"])
    out["elastic" if elastic is not None else "transit"] = bridge.report()
    return out


def main(argv=None):
    """Train as the flags say; return the summary (every rank prints its
    own, as the reference's processes do)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--insitu-every", type=int, default=10)
    ap.add_argument("--no-insitu", action="store_true")
    ap.add_argument("--insitu-spectra-dir", default=None,
                    help="persist per-report gradient spectra through a "
                         "pipelined host-offload chain (the .npy writes "
                         "overlap the next train step)")
    ap.add_argument("--transit-consumers", type=int, default=0,
                    metavar="N",
                    help="in-transit M→N split: train on the first rank "
                         "and deliver the in-situ spectra to the last N "
                         "ranks through core/insitu/transit.TransitBridge "
                         "(0 = analyze in place)")
    ap.add_argument("--transit-async", action="store_true",
                    help="overlap the M→N transit hop with the next "
                         "train step: send_async() snapshots the "
                         "report and a bounded background worker runs "
                         "the exchange plus the consumer-side chain; "
                         "a failed hop surfaces on the next send or "
                         "drain (requires --transit-consumers)")
    ap.add_argument("--elastic", action="store_true",
                    help="put the transit consumer mesh under an "
                         "ElasticController: consumer ranks heartbeat "
                         "every in-situ report, a rank that misses its "
                         "lease is rescaled away (and can rejoin) "
                         "without restarting the producer (requires "
                         "--transit-consumers)")
    ap.add_argument("--elastic-lease", type=float, default=30.0,
                    metavar="SECONDS",
                    help="heartbeat lease; a consumer rank missing 3 "
                         "leases is declared dead")
    ap.add_argument("--fail-at", type=int, nargs="*", default=None,
                    help="inject failures at these steps (FT test)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wisdom", default=None, metavar="FILE",
                    help="persistent autotune wisdom file: measured "
                         "sweep winners are read at bring-up and new "
                         "ones persisted, so restarts skip the timed "
                         "sweeps (overrides REPRO_WISDOM_FILE)")
    ap.add_argument("--wisdom-mode", default="readwrite",
                    choices=("off", "read", "readwrite"),
                    help="read = consult wisdom but never write it")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    add_cluster_args(ap)
    args = ap.parse_args(argv)
    if args.elastic and not args.transit_consumers:
        raise SystemExit("--elastic requires --transit-consumers N "
                         "(there is no consumer mesh to rescale)")
    if args.transit_async and not args.transit_consumers:
        raise SystemExit("--transit-async requires --transit-consumers N "
                         "(there is no transit hop to overlap)")
    cluster = config_from_args(args)
    world = cluster.num_processes
    if args.transit_consumers and args.transit_consumers >= world:
        raise SystemExit(f"--transit-consumers {args.transit_consumers} "
                         f"leaves no training ranks (have {world})")
    if args.wisdom:
        # before any measured planning (restarts warm-start from it)
        plan_mod.set_wisdom(args.wisdom, args.wisdom_mode)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    # multi-process bring-up (flags over env; one process: a no-op)
    init_cluster(cluster, device=device)

    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    opt = AdamW(warmup_cosine(args.lr, max(args.steps // 20, 1),
                              args.steps))
    transit_bridge = None
    elastic = None
    if args.transit_consumers:
        # M→N in-transit: the model trains on the producer rank; spectra
        # hop to the consumer mesh
        if args.elastic:
            # the controller duck-types the bridge: every send routes to
            # the newest generation's consumer mesh
            mesh, elastic = make_elastic_setup(
                args.transit_consumers, noun="training",
                lease=args.elastic_lease, device=device)
            transit_bridge = elastic
        else:
            mesh, transit_bridge = make_transit_setup(
                args.transit_consumers, noun="training", device=device)
        if not transit_bridge.is_producer():
            out = _consume(args, cfg, opt, transit_bridge, elastic)
            print(json.dumps(out, default=str))
            return out
    else:
        mesh = (make_production_mesh(device=device) if args.production_mesh
                else make_host_mesh(device=device))
    if world > 1 and mesh.size == 1:
        # a process training alone snapshots its own state: sharing one
        # directory would race on the atomic tmp-dir rename
        args.ckpt_dir = str(Path(args.ckpt_dir) / f"proc{_rank()}")
    policy = make_policy(mesh, global_batch=args.batch)

    insitu_chain = None
    if not args.no_insitu:
        insitu_chain = InSituChain([_monitor()], mesh=mesh).initialize()

    spectra_chain = None
    if args.insitu_spectra_dir and not args.no_insitu and (
            transit_bridge is not None or _rank() == mesh.first_rank):
        spectra_chain = _spectra_chain(args)

    step_fn = train_step_mod.make_train_step(
        cfg, policy, opt, microbatches=args.microbatches,
        loss_chunk=min(args.seq, 512),
        insitu_chain=(insitu_chain.as_step_hook() if insitu_chain
                      else None),
        insitu_every=args.insitu_every)

    def make_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return train_step_mod.init_train_state(
            cfg, opt, gen, param_dtype=torch.float32, max_target=args.seq,
            policy=policy)

    shapes = train_step_mod.train_state_shapes(cfg, opt,
                                               max_target=args.seq)
    state_place = train_step_mod.state_shardings(policy, shapes)
    state_gather = (train_step_mod.state_gathers(policy, shapes)
                    if not policy.one_rank else None)

    def batch_fn(step):
        b = synthetic.batch_at(
            step, global_batch=args.batch, seq_len=args.seq,
            vocab=cfg.vocab_size, seed=args.seed, family=cfg.family,
            num_patches=min(cfg.num_patches, args.seq // 2),
            patch_dim=lm.VIT_STUB_DIM, frame_dim=cfg.d_model)
        return place_rows(b, policy)

    losses = []
    reported = [-1]

    def on_metrics(step, metrics):
        loss = float(metrics["loss"])
        losses.append(loss)
        # on_metrics receives the post-increment step: metrics describe
        # train-step `step - 1`, the one the in-step monitor keyed on.
        # A report is due on the monitor's cadence, once: the monitor
        # publishes zeros on the steps it skips, and a restart replays
        # steps already reported (the writer's files stay one a step, in
        # step order, and consumers count one send a report)
        monitor_step = step - 1
        due = monitor_step % args.insitu_every == 0 \
            and monitor_step > reported[0]
        if due:
            reported[0] = monitor_step
        if due and spectra_chain is not None:
            payload = BridgeData(arrays=dict(metrics["insitu"]),
                                 step=monitor_step)
            if transit_bridge is None:
                spectra_chain.execute(payload)
            elif args.transit_async:
                # the bounded worker runs the exchange (and on the
                # consumers the writer chain), overlapping the next step
                transit_bridge.send_async(payload, on_result=_discard)
            else:
                # collective hop onto the consumer mesh; the producer
                # gets None leaves back
                transit_bridge.send(payload)
        if due and elastic is not None:
            _elastic_tick(args, transit_bridge, elastic)
        if step % 10 == 0 or step <= 2:
            extra = ""
            if "insitu" in metrics:
                hf = metrics["insitu"].get("insitu_highfreq_frac")
                if hf is not None:
                    extra = f" gradHF={float(hf):.3f}"
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e}"
                  f" gnorm {float(metrics['grad_norm']):.2f}{extra}",
                  flush=True)

    t0 = time.time()
    state, report = run_with_restarts(
        make_state=make_state, train_step=step_fn, batch_fn=batch_fn,
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, state_place=state_place,
        state_gather=state_gather, mesh=mesh, fail_at=args.fail_at,
        on_metrics=on_metrics)

    out = {"arch": cfg.name, "steps": args.steps,
           "first_loss": losses[0] if losses else None,
           "final_loss": losses[-1] if losses else None,
           "wall_s": round(time.time() - t0, 1), **report}
    if transit_bridge is not None and args.transit_async:
        # complete (and surface any contained failure from) every
        # pending hop before the bridge reports
        transit_bridge.drain_async()
    if spectra_chain is not None:
        spectra_chain.drain()
        pipe = spectra_chain.marshaling_report().get("pipeline", {})
        out["spectra_files"] = len(
            spectra_chain.finalize()["writer"]["files"])
        out["spectra_backpressure_ms"] = round(
            pipe.get("backpressure_s", 0.0) * 1e3, 2)
    if transit_bridge is not None:
        out["elastic" if elastic is not None else "transit"] = \
            transit_bridge.report()
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
