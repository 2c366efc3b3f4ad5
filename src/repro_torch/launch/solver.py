"""Solver entry point (counterpart of ``repro/launch/solver.py``):

    python -m repro_torch.launch.solver --solver ns2d --grid 64 64 --device cpu

Runs the pseudo-spectral solvers (``core/solver``) as the in-situ
chain's producer: a time-stepping loop whose every stage flows through
the cached distributed FFT plans, with energy/enstrophy (or scalar
variance) reports every ``--monitor-every`` steps, the shell-summed
spectrum E(k) shipped through a pipelined ``WriterEndpoint`` chain
(``--spectra-dir``), checkpoint/restart via ``ckpt/`` (``--ckpt-dir
--ckpt-every``, ``--restore``), and ``--wisdom`` warm-start (a
restarted solver plans with zero timed sweeps). The flags, defaults,
report lines and summary keys are the reference's. It runs on the CUDA
device unless ``--device cpu`` is given; a missing card is an error,
never a move to the CPU.

Meshes: one process solves on a one-device host mesh
(``make_host_mesh``; ``--mesh-shape`` names its axes, every extent 1
here); a cluster (``--coordinator`` etc., or the ``REPRO_*`` env
contract, through ``runtime.cluster``) solves on ``make_multihost_mesh``
over every rank; ``--transit-consumers N`` solves on all ranks but the
last N (``make_transit_setup``) and ships each E(k) report to the
consumer mesh through ``TransitBridge.send`` (or ``send_async`` with
``--transit-async``), where the writer chain runs.

Consumer ranks do not solve. In the reference every process builds the
solver on the producer mesh (one program everywhere); here a rank outside
the producer mesh cannot execute its plans, so a consumer builds no
solver and calls ``send`` (or ``send_async``) once per report,
collectively, the count taken from ``--steps`` and ``--monitor-every``
— as ``serve --transit-consumers`` counts its monitor's fields.
``--elastic`` (with ``--transit-consumers``) puts the consumer mesh
under a ``runtime.elastic.ElasticController`` (``make_elastic_setup``),
which stands in for the bridge: every rank, consumers included, renews
the consumers' leases and calls the collective ``tick()`` once per
report, after draining pending ``--transit-async`` sends so that the
transit worker's hop never runs beside it. As in the reference, each
rank renews every lease just before it ticks, so the entry point's own
ticks expire none: a rescale comes from code that drives the controller
(the chaos scenario of ``tests/torch_ranks.py``). The summary's
``elastic`` block (``ElasticController.report()``) replaces
``transit``.
Checkpoints go to ``<ckpt-dir>/proc<rank>`` across ranks (each producer
rank writes the same gathered bytes to its own directory). Only rank 0
prints.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.core.fft import plan as plan_mod
from repro_torch.core.insitu.bridge import BridgeData, GridMeta
from repro_torch.core.insitu.chain import InSituChain
from repro_torch.core.insitu.endpoints.writer import WriterEndpoint
from repro_torch.core.solver import Boussinesq3DSolver, NS2DSolver
from repro_torch.launch.mesh import (make_elastic_setup, make_host_mesh,
                                     make_multihost_mesh, make_transit_setup)
from repro_torch.runtime.cluster import (add_cluster_args, config_from_args,
                                         init_cluster)


def _discard(_data):
    """--transit-async on_result for producer ranks: their send() result
    holds None leaves — drop it instead of keeping it until the drain."""


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def build_solver(args, mesh):
    grid = tuple(args.grid)
    common = dict(nu=args.nu, dt=args.dt, decomp=args.decomp,
                  real=not args.c2c, backend=args.backend,
                  stepper=args.stepper)
    if args.solver == "ns2d":
        if len(grid) != 2:
            raise SystemExit("--solver ns2d wants --grid N0 N1")
        s = NS2DSolver(grid, mesh, **common)
        if args.init == "taylor-green":
            s.init_taylor_green()
        else:
            s.init_random(seed=args.seed)
    else:
        if len(grid) != 3:
            raise SystemExit("--solver bq3d wants --grid N0 N1 N2")
        s = Boussinesq3DSolver(grid, mesh, kappa=args.kappa,
                               gravity=args.gravity, **common)
        if args.init == "beltrami":
            s.init_beltrami()
        else:
            s.init_random(seed=args.seed)
    return s


def _spectra_chain(args, mesh) -> InSituChain:
    return InSituChain(
        [WriterEndpoint(array="spectrum", out_dir=args.spectra_dir,
                        prefix=f"{args.solver}_spectrum")],
        mesh=mesh, mode="pipelined").initialize(
            grid=GridMeta(dims=tuple(args.grid)))


def _elastic_tick(args, bridge, elastic) -> None:
    """Lease renewal and the failure poll, once per report (collective
    on every rank): pending async sends drain first, so the transit
    worker's hop never runs beside the tick's collectives."""
    if args.transit_async:
        bridge.drain_async()
    elastic.heartbeat_all()
    elastic.tick()


def _consume(args, bridge, elastic=None) -> dict:
    """A consumer rank's run: no solver; the writer chain on each E(k)
    report the producers send, one ``send`` per report (and one elastic
    tick per report, as the producers tick)."""
    files = []
    chain = _spectra_chain(args, bridge.consumer_mesh) \
        if args.spectra_dir else None
    reports = -(-args.steps // args.monitor_every)
    for _ in range(reports):
        if chain is not None:
            placeholder = BridgeData(
                arrays={"spectrum": torch.empty(
                    (args.spectrum_bins,), dtype=torch.float32,
                    device="meta")},
                domain="spectral")
            if args.transit_async:
                bridge.send_async(placeholder, on_result=chain.execute)
            else:
                chain.execute(bridge.send(placeholder))
        if elastic is not None:
            _elastic_tick(args, bridge, elastic)
    if chain is not None:
        if args.transit_async:
            bridge.drain_async()
        files = chain.finalize().get("writer", {}).get("files", [])
    return {"solver": args.solver, "grid": list(args.grid),
            "role": "consumer", "steps": args.steps,
            "spectra_files": len(files),
            "elastic" if elastic is not None else "transit":
                bridge.report()}


def main(argv=None):
    """Solve as the flags say; return the summary (rank 0 prints it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="ns2d", choices=("ns2d", "bq3d"))
    ap.add_argument("--grid", type=int, nargs="+", default=[64, 64])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dt", type=float, default=5e-3)
    ap.add_argument("--nu", type=float, default=1e-3)
    ap.add_argument("--kappa", type=float, default=1e-3)
    ap.add_argument("--gravity", type=float, default=1.0)
    ap.add_argument("--decomp", default=None,
                    help="slab/pencil/pencil_tf/pencil2d/slab3d/measure "
                         "(default: inferred from grid rank and mesh)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--c2c", action="store_true",
                    help="run through full c2c plans instead of r2c/c2r")
    ap.add_argument("--stepper", default="if_rk4",
                    choices=("rk4", "if_rk4"))
    ap.add_argument("--init", default="auto",
                    help="taylor-green | beltrami | random | auto "
                         "(taylor-green for ns2d, beltrami for bq3d)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-shape", type=int, nargs="+", default=None,
                    help="one process's mesh axes (e.g. --mesh-shape 4 2 "
                         "names two axes); a process drives one device, "
                         "so every extent is 1")
    ap.add_argument("--monitor-every", type=int, default=5)
    ap.add_argument("--spectrum-bins", type=int, default=16)
    ap.add_argument("--spectra-dir", default=None,
                    help="persist per-report E(k) through a pipelined "
                         "WriterEndpoint chain (.npy per report)")
    ap.add_argument("--transit-consumers", type=int, default=0,
                    metavar="N",
                    help="M→N in-transit split: solve on all but the "
                         "last N ranks and ship each E(k) report to a "
                         "disjoint N-rank consumer mesh through "
                         "core/insitu/transit.TransitBridge (0 = "
                         "persist in place)")
    ap.add_argument("--transit-async", action="store_true",
                    help="overlap the transit hop with the next solve "
                         "interval: send_async() snapshots the E(k) "
                         "report and a bounded background worker runs "
                         "the exchange plus the consumer-side chain; "
                         "a failed hop surfaces on the next send or "
                         "drain (requires --transit-consumers)")
    ap.add_argument("--elastic", action="store_true",
                    help="put the transit consumer mesh under an "
                         "ElasticController: every rank renews the "
                         "consumers' leases every report, missed leases "
                         "trigger a restart-free rescale (requires "
                         "--transit-consumers)")
    ap.add_argument("--elastic-lease", type=float, default=30.0,
                    metavar="SECONDS",
                    help="heartbeat lease; a consumer rank missing 3 "
                         "leases is declared dead")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps (0 = off)")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--ckpt-dir before stepping")
    ap.add_argument("--wisdom", default=None, metavar="FILE",
                    help="persistent autotune wisdom file (read at "
                         "bring-up, new winners persisted)")
    ap.add_argument("--wisdom-mode", default="readwrite",
                    choices=("off", "read", "readwrite"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default cuda)")
    add_cluster_args(ap)
    args = ap.parse_args(argv)
    if args.monitor_every < 1:
        ap.error("--monitor-every must be at least 1")
    if args.restore and not args.ckpt_dir:
        ap.error("--restore needs --ckpt-dir")
    if args.init == "auto":
        args.init = "taylor-green" if args.solver == "ns2d" else "beltrami"
    if args.elastic and not args.transit_consumers:
        raise SystemExit("--elastic requires --transit-consumers N "
                         "(there is no consumer mesh to rescale)")
    if args.transit_async and not args.transit_consumers:
        raise SystemExit("--transit-async requires --transit-consumers "
                         "N (there is no transit hop to overlap)")
    if args.wisdom:
        plan_mod.set_wisdom(args.wisdom, args.wisdom_mode)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to solve on "
                           "the CPU")
    cluster = init_cluster(config_from_args(args), device=device)

    transit_bridge = None
    elastic = None
    if args.transit_consumers:
        # M→N in-transit: solve on a producer mesh excluding the last N
        # ranks; E(k) reports hop to the consumer mesh
        if args.elastic:
            # the controller duck-types the bridge: every send routes to
            # the newest generation's consumer mesh
            mesh, elastic = make_elastic_setup(
                args.transit_consumers, noun="solver",
                lease=args.elastic_lease, device=device)
            transit_bridge = elastic
        else:
            mesh, transit_bridge = make_transit_setup(
                args.transit_consumers, noun="solver", device=device)
        if not transit_bridge.is_producer():
            summary = _consume(args, transit_bridge, elastic)
            if _rank() == 0:
                print(json.dumps(summary, default=str))
            return summary
    elif cluster.multiprocess:
        mesh = make_multihost_mesh(device=device)
    else:
        shape = tuple(args.mesh_shape) if args.mesh_shape else (1,)
        names = ("data", "model")[: len(shape)]
        mesh = make_host_mesh(shape, names, device=device)

    t0 = time.perf_counter()
    solver = build_solver(args, mesh)
    bringup_s = time.perf_counter() - t0
    stats0 = solver.basis.plan_stats()

    if args.ckpt_dir and cluster.multiprocess:
        # the same gathered bytes on every rank, but the atomic tmp-dir
        # rename races across processes sharing one directory
        args.ckpt_dir = str(Path(args.ckpt_dir) / f"proc{_rank()}")
    if args.restore:
        step = solver.restore(args.ckpt_dir)
        print(f"restored step {step} (t={solver.t:.4f})")

    chain = None
    if args.spectra_dir and transit_bridge is None:
        chain = _spectra_chain(args, mesh)

    reports = []
    t1 = time.perf_counter()
    done = 0
    while done < args.steps:
        n = min(args.monitor_every, args.steps - done)
        solver.step(n)
        done += n
        rep = {"step": solver.step_count, "t": round(solver.t, 6),
               "energy": solver.energy()}
        if args.solver == "ns2d":
            rep["enstrophy"] = solver.enstrophy()
        else:
            rep["scalar_variance"] = solver.scalar_variance()
        reports.append(rep)
        if _rank() == 0:
            print(json.dumps(rep))
        if args.spectra_dir:
            _, ek = solver.spectrum(args.spectrum_bins)
            # spec (): one whole array on every rank, which the writer
            # gathers to the mesh's first rank and writes there once
            payload = BridgeData(arrays={"spectrum": torch.from_numpy(ek)},
                                 step=solver.step_count, domain="spectral",
                                 spec=())
            if transit_bridge is None:
                chain.execute(payload)
            elif args.transit_async:
                # a bounded background worker runs the exchange (and on
                # the consumers the writer chain), overlapping the next
                # solve interval; failures surface at the next send/drain
                transit_bridge.send_async(payload, on_result=_discard)
            else:
                # collective hop onto the consumer mesh; producers get
                # None leaves back
                transit_bridge.send(payload)
        if elastic is not None:
            # once per report, at the point every rank reaches
            _elastic_tick(args, transit_bridge, elastic)
        if (args.ckpt_every and args.ckpt_dir
                and solver.step_count % args.ckpt_every == 0):
            solver.save(args.ckpt_dir)
    wall = time.perf_counter() - t1

    if transit_bridge is not None and args.transit_async:
        # finish every pending hop (surfacing contained failures) before
        # the bridge reports
        transit_bridge.drain_async()
    files = []
    if chain is not None:
        fin = chain.finalize()
        files = fin.get("writer", {}).get("files", [])
    stats1 = solver.basis.plan_stats()
    summary = {
        "solver": args.solver, "grid": list(args.grid),
        "decomp": solver.basis.decomp, "real": solver.basis.real,
        "steps": args.steps, "wall_s": round(wall, 4),
        "steps_per_s": round(args.steps / max(wall, 1e-9), 3),
        "bringup_s": round(bringup_s, 4),
        "final": reports[-1] if reports else None,
        "spectra_files": len(files),
        "plan_stats": {"wisdom_hits": stats1["wisdom_hits"],
                       "sweep_candidates_timed":
                           stats1["sweep_candidates_timed"],
                       "bringup_misses": stats0["misses"]},
    }
    if transit_bridge is not None:
        summary["elastic" if elastic is not None else "transit"] = \
            transit_bridge.report()
    if _rank() == 0:
        print(json.dumps(summary, default=str))
    return summary


if __name__ == "__main__":
    main()
