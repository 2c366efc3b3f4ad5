"""Multi-process cluster launcher on the PyTorch port — one host, N real
ranks (counterpart of ``tools/launch_multihost.py``).

Spawns ``--nprocs`` Python processes, each one rank of a
``torch.distributed`` world, wires the ``REPRO_*`` coordinator-discovery
env contract that ``repro_torch.runtime.cluster`` reads, and waits for
all of them. This is the bootstrap a real multi-node deployment uses;
only the placement (here: one machine) differs. A process is one rank
driving one device, so the reference's ``--devices-per-proc`` has no
counterpart: row names keep its ``{nprocs}x{dpp}`` form with dpp = 1.
The ranks run on the CUDA card unless ``--device cpu`` is given (on one
card they share ``cuda:0`` over gloo, ``cluster.pick_backend``); without
a card the launcher exits 2 with an error that names that flag. With
``--device cuda`` the parent builds the kernels first, so the ranks do
not race to build them.

Modes:

* ``--demo fft|transit|wire|solver|wisdom|elastic|all`` (default
  ``all``) — the built-in end-to-end demos, re-executing THIS file per
  rank. In a demo each rank stands for one host, as each process of the
  reference is one: it reports ``node<rank>`` in the ranks' hostname
  exchange, so a DCN axis crosses hosts as it would across nodes.
    - ``fft``: a DCN×ICI mesh from ``make_multihost_mesh``; pencil and
      slab3d plans whose all-to-alls cross hosts, and the r2c slab3d
      schedule, against the ``np.fft.fftn``/``rfftn`` oracles; the
      per-stage wire (bfloat16 on the DCN rotation only, asserted via
      ``FFTPlan.topology()`` and the measured sweep's
      ``wire_profile_candidates``); the ``decomp="measure"`` sweep.
    - ``transit``: disjoint producer/consumer meshes, a field through
      ``TransitBridge``, bit-identical delivery, a consumer-mesh FFT.
    - ``wire``: the block-scaled int8 wire within its error budget with
      a >= 2x byte win, the measured sweep's codec candidates and one
      winner agreed by every rank, ``send_async`` off the producer's
      wall (<= 0.7x blocking).
    - ``solver``: a Taylor–Green NS2D solve on the host-crossing mesh,
      the closed-form decay, every rank's identical E(k).
    - ``wisdom``: the SAME cluster booted twice against one wisdom file:
      the cold boot measures and persists, the warm boot plans from
      wisdom alone (hits > 0, zero timed candidates, asserted in the
      ranks); the launcher asserts the warm bring-up >= 5x faster.
    - ``elastic``: an ``ElasticController`` over a world of at least 4
      ranks (2 consumers; the reference's >= 3 devices a process): a cold
      measured plan on the consumer mesh, pending engine requests, pool
      rank 0's heartbeats dropped from step 2 (detected at step 3), the
      shrink 2 → 1 failing the pending requests with ``MeshRescaled``,
      a resubmit, the grow 1 → 2 planned from wisdom alone and
      bit-identical to generation 0, every transform within 1e-4 of max
      |X| of float64, then a radiating-source field through the
      controller to the Fig. 2 chain on the grown mesh and an engine
      batch across it. Each rank prints its record as one
      ``ELASTIC_RANK {json}`` line. ``--grid N0 N1`` sizes the field
      (default the reference's 16 x 32; the engine's requests take the
      grid capped at 2048 a side).
* ``-- CMD ...`` — run a command per rank under the cluster env (the
  command must call ``repro_torch.runtime.cluster.init_cluster()`` early,
  as the entry points and examples do, and is given its own
  ``--device``).

``REPRO_RANK_PROBE=FILE`` runs each rank's demos inside ``rank_probe()``
of that Python file, a harness that measures the rank.

Rank 0 emits ``BENCHROW,name,us_per_call,derived`` lines; ``--json
PATH`` collects them into a BENCH-style JSON artifact. Each rank of a
demo leaves through a closing ``dist.barrier()`` and
``cluster.shutdown_cluster()``.

Exit codes: 0 = success, 2 = no card for ``--device cuda`` (or a bad
flag), 99 = the ``torch.distributed`` bring-up failed, anything else =
failure.

Usage:
  python tools/launch_multihost_torch.py --nprocs 2 [--device cpu]
         [--demo fft|transit|all] [--json BENCH_multihost.json]
  python tools/launch_multihost_torch.py --nprocs 4 -- \\
         python examples/distributed_fft_3d_torch.py
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

UNSUPPORTED_RC = 99
UNSUPPORTED_MARK = "MULTIHOST-UNSUPPORTED"
ELASTIC_MARK = "ELASTIC_RANK "
ELASTIC_MIN_WORLD = 4
ELASTIC_GRID = (16, 32)
ELASTIC_ENGINE_MAX = 2048
ELASTIC_PENDING = 3
ELASTIC_CHAOS_STEPS = 8
ELASTIC_FFT_CALLS = 3
ELASTIC_TOL = 1e-4
KEEP_FRAC = 0.05


# ---------------------------------------------------------------------------
# Parent: spawn + supervise
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(proc_id: int, nprocs: int, port: int, device: str,
               extra_env=None) -> dict:
    env = dict(os.environ)
    env["REPRO_COORDINATOR"] = f"127.0.0.1:{port}"
    env["REPRO_NUM_PROCESSES"] = str(nprocs)
    env["REPRO_PROCESS_ID"] = str(proc_id)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    if device == "cpu":
        # N CPU ranks share one host's cores
        env.setdefault("OMP_NUM_THREADS", "1")
    if extra_env:
        env.update(extra_env)
    return env


def launch(nprocs: int, cmd, *, device: str = "cuda", timeout: float = 600.0,
           port: int = 0, extra_env=None):
    """Run ``cmd`` as ``nprocs`` coordinated ranks; returns (exit_code,
    list of per-rank stdout strings). ``extra_env`` entries are added to
    every rank's environment (e.g. the shared ``REPRO_WISDOM_FILE`` of
    the wisdom demo's two boots)."""
    port = port or _free_port()
    procs = [subprocess.Popen(
        cmd, env=_child_env(pid, nprocs, port, device, extra_env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)]
    # drain every rank's pipe CONCURRENTLY: a verbose rank that fills its
    # pipe would otherwise block on print while another waits for it at
    # a collective
    outs = [""] * nprocs

    def _drain(i, p):
        out, _ = p.communicate()
        outs[i] = out or ""

    threads = [threading.Thread(target=_drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    stuck = [p.poll() is None for p in procs]
    if any(t.is_alive() for t in threads):
        for p in procs:
            p.kill()
        for t in threads:
            # bounded grace: a grandchild can hold the pipe open past the
            # rank's death
            t.join(5.0)
    rcs = []
    for pid, p in enumerate(procs):
        rc = p.wait()
        if stuck[pid]:
            outs[pid] += (f"\n[launcher] process {pid} timed out after "
                          f"{timeout}s")
            rc = 124
        rcs.append(rc)
    for pid, out in enumerate(outs):
        for line in out.splitlines():
            print(f"[p{pid}] {line}")
    sys.stdout.flush()
    if any(rc == UNSUPPORTED_RC for rc in rcs) \
            or any(UNSUPPORTED_MARK in o for o in outs):
        return UNSUPPORTED_RC, outs
    bad = [rc for rc in rcs if rc != 0]
    return (bad[0] if bad else 0), outs


def _bench_rows(outs) -> dict:
    """Rank 0's BENCHROW lines as a BENCH-style row dict."""
    rows = {}
    for line in outs[0].splitlines():
        if not line.startswith("BENCHROW,"):
            continue
        _, name, us, derived = line.split(",", 3)
        rows[name] = {"us_per_call": round(float(us), 1), "derived": derived}
    return rows


def _collect_bench(rows: dict, json_path: str) -> None:
    """Write the ACCUMULATED rows (possibly from several launches) as one
    artifact."""
    payload = {"rows": rows, "unit": "us_per_call",
               "source": "tools/launch_multihost_torch.py"}
    Path(json_path).write_text(json.dumps(payload, indent=2,
                                          sort_keys=True) + "\n")
    print(f"[launcher] wrote {len(rows)} rows -> {json_path}")


def marked_records(stdout: str, mark: str = ELASTIC_MARK) -> list:
    """The ``MARK {json}`` records in a process's output, or in the
    launcher's (its ranks' lines prefixed ``[pN] ``), by rank."""
    recs = [json.loads(line[len(mark):]) for line in
            (raw.split("] ", 1)[-1] if raw.startswith("[p") else raw
             for raw in stdout.splitlines())
            if line.startswith(mark)]
    return sorted(recs, key=lambda r: r["rank"])


# ---------------------------------------------------------------------------
# Child: the built-in demos (run per rank, under the cluster env)
# ---------------------------------------------------------------------------

def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _bench_row(name: str, us: float, derived: str = "") -> None:
    if _rank() == 0:
        print(f"BENCHROW,{name},{us:.1f},{derived}", flush=True)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timeit(device, fn, *args, iters: int = 5) -> float:
    _sync(device)
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e6


def _allgather(obj) -> list:
    """Every rank's ``obj`` (the reference's ``process_allgather``)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return [obj]
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, obj)
    return seen


def _complex(pair):
    re, im = pair
    return re.cpu().numpy() + 1j * im.cpu().numpy()


def _demo_fft(device) -> None:
    import numpy as np

    from repro_torch.core.fft import rfft as rfft_mod
    from repro_torch.core.fft.plan import (FORWARD, plan_cache_stats,
                                           plan_dft, plan_rfft)
    from repro_torch.launch.mesh import describe_mesh, make_multihost_mesh

    nproc, dpp = _world(), 1
    rng = np.random.default_rng(0)
    N = (16 * nproc, 16, 16)
    x = rng.standard_normal(N).astype(np.float32)
    ref = np.fft.fftn(x)

    # DCN×ICI mesh: pencil's first rotation crosses hosts
    mesh = make_multihost_mesh(dcn_axes={"dcn": nproc},
                               ici_axes={"data": dpp}, device=device)
    print(f"mesh: {describe_mesh(mesh)}", flush=True)
    plan = plan_dft(N, FORWARD, mesh, decomp="pencil",
                    axis_names=("dcn", "data"))
    print(f"pencil topology: {plan.topology()}", flush=True)
    assert any(t["crosses_hosts"] for t in plan.topology()) == (nproc > 1)

    def run(p, arr):
        args = p.place(arr)
        got = _complex(p.unplace(*p.execute(*args)))
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        return err, _timeit(device, p.execute, *args)

    err, us = run(plan, x)
    print(f"pencil fftn rel err = {err:.2e}", flush=True)
    assert err < 1e-4, f"pencil mismatch vs oracle: {err}"
    _bench_row(f"multihost_fft_pencil_{nproc}x{dpp}", us,
               f"N={N[0]}x16x16;dcn_crossing={nproc > 1}")

    # 1-axis mesh: slab3d's single exchange crosses hosts
    mesh1 = make_multihost_mesh(dcn_axes={"dcn": nproc * dpp},
                                ici_axes={"data": 1}, device=device)
    p1 = plan_dft(N, FORWARD, mesh1, decomp="slab3d", axis_names=("dcn",))
    err1, us1 = run(p1, x)
    print(f"slab3d fftn rel err = {err1:.2e}", flush=True)
    assert err1 < 1e-4, f"slab3d mismatch vs oracle: {err1}"
    _bench_row(f"multihost_fft_slab3d_{nproc}x{dpp}", us1,
               f"N={N[0]}x16x16;one-exchange")

    # r2c schedule on the same cross-host slab3d topology: the
    # half-spectrum exchange must match the np.fft.rfftn oracle
    pr = plan_rfft(N, FORWARD, mesh1, decomp="slab3d", axis_names=("dcn",))
    args = pr.place(x)
    h = rfft_mod.half_bins(N[-1])
    gotr = _complex(pr.unplace(*pr.execute(*args)))[..., :h]
    refr = np.fft.rfftn(x)
    errr = float(np.max(np.abs(gotr - refr)) / np.max(np.abs(refr)))
    print(f"slab3d r2c rfftn rel err = {errr:.2e}", flush=True)
    assert errr < 1e-4, f"slab3d r2c mismatch vs oracle: {errr}"
    _bench_row(f"multihost_fft_slab3d_r2c_{nproc}x{dpp}",
               _timeit(device, pr.execute, *args),
               f"N={N[0]}x16x16;half-spectrum-exchange")

    # per-stage wire on the mixed DCN x ICI pencil topology: cast ONLY the
    # cross-host rotation, keep the ICI one exact — the policy the
    # measured knob sweep generates from the crosses_hosts flags
    prof = tuple("bfloat16" if t["crosses_hosts"] else None
                 for t in plan.topology())
    if any(prof) and not all(prof):
        pw = plan_dft(N, FORWARD, mesh, decomp="pencil",
                      axis_names=("dcn", "data"), wire_dtype=prof)
        wt = [(t["axis_name"], t["wire_dtype"], t["crosses_hosts"])
              for t in pw.topology()]
        print(f"per-stage wire topology: {wt}", flush=True)
        assert all((w == "bfloat16") == c for _, w, c in wt), wt
        _bench_row(f"multihost_fft_pencil_dcnwire_{nproc}x{dpp}",
                   _timeit(device, pw.execute, *pw.place(x)),
                   f"wire={prof};cast-DCN-only")
        # ...and the full measured sweep (decomp="measure", each candidate
        # knob-tuned) must GENERATE that candidate from the topology
        Ns = (12 * nproc, 12, 12)
        plan_dft(Ns, FORWARD, mesh, decomp="measure",
                 axis_names=("dcn", "data"), backend="measure")
        nprof = plan_cache_stats()["wire_profile_candidates"]
        print(f"measure sweep generated {nprof} per-stage wire "
              f"candidate(s)", flush=True)
        assert nprof >= 1, plan_cache_stats()

    # per-topology decomposition sweep (the slab/pencil call)
    swept = plan_dft(N, FORWARD, mesh, decomp="measure",
                     axis_names=("dcn", "data"))
    print(f"decomp='measure' on this topology chose: {swept.decomp}",
          flush=True)
    print("fft demo OK", flush=True)


def _placeholder(shape):
    import torch
    return torch.empty(shape, device="meta")


def _demo_transit(device) -> None:
    import numpy as np

    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft.plan import FORWARD, plan_dft
    from repro_torch.core.insitu.bridge import BridgeData
    from repro_torch.core.insitu.transit import TransitBridge
    from repro_torch.launch.mesh import make_transit_meshes

    half = _world() // 2
    pm, cm = make_transit_meshes(half, half, device=device)
    bridge = TransitBridge(pm, cm)
    print(f"transit via={bridge.via} producer={dict(pm.shape)} "
          f"consumer={dict(cm.shape)}", flush=True)

    rng = np.random.default_rng(7)
    field = rng.standard_normal((16, 32)).astype(np.float32)
    spec = ("data", None)
    px = (D.shard(field, pm, spec) if bridge.is_producer()
          else _placeholder(field.shape))
    t0 = time.perf_counter()
    out = bridge.send(BridgeData(arrays={"field": px}, step=0, spec=spec))
    us = (time.perf_counter() - t0) * 1e6

    if bridge.is_consumer():
        got = out.arrays["field"]
        cspec = out.spec or (None,) * field.ndim
        want = D.shard(field, cm, cspec).cpu().numpy()
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError("transit delivery not bit-identical")
        print("transit delivery bit-identical on consumer shards",
              flush=True)
        # consumer-side analysis that never touches producer ranks: a
        # distributed schedule on the consumer mesh (collective over its
        # ranks alone)
        whole = D.unshard(got, cm, cspec)
        cplan = plan_dft(field.shape, FORWARD, cm, decomp="slab")
        cplan.execute(*cplan.place(whole))
        _sync(device)
        print("consumer-mesh distributed FFT on delivered field OK",
              flush=True)
    _bench_row(f"multihost_transit_{_world()}p", us,
               f"bytes={bridge.report()['bytes_moved']}"
               f";via={bridge.via}")
    print("transit demo OK", flush=True)


def _demo_wire(device) -> None:
    """The compressed-wire exchange engine end to end: (1) a block-scaled
    int8 wire on the host-crossing slab3d exchange stays within the error
    budget against the numpy oracle while moving >= 2x fewer wire bytes;
    (2) the measured sweep GENERATES codec candidates for this topology
    and every rank agrees on one winner; (3) ``send_async`` takes the
    transit hop and the consumer analysis off the producer's wall
    (submit loop <= 0.7x blocking)."""
    import numpy as np
    import torch

    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft import wire
    from repro_torch.core.fft.plan import (FORWARD, plan_cache_stats,
                                           plan_dft, set_wire_sweep_policy)
    from repro_torch.core.insitu.bridge import BridgeData
    from repro_torch.core.insitu.transit import TransitBridge
    from repro_torch.launch.mesh import make_multihost_mesh, make_transit_meshes

    nproc, dpp = _world(), 1
    rng = np.random.default_rng(11)

    # --- compressed exchange within the error budget ---------------------
    WIRE_TOL = 1e-2
    mesh = make_multihost_mesh(dcn_axes={"dcn": nproc * dpp},
                               ici_axes={"data": 1}, device=device)
    N = (16 * nproc, 16, 16)
    x = rng.standard_normal(N).astype(np.float32)
    ref = np.fft.fftn(x)
    codec = wire.get_codec("int8_block8")
    p = plan_dft(N, FORWARD, mesh, decomp="slab3d", axis_names=("dcn",),
                 wire_dtype=codec.name)
    topo = p.topology()
    assert any(t["crosses_hosts"] for t in topo) == (nproc > 1)
    assert all(t["wire_codec"] == codec.name for t in topo), topo
    args = p.place(x)
    got = _complex(p.unplace(*p.execute(*args)))
    err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    print(f"compressed slab3d fftn rel err = {err:.2e} "
          f"(budget {WIRE_TOL})", flush=True)
    assert err <= WIRE_TOL, f"codec wire blew the error budget: {err}"
    exact_b = wire.exact_bytes(N, torch.complex64)
    wire_b = codec.wire_bytes(N, torch.complex64)
    print(f"wire bytes/exchange: exact={exact_b} {codec.name}={wire_b} "
          f"({exact_b / wire_b:.1f}x)", flush=True)
    assert wire_b * 2 <= exact_b, "compressed wire short of the 2x win"
    _bench_row(f"multihost_wire_{codec.name}_{nproc}x{dpp}",
               _timeit(device, p.execute, *args),
               f"maxrel={err:.1e};bytes_win={exact_b / wire_b:.2f}x")

    # --- the measured sweep generates + agrees codec candidates ----------
    if nproc == 1:
        set_wire_sweep_policy("always")     # no DCN hop to cross
    before = plan_cache_stats()["wire_codec_candidates"]
    swept = plan_dft(N, FORWARD, mesh, decomp="slab3d", axis_names=("dcn",),
                     backend="measure")
    ncand = plan_cache_stats()["wire_codec_candidates"] - before
    print(f"measured sweep generated {ncand} codec candidate(s)",
          flush=True)
    assert ncand >= 1, plan_cache_stats()
    winner = [(t["wire_codec"], t["wire_dtype"]) for t in swept.topology()]
    # the budget gate ran inside the sweep; agree the winner cluster-wide
    theirs = _allgather(repr(winner))
    assert all(w == theirs[0] for w in theirs), \
        f"sweep winner not cluster-agreed: {theirs}"
    print(f"sweep winner wire (cluster-agreed): {winner}", flush=True)

    # --- async transit: the hop leaves the producer's wall ---------------
    ndev = _world()
    pm, cm = make_transit_meshes(max(1, ndev // 2), max(1, ndev // 2),
                                 device=device)
    bridge = TransitBridge(pm, cm)
    field = rng.standard_normal((16, 32)).astype(np.float32)
    spec = ("data", None)
    px = (D.shard(field, pm, spec) if bridge.is_producer()
          else _placeholder(field.shape))
    delivered = []

    def _analyse(data):
        delivered.append(int(data.step))
        time.sleep(0.05)            # consumer-side analysis stand-in

    def _discard(_data):
        pass

    STEPS = 5
    on_result = _analyse if bridge.is_consumer() else _discard
    t0 = time.perf_counter()
    for s in range(STEPS):
        out = bridge.send(BridgeData(arrays={"field": px}, step=s, spec=spec))
        if bridge.is_consumer():
            _analyse(out)
    wall_block = time.perf_counter() - t0
    if bridge.is_consumer():
        assert delivered == list(range(STEPS)), delivered

    delivered.clear()
    bridge.reset_stats()
    t0 = time.perf_counter()
    for s in range(STEPS):
        bridge.send_async(BridgeData(arrays={"field": px}, step=s, spec=spec),
                          on_result=on_result, depth=STEPS)
    wall_async = time.perf_counter() - t0
    bridge.drain_async()
    rep = bridge.report()["async"]
    assert rep["completed"] == STEPS and rep["error"] is None, rep
    if bridge.is_consumer():
        assert delivered == list(range(STEPS)), delivered
    walls = np.asarray(_allgather([wall_block, wall_async]))
    wb, wa = float(walls[:, 0].max()), float(walls[:, 1].max())
    print(f"transit producer wall: blocking={wb:.3f}s "
          f"async={wa:.3f}s ({wa / wb:.2f}x)", flush=True)
    assert wa <= 0.7 * wb, f"async submit wall only {wa / wb:.2f}x blocking"
    _bench_row(f"multihost_transit_async_{nproc}p", wa / STEPS * 1e6,
               f"vs_blocking={wa / wb:.2f}x"
               f";overlap_eff={rep['overlap_efficiency']:.2f}")
    print("wire demo OK", flush=True)


def _demo_wisdom(device) -> None:
    """One bring-up of the measured planner under a shared wisdom file
    (``REPRO_WISDOM_FILE``, from the parent's wisdom phase).
    ``REPRO_WISDOM_PHASE`` says which boot this is: the cold boot must
    MEASURE (misses > 0, timed candidates > 0, winners persisted), the
    warm boot — a brand-new cluster, same topology — must plan purely
    from wisdom: hits > 0 and ZERO timed sweep candidates."""
    from repro_torch.core.fft.plan import (FORWARD, plan_cache_stats,
                                           plan_dft, wisdom_store)
    from repro_torch.launch.mesh import make_multihost_mesh

    phase = os.environ.get("REPRO_WISDOM_PHASE", "cold")
    store = wisdom_store()
    assert store is not None, \
        "wisdom demo needs REPRO_WISDOM_FILE in the child env"
    nproc, dpp = _world(), 1
    mesh = make_multihost_mesh(dcn_axes={"dcn": nproc},
                               ici_axes={"data": dpp}, device=device)
    # the sweep-heavy bring-up: decomp AND knobs measured (a small
    # non-power-of-two grid keeps the cold sweep short)
    N = (12 * nproc, 12, 12)
    t0 = time.perf_counter()
    plan = plan_dft(N, FORWARD, mesh, decomp="measure",
                    axis_names=("dcn", "data"), backend="measure")
    wall = time.perf_counter() - t0
    s = plan_cache_stats()
    print(f"wisdom[{phase}]: bring-up {wall:.2f}s decomp={plan.decomp} "
          f"wisdom_hits={s['wisdom_hits']} "
          f"wisdom_misses={s['wisdom_misses']} "
          f"timed={s['sweep_candidates_timed']} "
          f"store={store.stats()}", flush=True)
    if phase == "warm":
        assert s["wisdom_hits"] > 0, f"warm boot found no wisdom: {s}"
        assert s["sweep_candidates_timed"] == 0, \
            f"warm boot still timed sweep candidates: {s}"
    else:
        assert s["wisdom_misses"] > 0, s
        assert s["sweep_candidates_timed"] > 0, s
    _bench_row(f"multihost_wisdom_{phase}_{nproc}x{dpp}", wall * 1e6,
               f"decomp={plan.decomp}"
               f";timed={s['sweep_candidates_timed']}"
               f";wisdom_hits={s['wisdom_hits']}")
    print("wisdom demo OK", flush=True)


def _demo_solver(device) -> None:
    """A short Taylor–Green NS2D solve on a host-crossing mesh: every RK4
    stage's transforms cross ranks. Asserts the closed-form viscous decay
    E(t) = E0·e^{-4νt} and that every rank computes the IDENTICAL
    shell-summed spectrum (the in-situ monitoring agreement contract)."""
    import numpy as np

    from repro_torch.core.solver import NS2DSolver
    from repro_torch.launch.mesh import make_multihost_mesh

    nproc, dpp = _world(), 1
    mesh = make_multihost_mesh(dcn_axes={"dcn": nproc},
                               ici_axes={"data": dpp}, device=device)
    nu, dt, steps = 0.1, 0.01, 10
    s = NS2DSolver((32, 32), mesh, nu=nu, dt=dt, decomp="pencil2d",
                   axis_names=("dcn", "data"))
    s.init_taylor_green()
    e0 = s.energy()
    t0 = time.perf_counter()
    s.step(steps)
    got = s.energy()
    _sync(device)
    us = (time.perf_counter() - t0) / steps * 1e6
    want = e0 * float(np.exp(-4.0 * nu * steps * dt))
    err = abs(got - want) / want
    print(f"solver TG decay: E={got:.6f} want={want:.6f} "
          f"rel err={err:.2e}", flush=True)
    assert err < 1e-4, f"TG decay off the closed form: {err}"

    # spectrum agreement: every rank's own copy of the shell sums, gathered
    # — any divergence shows up as a row mismatch
    _, ek = s.spectrum(8)
    allp = np.asarray(_allgather(np.asarray(ek, np.float64)))
    spread = float(np.max(np.abs(allp - allp[0])))
    scale = float(np.max(np.abs(allp[0]))) or 1.0
    print(f"spectrum cross-process spread = {spread / scale:.2e}",
          flush=True)
    assert spread <= 1e-6 * scale, \
        f"processes disagree on E(k): spread={spread}"
    _bench_row(f"multihost_solver_ns2d_{nproc}x{dpp}", us,
               f"grid=32x32;pencil2d;decay_err={err:.1e}"
               f";spectrum_spread={spread / scale:.1e}")
    print("solver demo OK", flush=True)


def fig2_checks(got, res, mesh, dims, keep_frac: float = KEEP_FRAC) -> dict:
    """A delivered field (``got``) and the consumers' Fig. 2 chain output
    (``res``) against float64 (collective over ``mesh``): the denoised
    field's max abs error, the kept and total energies' relative errors,
    finiteness."""
    import torch

    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft.filters import lowpass_mask
    noisy = D.unshard(got.arrays["field"], mesh, got.spec).double()
    out = D.unshard(res.arrays["field"], mesh, res.spec).double()
    spec64 = torch.fft.fft2(noisy)
    power = spec64.real ** 2 + spec64.imag ** 2
    mask = lowpass_mask(dims, keep_frac).to(noisy.device)
    kept64, total64 = float((power * mask).sum()), float(power.sum())
    want = torch.fft.ifft2(spec64 * mask).real
    kept = float(res.arrays["insitu_kept_energy"])
    total = float(res.arrays["insitu_total_energy"])
    return {"field_max_abs_err": float((out - want).abs().max()),
            "kept_rel_err": abs(kept - kept64) / kept64,
            "total_rel_err": abs(total - total64) / total64,
            "finite": bool(torch.isfinite(out).all())}


def _demo_elastic(device, grid) -> None:
    """Elastic consumer-mesh rescale under injected failure (module
    docstring). Each rank prints its record (``ELASTIC_RANK``): the
    rescale events, the detection step, the cold and warm plans' seconds
    and candidates timed, the consumers' transform ms a call on each
    generation's mesh and its error against float64, the pending
    requests' errors, the Fig. 2 chain's and the engine's errors on the
    grown mesh."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft.plan import wisdom_store
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.bridge import BridgeData, GridMeta
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.launch.mesh import make_elastic_setup
    from repro_torch.runtime.cluster import cluster_info
    from repro_torch.runtime.fault import (HEARTBEAT_DROP, SLOW_RANK,
                                           FaultSchedule, InjectedFault,
                                           StragglerMonitor)
    from repro_torch.serve.fft_engine import FFTServeEngine

    world = _world()
    assert world >= ELASTIC_MIN_WORLD, \
        f"elastic demo wants >= {ELASTIC_MIN_WORLD} ranks, has {world}"
    assert wisdom_store() is not None, \
        "elastic demo needs REPRO_WISDOM_FILE in the child env"
    dims = tuple(grid)
    engine_shape = tuple(min(n, ELASTIC_ENGINE_MAX) for n in dims)
    events = []
    res = {"rank": _rank(), "dims": list(dims),
           "engine_shape": list(engine_shape)}
    step_box = [0]
    pm, ctl = make_elastic_setup(
        2, lease=1.0, max_misses=2, clock=lambda: float(step_box[0]),
        plan_kwargs={"decomp": "slab", "backend": "measure",
                     "allow_reduced_wire": False}, device=device)
    pool = ctl.consumer_ranks()
    res["pool"] = {str(r): v["rank"] for r, v in pool.items()}
    print(f"elastic: producer={pm.size}dev pool={pool}", flush=True)
    field = oracle = None
    if ctl.is_consumer():   # the same seeded field on every consumer
        g = torch.Generator(device=device).manual_seed(11)
        field = torch.randn(dims, generator=g, device=device,
                            dtype=torch.complex64)
        oracle = torch.fft.fft2(field.to(torch.complex128))
        xmax = float(oracle.abs().max())

    def transform(tag):
        """Plan on the current consumer mesh (timed: cold or warm), run
        ELASTIC_FFT_CALLS calls (host clock to the device's end), and
        hold this rank's output block against the oracle's."""
        mesh = ctl.consumer_mesh
        t0 = time.perf_counter()
        plan = ctl.plan(dims)
        plan_s = time.perf_counter() - t0
        stats = ctl.plan_stats()
        args = plan.place(field)
        ms = []
        for _ in range(ELASTIC_FFT_CALLS):
            _sync(device)
            t0 = time.perf_counter()
            out = plan.execute(*args)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        want = D.shard(oracle, mesh, plan.schedule().out_spec)
        got = torch.complex(out[0].double(), out[1].double())
        res[tag] = {"mesh": list(mesh.members), "plan_s": plan_s,
                    "backend": plan.backend,
                    "overlap_chunks": plan.overlap_chunks,
                    "sweep_candidates_timed":
                        stats["sweep_candidates_timed"],
                    "wisdom_hits": stats["wisdom_hits"],
                    "ms_per_call": statistics.median(ms), "ms": ms,
                    "rel_err": float((got - want).abs().max()) / xmax}
        return out

    def engine_err(fut, payload):
        want = np.fft.fft2(payload.astype(np.complex128))
        got = np.asarray(fut.result(timeout=300))
        return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))

    rng = np.random.default_rng(5)
    payloads = [(rng.standard_normal(engine_shape)
                 + 1j * rng.standard_normal(engine_shape))
                .astype(np.complex64) for _ in range(ELASTIC_PENDING)]
    t_start = time.perf_counter()
    # generation 0: cold measured bring-up, the winner recorded to wisdom
    out0 = transform("gen0") if ctl.is_consumer() else None
    if ctl.is_consumer():
        print(f"elastic[gen0]: cold plan {res['gen0']['plan_s']:.2f}s "
              f"stats={ctl.plan_stats()}", flush=True)
    eng = FFTServeEngine(ctl.consumer_mesh, max_batch=4, linger_s=10.0,
                         plan_kwargs={"decomp": "slab"})
    ctl.attach_engine(eng)
    pend = [eng.submit(x) for x in payloads] if ctl.is_consumer() else []
    # chaos: pool rank 0 drops its heartbeats from step 2; pool rank 1 is
    # briefly slow (mild: the percentile report must not evict it)
    sched = FaultSchedule([
        InjectedFault(mode=HEARTBEAT_DROP, step=2, rank=0),
        InjectedFault(mode=SLOW_RANK, step=1, rank=1, duration=2,
                      slow_factor=1.5)])
    mon = StragglerMonitor()
    ev = None
    for step in range(1, ELASTIC_CHAOS_STEPS):
        step_box[0] = step
        for r in ctl.active_ranks():
            mon.observe(step, 0.1 * sched.slow_factor(step, r), rank=r)
        ctl.heartbeat_all(drop=[r for r in ctl.active_ranks()
                                if sched.drops_heartbeat(step, r)])
        ev = ctl.tick(straggler_report=mon.rank_report())
        if ev is not None:
            break
    res["detected_at_step"] = step_box[0]
    assert ev is not None, "injected heartbeat drop never detected"
    assert ev["to_devices"] == 1 and not ev["drain"], ev
    events.append(ev)
    print(f"elastic[gen{ctl.generation}]: shrink 2->1 ({ev['reason']}) "
          f"wall={ev['wall_s']}s", flush=True)
    res["pending_errors"] = sorted({type(f.exception(60)).__name__
                                    for f in pend})
    # the resubmit and the shrunk (1,) mesh's plan, on the survivor
    if ctl.is_consumer():
        fut = eng.submit(payloads[0])
    eng.step(force=True)
    eng.drain(timeout=300)
    if ctl.is_consumer():
        res["resubmit_rel_err"] = engine_err(fut, payloads[0])
        transform("gen1")
    # grow back onto generation 0's topology: planning from wisdom alone
    t0 = time.perf_counter()
    events.append(ctl.rescale(n=2, rejoin_ranks=[0], drain=True,
                              reason="capacity rejoined"))
    assert ctl.generation == 2, ctl.report()
    if ctl.is_consumer():
        out2 = transform("gen2")
    grow_wall = time.perf_counter() - t0
    if ctl.is_consumer():
        s = ctl.plan_stats()
        res["bit_identical"] = bool(torch.equal(out0[0], out2[0])
                                    and torch.equal(out0[1], out2[1]))
        assert s["wisdom_hits"] > 0, f"grown mesh found no wisdom: {s}"
        assert s["sweep_candidates_timed"] == 0, \
            f"grown mesh still timed sweep candidates: {s}"
        assert res["bit_identical"], \
            "post-rescale FFT output not bit-identical to gen0"
        for g in ("gen0", "gen2"):
            assert res[g]["rel_err"] < ELASTIC_TOL, res[g]
        print(f"elastic[gen2]: warm plan {res['gen2']['plan_s']:.2f}s "
              f"stats={s} output bit-identical to gen0", flush=True)
        del out0, out2
    # the Fig. 2 chain on the grown mesh, fed through the controller
    if ctl.is_producer():
        data = RadiatingSourceAdaptor(dims, mesh=pm,
                                      spec=("data", None)).produce(0)
        data = data.replace(arrays={"field": data.arrays["field"]})
    else:
        data = BridgeData(arrays={"field": _placeholder(dims)})
    t0 = time.perf_counter()
    got = ctl.send(data)
    res["hop_s"] = time.perf_counter() - t0
    if ctl.is_consumer():
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": "slab"},
            {"endpoint": "bandpass", "keep_frac": KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": "slab"}]}, mesh=ctl.consumer_mesh, grid=GridMeta(dims))
        res["chain"] = fig2_checks(got, chain.execute(got),
                                   ctl.consumer_mesh, dims)
        chain.finalize()
        # the engine across the grown mesh: one agreed batch of two
        futs = [eng.submit(x) for x in payloads[1:]]
        eng.step(force=True)
        eng.drain(timeout=300)
        res["engine_across_rel_err"] = max(
            engine_err(f, x) for f, x in zip(futs, payloads[1:]))
    eng.stop()
    _sync(device)
    res.update(
        seconds=time.perf_counter() - t_start, cluster=cluster_info(),
        role=("producer" if ctl.is_producer() else "consumer"),
        events=[{k: e[k] for k in (
            "generation", "reason", "drain", "from_devices", "to_devices",
            "excluded_ids", "consumer_span", "plans_evicted", "engine",
            "wall_s")} for e in events],
        state=ctl.state, generation=ctl.generation)
    print(ELASTIC_MARK + json.dumps(res, default=str), flush=True)

    # fleet-level bench: restart-free rescale (drain + rebuild + warm
    # replan) against the cold bring-up it replaces
    walls = _allgather([res.get("gen0", {}).get("plan_s", 0.0),
                        grow_wall])
    cold, grow = (max(w[i] for w in walls) for i in (0, 1))
    _bench_row(f"elastic_rescale_{world}x1", grow * 1e6,
               f"cold_us={cold * 1e6:.0f};pool=2"
               f";generations={ctl.generation}")
    print("elastic demo OK", flush=True)


def _rank_probe():
    """The context a rank's demos run in: ``rank_probe()`` of the Python
    file that ``REPRO_RANK_PROBE`` names (a harness measuring each rank,
    as ``chip_smoke.py``'s counts its kernels' launches), else none."""
    path = os.environ.get("REPRO_RANK_PROBE")
    if not path:
        return contextlib.nullcontext()
    import importlib.util
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.rank_probe()


def _child_main(demo: str, device: str, grid) -> int:
    import torch
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to run the ranks on the "
              "CPU", file=sys.stderr, flush=True)
        return 2
    try:
        from repro_torch.runtime import cluster
        cluster.init_cluster(device=device)
    except Exception as err:  # noqa: BLE001 — bring-up failed
        print(f"{UNSUPPORTED_MARK}: {type(err).__name__}: {err}",
              flush=True)
        return UNSUPPORTED_RC
    # each rank stands for one host, as each process of the reference is
    # one: its meshes see "node<rank>" in the hostname exchange
    from repro_torch import compat
    node = f"node{_rank()}"
    compat._hostname = lambda: node
    print(f"cluster: {cluster.cluster_info()}", flush=True)
    with _rank_probe():
        if demo in ("fft", "all"):
            _demo_fft(device)
        if demo in ("transit", "all"):
            _demo_transit(device)
        if demo in ("wire", "all"):
            _demo_wire(device)
        if demo in ("solver", "all"):
            _demo_solver(device)
        if demo == "wisdom":
            # never part of a child's "all": one boot can't be cold AND
            # warm — the parent's wisdom phase launches two clusters
            _demo_wisdom(device)
        if demo == "elastic":
            # parent-phase-only too: a world of >= 4 ranks and a fresh
            # wisdom file, which _elastic_phase provides
            _demo_elastic(device, grid)
    import torch.distributed as dist
    if dist.is_initialized():
        # leave together: demo work is asymmetric (producers finish first)
        dist.barrier()
    cluster.shutdown_cluster()
    print("CHILD OK", flush=True)
    return 0


# ---------------------------------------------------------------------------

def _child_cmd(ns, demo: str) -> list:
    return [sys.executable, str(Path(__file__).resolve()), "--child",
            "--demo", demo, "--device", ns.device,
            "--grid", *map(str, ns.grid)]


def _wisdom_phase(ns, rows: dict) -> int:
    """Cold-vs-warm wisdom bring-up: boot the SAME cluster topology twice
    against one shared wisdom file. The ranks assert the planner-level
    contract (see ``_demo_wisdom``); the launcher asserts the fleet-level
    one: the warm boot's plan bring-up is >= 5x faster than cold. Both
    boots' BENCHROW lines are merged into ``rows``."""
    walls = {}
    with tempfile.TemporaryDirectory(prefix="repro_wisdom_") as tmp:
        wfile = os.path.join(tmp, "wisdom.json")
        for phase in ("cold", "warm"):
            rc, outs = launch(
                ns.nprocs, _child_cmd(ns, "wisdom"), device=ns.device,
                timeout=ns.timeout, port=ns.port,
                extra_env={"REPRO_WISDOM_FILE": wfile,
                           "REPRO_WISDOM_MODE": "readwrite",
                           "REPRO_WISDOM_PHASE": phase})
            if rc != 0:
                return rc
            prows = _bench_rows(outs)
            rows.update(prows)
            key = f"multihost_wisdom_{phase}_{ns.nprocs}x1"
            if key not in prows:
                print(f"[launcher] FAIL: {phase} wisdom boot emitted "
                      f"no {key} row")
                return 1
            walls[phase] = prows[key]["us_per_call"]
    speedup = walls["cold"] / max(walls["warm"], 1e-9)
    print(f"[launcher] wisdom bring-up: cold={walls['cold'] / 1e6:.2f}s "
          f"warm={walls['warm'] / 1e6:.2f}s ({speedup:.1f}x)")
    if speedup < 5.0:
        print(f"[launcher] FAIL: warm wisdom bring-up only "
              f"{speedup:.1f}x faster than cold (need >=5x)")
        return 1
    return 0


def _elastic_phase(ns, rows: dict) -> int:
    """Failure-driven rescale demo: boot a dedicated world of at least
    ELASTIC_MIN_WORLD ranks (2 producers at least and a pool of 2
    consumers) against a fresh shared wisdom file. The ranks assert
    detection, restart-free shrink, warm grow, and bit-identical output
    (see ``_demo_elastic``); the launcher asserts the bench row and the
    OK marker made it out."""
    world = max(ELASTIC_MIN_WORLD, ns.nprocs)
    with tempfile.TemporaryDirectory(prefix="repro_elastic_") as tmp:
        rc, outs = launch(
            world, _child_cmd(ns, "elastic"), device=ns.device,
            timeout=ns.timeout, port=ns.port,
            extra_env={"REPRO_WISDOM_FILE": os.path.join(tmp, "wisdom.json"),
                       "REPRO_WISDOM_MODE": "readwrite"})
    if rc != 0:
        return rc
    prows = _bench_rows(outs)
    rows.update(prows)
    key = f"elastic_rescale_{world}x1"
    if key not in prows:
        print(f"[launcher] FAIL: elastic demo emitted no {key} row")
        return 1
    if not any("elastic demo OK" in o for o in outs):
        print("[launcher] FAIL: elastic demo missing its OK marker")
        return 1
    row = prows[key]
    print(f"[launcher] elastic rescale: "
          f"{row['us_per_call'] / 1e6:.2f}s ({row['derived']})")
    return 0


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    passthrough = None
    if "--" in args:
        cut = args.index("--")
        args, passthrough = args[:cut], args[cut + 1:]

    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--demo", default="all",
                    choices=("fft", "transit", "wire", "solver",
                             "wisdom", "elastic", "all"))
    ap.add_argument("--device", default="cuda",
                    help="the ranks' torch device (default cuda; on one "
                         "card the ranks share it over gloo)")
    ap.add_argument("--grid", type=int, nargs=2, default=ELASTIC_GRID,
                    metavar=("N0", "N1"),
                    help="the elastic demo's field (default 16 32)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="collect rank 0's BENCHROW lines into a "
                         "BENCH-style JSON artifact")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--port", type=int, default=0,
                    help="coordinator port (default: pick a free one)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ns = ap.parse_args(args)

    if ns.child:
        rc = _child_main(ns.demo, ns.device, ns.grid)
        # past the closing barrier: leave without running the process
        # groups' destructors, whose gloo threads can abort a finished
        # rank at interpreter exit
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)

    import torch
    if ns.device.startswith("cuda"):
        if not torch.cuda.is_available():
            ap.error("no CUDA device; pass --device cpu to run the ranks "
                     "on the CPU")
        sys.path.insert(0, SRC)
        from repro_torch.kernels import _build
        _build.build()               # once, before the ranks start

    rc, rows = 0, {}
    if passthrough is not None or ns.demo not in ("wisdom", "elastic"):
        cmd = passthrough or _child_cmd(ns, ns.demo)
        rc, outs = launch(ns.nprocs, cmd, device=ns.device,
                          timeout=ns.timeout, port=ns.port)
        if rc == UNSUPPORTED_RC:
            print("[launcher] torch.distributed bring-up failed (rc 99)")
            return rc
        if passthrough is None:
            rows.update(_bench_rows(outs))
    if rc == 0 and passthrough is None and ns.demo in ("wisdom", "all"):
        rc = _wisdom_phase(ns, rows)
    if rc == 0 and passthrough is None and ns.demo in ("elastic", "all"):
        rc = _elastic_phase(ns, rows)
    if rc == UNSUPPORTED_RC:
        print("[launcher] torch.distributed bring-up failed (rc 99)")
        return rc
    if rc == 0 and ns.json and passthrough is None:
        _collect_bench(rows, ns.json)
    print(f"[launcher] {ns.nprocs} process(es) x 1 device on {ns.device}: "
          f"{'OK' if rc == 0 else f'FAILED rc={rc}'}")
    return rc


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.exit(code)
