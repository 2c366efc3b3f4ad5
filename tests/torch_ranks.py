"""Spawned gloo ranks on the CPU for the port's multi-rank tests.

``run_ranks(job, workdir, inputs)`` writes ``inputs`` to an ``.npz``,
starts ``WORLD`` processes of this file (one per rank; rendezvous
through a ``FileStore`` in ``workdir``, so concurrent test files do not
collide on a port), waits for them, and returns the arrays rank 0
saved. Each job runs the port only (no JAX) on its rank's blocks and
gathers what it checks to rank 0. The cases are defined here, so the
test files and the ranks agree on them.

    python tests/torch_ranks.py JOB RANK WORLD WORKDIR
"""
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 300

MESHES = {"1d": ((4,), ("data",)), "2d": ((2, 2), ("data", "model"))}
# decomposition -> (mesh, grid); every extent divides as each one needs
DECOMPS = {"slab": ("1d", (16, 24)), "slab3d": ("1d", (8, 12, 16)),
           "pencil": ("2d", (8, 12, 16)), "pencil_tf": ("2d", (8, 12, 16)),
           "pencil2d": ("2d", (8, 12)), "fourstep1d": ("1d", (64,))}
BATCH = 2
CASES = [(d, direction, batched) for d in DECOMPS
         for direction in ("forward", "backward")
         for batched in (False, True)]
OVERLAP = ("slab", "slab3d", "pencil", "pencil_tf", "pencil2d")
CHAINS = {"slab": ("1d", (64, 96)), "pencil2d": ("2d", (64, 96))}
KEEP_FRAC = 0.05
# fft -> bandpass -> ifft on the cyclic decompositions: the field comes
# in cyclic order along its first axis (the caller's ``cyc_<decomp>``
# input) and the spectrum is digit-permuted, so the mask is too
CYCLIC_CHAINS = {"pencil_tf": ("2d", (16, 8, 8)),
                 "fourstep1d": ("1d", (256,))}
CYCLIC_KEEP_FRAC = 0.2
# the pipelined chain across the ranks: the slab chain of CHAINS with a
# writer, PIPE_FIELDS fields against a queue of PIPE_DEPTH (more fields
# than the queue holds, so fields overlap), beside the insitu chain
PIPE_DECOMP = "slab"
PIPE_FIELDS = 4
PIPE_DEPTH = 2
# every (split, concat) pair of the builders' exchanges
A2A_PAIRS = ((-1, -2), (-2, -1), (-2, -3), (-3, -2), (-3, -4), (-4, -3))
A2A_LOCAL = (4, 8, 4, 8)


# the r2c/c2r decompositions (every one but fourstep1d) -> (mesh, grid)
RFFT_DECOMPS = {"slab": ("1d", (16, 24)), "slab3d": ("1d", (8, 12, 16)),
                "pencil": ("2d", (8, 12, 16)),
                "pencil_tf": ("2d", (8, 12, 16)),
                "pencil2d": ("2d", (8, 12))}
RFFT_CASES = [(d, direction, batched) for d in RFFT_DECOMPS
              for direction in ("forward", "backward")
              for batched in (False, True)]
# examples/insitu_rfft_batched.py's chain: 4 real fields a step, one
# batched r2c/c2r plan pair, on the (4,) mesh
RFFT_BATCH = (4, 128, 128)
RFFT_KEEP_FRAC = 0.08
# wire: the tiled exchange with each codec / wire dtype on the (4,) mesh,
# global (8, 16, 256) cut on the concat axis; the uniform int8 codec has
# one scale a row, so it cannot ride a split of the last axis
WIRE_GLOBAL = (8, 16, 256)
WIRE_PAIRS = ((-1, -2), (-2, -1), (-2, -3), (-3, -2))
WIRES = ("bfloat16", "bf16", "int8", "int8_block64")
WIRE_CASES = [(w, s, c) for w in WIRES for s, c in WIRE_PAIRS
              if not (w == "int8" and s == -1)]
# a complex slab with a wire on its exchange, against the exact wire (its
# exchange splits the last axis, which the uniform int8 codec refuses)
WIRE_SLAB = (16, 256)
SLAB_WIRES = ("bfloat16", "bf16", "int8_block64")
# measured planning on four ranks: the knob sweep of a slab, the decomp
# sweep of a 3-D grid, and a pencil2d whose "data" exchange crosses hosts
# on a mesh that names two hosts (codec candidates, the error budget)
MEASURE_SLAB = (16, 64)
MEASURE_3D = (8, 8, 8)
MEASURE_HOSTED = (16, 256)
MEASURE_HOSTS = ("a", "a", "b", "b")
# transit: the reference's (16, 8) case (tests/test_multihost.py:137-166)
# on a 2 -> 2 split, a (12, 8) field on 3 -> 1, five async fields; the
# Fig. 2 chain (with the stats endpoint) on the 2-rank consumer mesh; the
# ranks' fake hostnames for the multi-host mesh (host-major order 0, 2,
# 1, 3)
TRANSIT_FIELD = (16, 8)
TRANSIT_3TO1 = (12, 8)
TRANSIT_ASYNC = 5
TRANSIT_CHAIN = (64, 96)
TRANSIT_HOSTS = ("a", "b", "a", "b")
TRANSIT_MEASURE = (16, 64)

# the spectral solvers: (solver, decomposition, mesh, real) on four ranks,
# each held to the reference's run of the same decomposition on four host
# devices (fields, energies, and the basis tables each rank cut)
SOLVER_GRIDS = {"ns2d": (64, 64), "bq3d": (16, 16, 16)}
SOLVER_KW = {"ns2d": dict(nu=5e-3, dt=5e-3),
             "bq3d": dict(nu=0.02, kappa=0.02, gravity=1.0, dt=5e-3)}
SOLVER_STEPS = {"ns2d": 5, "bq3d": 3}
SOLVER_SEED = {"ns2d": 3, "bq3d": 5}
SOLVER_CASES = ([("ns2d", d, m, real)
                 for d, m in (("slab", "1d"), ("pencil2d", "2d"))
                 for real in (True, False)]
                + [("bq3d", d, m, real)
                   for d, m in (("slab3d", "1d"), ("pencil", "2d"),
                                ("pencil_tf", "2d"))
                   for real in (True, False)])
SOLVER_TABLES = ("k2", "inv_k2", "dealias", "weights")

# elastic: the reference's chaos scenario (tests/test_elastic.py:497-600)
# on four ranks, 2 producers and a pool of 2 consumers: the field its
# consumers transform, the engine's pending requests, the heartbeat drop
# of pool rank 0 from step 2 and a mildly slow pool rank 1; the async
# chaos (:654-716) on its (12, 8) field with a kill at step 2; the
# engine across the grown mesh (5 requests a batch of 4 and a partial);
# reshard between the (4,) mesh and the consumer mesh
ELASTIC_FIELD = (16, 24)
ELASTIC_PENDING = 3
ELASTIC_STEPS = 8
ELASTIC_ASYNC_FIELD = (12, 8)
ELASTIC_ASYNC_KILL = 2
ELASTIC_ACROSS = 5
RESHARD_FIELD = (16, 24)

def case_id(decomp, direction, batched):
    return f"{decomp}-{direction}-{'batched' if batched else 'single'}"


def wire_id(wire, split, concat):
    return f"{wire}_{split}_{concat}"


def solver_id(solver, decomp, real):
    return f"{solver}_{decomp}_{'r2c' if real else 'c2c'}"


def solver_case(ns2d_cls, bq3d_cls, case, mesh):
    """One case's solver (the reference's classes or the port's),
    initialized from the seed and stepped."""
    solver, decomp, _, real = case
    cls = ns2d_cls if solver == "ns2d" else bq3d_cls
    s = cls(SOLVER_GRIDS[solver], mesh, decomp=decomp, real=real,
            **SOLVER_KW[solver])
    s.init_random(seed=SOLVER_SEED[solver])
    s.step(SOLVER_STEPS[solver])
    return s


def solver_fields(s, solver):
    """The natural-layout real fields a case is held to (collective)."""
    if solver == "ns2d":
        return {"w": s.vorticity()}
    return {"u0": s.field("u0"), "b": s.field("b")}


def a2a_input(rank):
    """Rank ``rank``'s block for the exchange checks."""
    return (np.arange(np.prod(A2A_LOCAL), dtype=np.float32)
            .reshape(A2A_LOCAL) + 1e4 * rank)


def run_ranks(job, workdir, inputs, world=WORLD):
    workdir = Path(workdir)
    np.savez(workdir / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r),
                               str(world), str(workdir)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, "\n".join(
        f"--- rank {r} (exit {c})\n{log[-3000:]}"
        for r, (c, log) in enumerate(zip(codes, logs)))
    with np.load(workdir / "outputs.npz", allow_pickle=True) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------

def _meshes():
    from repro_torch.compat import make_mesh
    return {k: make_mesh(shape, names, device="cpu")
            for k, (shape, names) in MESHES.items()}


def job_distributed(inputs, out, workdir):
    import torch
    import torch.distributed as dist
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft.plan import plan_dft
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.bridge import BridgeData, GridMeta
    from repro_torch.core.insitu.config import build_chain
    meshes = _meshes()
    for decomp, direction, batched in CASES:
        cid = case_id(decomp, direction, batched)
        mesh = meshes[DECOMPS[decomp][0]]
        plan = plan_dft(DECOMPS[decomp][1], direction, mesh, decomp=decomp,
                        backend="pallas", batch_ndim=int(batched))
        r, i = plan.execute(*plan.place(inputs["in_" + cid]))
        r, i = plan.unplace(r, i, dst=0)
        if r is not None:
            out["out_" + cid] = (r + 1j * i).numpy()
    # overlap chunking against the unchunked run, bit for bit
    for decomp in OVERLAP:
        cid = case_id(decomp, "forward", False)
        mesh = meshes[DECOMPS[decomp][0]]
        x = inputs["in_" + cid]
        got = []
        for chunks in (0, 2):
            plan = plan_dft(DECOMPS[decomp][1], "forward", mesh,
                            decomp=decomp, backend="pallas",
                            overlap_chunks=chunks)
            got.append(plan.unplace(*plan.execute(*plan.place(x)), dst=0))
        if got[0][0] is not None:
            for chunks, (r, i) in zip((0, 2), got):
                out[f"overlap{chunks}_{decomp}"] = np.stack(
                    (r.numpy(), i.numpy()))
    # the functional wrappers
    x = inputs["in_" + case_id("fourstep1d", "forward", False)]
    mesh = meshes["1d"]
    r, i = D.fourstep_fft_1d(*[D.shard(torch.from_numpy(v), mesh, ("data",))
                               for v in (x.real.copy(), x.imag.copy())],
                             mesh, backend="pallas")
    rb, ib = D.fourstep_ifft_1d(r, i, mesh, backend="pallas")
    back = [D.unshard(v, mesh, ("data",), dst=0) for v in (rb, ib)]
    if back[0] is not None:
        out["fourstep_wrapper_round_trip"] = (back[0] + 1j * back[1]).numpy()
    # the Fig. 2 chain across the ranks, writer included
    for decomp, (mkey, dims) in CHAINS.items():
        mesh = meshes[mkey]
        spec = plan_dft(dims, "forward", mesh,
                        decomp=decomp).schedule().in_spec
        data = RadiatingSourceAdaptor(dims, mesh=mesh, spec=spec).produce(0)
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": decomp},
            {"endpoint": "bandpass", "keep_frac": KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": decomp},
            {"endpoint": "writer", "out_dir": str(workdir / decomp)},
        ]}, mesh=mesh, grid=data.grid)
        res = chain.execute(data)
        field = D.unshard(res.arrays["field"], mesh, res.spec, dst=0)
        files = chain.finalize()["writer"]["files"]
        if field is not None:
            out[f"chain_{decomp}_field"] = field.numpy()
            out[f"chain_{decomp}_written"] = np.load(files[0])
        seen = [None] * WORLD
        dist.all_gather_object(seen, (
            float(res.arrays["insitu_kept_energy"]),
            float(res.arrays["insitu_total_energy"]), len(files)))
        out[f"chain_{decomp}_energies"] = np.array(seen)
    _pipelined_chain(meshes, out, workdir)
    for decomp, (mkey, dims) in CYCLIC_CHAINS.items():
        mesh = meshes[mkey]
        spec = plan_dft(dims, "forward", mesh,
                        decomp=decomp).schedule().in_spec
        x = D.shard(inputs["cyc_" + decomp], mesh, spec)
        data = BridgeData(arrays={"field": (x, torch.zeros_like(x))},
                          grid=GridMeta(dims), layout="cyclic", spec=spec)
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": decomp},
            {"endpoint": "bandpass", "keep_frac": CYCLIC_KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": decomp},
        ]}, mesh=mesh, grid=data.grid)
        res = chain.execute(data)
        field = D.unshard(res.arrays["field"], mesh, res.spec, dst=0)
        if field is not None:
            out[f"cychain_{decomp}_field"] = field.numpy()
            out[f"cychain_{decomp}_layout"] = np.array(res.layout)
        seen = [None] * WORLD
        dist.all_gather_object(seen, (
            float(res.arrays["insitu_kept_energy"]),
            float(res.arrays["insitu_total_energy"])))
        out[f"cychain_{decomp}_energies"] = np.array(seen)


def _pipelined_chain(meshes, out, workdir):
    """The pipelined Fig. 2 chain across the ranks: each field's output
    against the insitu chain's on the same ranks (bit for bit), the
    writer's files (rank 0 only, in step order) and the gathered fields
    for the test to hold against the reference."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft.plan import plan_dft
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    from repro_torch.core.insitu.config import build_chain
    mkey, dims = CHAINS[PIPE_DECOMP]
    mesh = meshes[mkey]
    spec = plan_dft(dims, "forward", mesh,
                    decomp=PIPE_DECOMP).schedule().in_spec
    src = RadiatingSourceAdaptor(dims, mesh=mesh, spec=spec)
    fields = [src.produce(s) for s in range(PIPE_FIELDS)]

    def chain(mode):
        return build_chain({"mode": mode, "pipeline_depth": PIPE_DEPTH,
                            "chain": [
            {"endpoint": "fft", "direction": "forward", "backend": "pallas",
             "decomp": PIPE_DECOMP},
            {"endpoint": "bandpass", "keep_frac": KEEP_FRAC},
            {"endpoint": "fft", "direction": "backward", "backend": "pallas",
             "decomp": PIPE_DECOMP},
            {"endpoint": "writer", "out_dir": str(workdir / f"pipe_{mode}")},
        ]}, mesh=mesh, grid=src.grid)

    insitu = chain("insitu")
    want = [insitu.execute(f) for f in fields]
    insitu.finalize()
    piped = chain("pipelined")
    outs = [piped.execute(f) for f in fields]
    piped.drain(timeout=TIMEOUT_S / 2)
    pipe = piped.marshaling_report()["pipeline"]
    files = piped.finalize()["writer"]["files"]
    same = all(torch.equal(o.arrays["field"], w.arrays["field"])
               for o, w in zip(outs, want))
    seen = [None] * WORLD
    dist.all_gather_object(seen, (same, [Path(f).name for f in files],
                                  pipe["completed"], pipe["dropped"],
                                  pipe["queue_depth_max"]))
    out["pipe_ranks"] = np.array(seen, dtype=object)
    for k, o in enumerate(outs):
        field = D.unshard(o.arrays["field"], mesh, o.spec, dst=0)
        if field is not None:
            out[f"pipe_field_{k}"] = field.numpy()
            out[f"pipe_written_{k}"] = np.load(files[k])


def job_schedule(inputs, out, workdir):
    import torch
    import torch.distributed as dist
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft import schedule as S
    from repro_torch.core.fft.plan import plan_dft
    meshes = _meshes()
    rank = dist.get_rank()
    x = torch.from_numpy(a2a_input(rank))
    for mkey, mesh in meshes.items():
        for name in mesh.axis_names:
            g = mesh.group(name)
            order = dist.get_process_group_ranks(g)
            seen = [None] * WORLD
            dist.all_gather_object(seen, (order, dist.get_rank(g),
                                          mesh.coordinate[name]))
            if rank == 0:
                out[f"group_{mkey}_{name}"] = np.array(seen, dtype=object)
            for s, c in A2A_PAIRS:
                st = S.AllToAll(name, s, c, mesh.shape[name])
                (y,) = st.apply((x,), mesh)
                ys = [torch.empty_like(y) for _ in range(WORLD)]
                dist.all_gather(ys, y.contiguous())
                if rank == 0:
                    out[f"a2a_{mkey}_{name}_{s}_{c}"] = torch.stack(
                        ys).numpy()
        # the mini-schedules the reference runs in the same file
        for key in inputs:
            if not key.startswith(f"sched_{mkey}_"):
                continue
            sched = _mini_schedule(key, mesh)
            blocks = [D.shard(torch.from_numpy(inputs[key][k]), mesh,
                              sched.in_spec) for k in range(2)]
            r, i = S.execute_schedule(sched, mesh, *blocks)
            got = [D.unshard(v, mesh, sched.out_spec, dst=0) for v in (r, i)]
            if got[0] is not None:
                out["out_" + key] = np.stack([v.numpy() for v in got])
        topo = plan_dft((16, 16), "forward", mesh, decomp=(
            "slab" if mkey == "1d" else "pencil2d")).topology()
        if rank == 0:
            out[f"topology_{mkey}"] = np.array(
                [(t["axis_name"], t["shards"], t["crosses_hosts"])
                 for t in topo], dtype=object)
    # a second (2, 2) mesh makes its own axis groups, so its own plans; a
    # (4,) mesh's one axis is the default group, which both share
    shared = []
    for mkey, (shape, names) in MESHES.items():
        again = make_mesh(shape, names, device="cpu")
        grid = (16,) * (4 - len(shape))
        shared.append(plan_dft(grid, "forward", meshes[mkey])
                      is plan_dft(grid, "forward", again))
    out["plans_shared_per_mesh"] = np.array(shared)
    try:
        make_mesh((2,), ("data",), device="cpu")
        out["wrong_size_refused"] = np.array(False)
    except ValueError:
        out["wrong_size_refused"] = np.array(True)


def job_rfft(inputs, out, workdir):
    import torch
    import torch.distributed as dist
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft.plan import plan_cache_stats, plan_rfft
    from repro_torch.core.insitu.bridge import BridgeData, GridMeta
    from repro_torch.core.insitu.config import build_chain
    meshes = _meshes()
    for decomp, direction, batched in RFFT_CASES:
        cid = case_id(decomp, direction, batched)
        mesh = meshes[RFFT_DECOMPS[decomp][0]]
        plan = plan_rfft(RFFT_DECOMPS[decomp][1], direction, mesh,
                         decomp=decomp, backend="pallas",
                         batch_ndim=int(batched))
        y = plan.execute(*plan.place(inputs["rin_" + cid]))
        got = plan.unplace(*y, dst=0) if direction == "forward" \
            else plan.unplace(y, dst=0)
        if dist.get_rank() == 0:
            out["rout_" + cid] = ((got[0] + 1j * got[1]).numpy()
                                  if direction == "forward"
                                  else got.numpy())
    # overlap chunking on every real forward: bit-identical to unchunked
    for decomp, (mkey, grid) in RFFT_DECOMPS.items():
        mesh = meshes[mkey]
        x = inputs["rin_" + case_id(decomp, "forward", False)]
        got = []
        for chunks in (0, 2):
            plan = plan_rfft(grid, "forward", mesh, decomp=decomp,
                             backend="pallas", overlap_chunks=chunks)
            got.append(plan.unplace(*plan.execute(*plan.place(x)), dst=0))
        if dist.get_rank() == 0:
            out[f"roverlap_{decomp}"] = np.array(
                all(torch.equal(a, b) for a, b in zip(*got)))
    # examples/insitu_rfft_batched.py's chain, twice (the second step
    # served from the plan cache)
    mesh = meshes["1d"]
    dims = RFFT_BATCH[1:]
    grid = GridMeta(dims)
    cfg = {"mode": "insitu", "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "real": True, "batch_ndim": 1},
        {"endpoint": "bandpass", "array": "field",
         "keep_frac": RFFT_KEEP_FRAC, "use_kernel": False},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "real": True, "batch_ndim": 1}]}
    fields = inputs["batch_fields"]
    for step in (0, 1):
        before = plan_cache_stats()
        chain = build_chain(cfg, mesh=mesh, grid=grid)
        spec = chain.endpoints[0].plan.schedule().in_spec
        data = BridgeData(arrays={"field": D.shard(fields, mesh, spec)},
                          grid=grid, spec=spec)
        res = chain.execute(data)
        den = D.unshard(res.arrays["field"], mesh, res.spec, dst=0)
        if dist.get_rank() == 0:
            out[f"batch_step{step}_field"] = den.numpy()
            out[f"batch_step{step}_layout"] = np.array(res.layout)
        seen = [None] * WORLD
        dist.all_gather_object(seen, (
            float(res.arrays["insitu_kept_energy"]),
            float(res.arrays["insitu_total_energy"])))
        out[f"batch_step{step}_energies"] = np.array(seen)
        out[f"batch_step{step}_new_plans"] = np.array(
            plan_cache_stats()["misses"] - before["misses"])
    # the analysis endpoints across the ranks: global statistics of the
    # field's blocks, and the spectrum of the transposed (complex) and
    # transposed-half (real) spectra's blocks
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    dims = CHAINS["slab"][1]
    for real in (False, True):
        data = RadiatingSourceAdaptor(dims, mesh=mesh,
                                      spec=("data", None)).produce(0)
        chain = build_chain({"mode": "insitu", "chain": [
            {"endpoint": "stats"},
            {"endpoint": "fft", "direction": "forward", "real": real},
            {"endpoint": "spectrum", "nbins": 16}]}, mesh=mesh,
            grid=data.grid)
        res = chain.execute(data)
        seen = [None] * WORLD
        dist.all_gather_object(seen, [
            res.arrays[k].numpy().tolist() for k in
            ("insitu_stats", "insitu_spectrum_k", "insitu_spectrum_e")])
        out[f"analysis_real{int(real)}"] = np.array(seen, dtype=object)


def job_wire(inputs, out, workdir):
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft import plan as P
    meshes = _meshes()
    rank = dist.get_rank()
    # one exchange with each wire, as a one-stage schedule
    for wire, s, c in WIRE_CASES:
        key = "wire_" + wire_id(wire, s, c)
        sched = _wire_schedule(wire, s, c, meshes["1d"])
        x = D.shard(torch.from_numpy(inputs[key]), meshes["1d"],
                    sched.in_spec)
        (y,) = sched.stages[0].apply((x,), meshes["1d"])
        got = D.unshard(y, meshes["1d"], sched.out_spec, dst=0)
        if got is not None:
            out["out_" + key] = got.numpy()
    # the complex slab with each wire against the exact wire
    mesh = meshes["1d"]
    z = inputs["wire_slab"]
    for wire in (None,) + SLAB_WIRES:
        plan = P.plan_dft(WIRE_SLAB, "forward", mesh, decomp="slab",
                          backend="pallas", wire_dtype=wire)
        got = plan.unplace(*plan.execute(*plan.place(z)), dst=0)
        if rank == 0:
            out[f"slab_{wire}"] = (got[0] + 1j * got[1]).numpy()
    plan = P.plan_dft(WIRE_SLAB, "forward", mesh, decomp="slab",
                      backend="pallas", wire_dtype="int8")
    try:
        plan.execute(*plan.place(z))
        out["slab_int8_refused"] = np.array("")
    except ValueError as e:            # raised before any exchange
        out["slab_int8_refused"] = np.array(str(e))
    # measured planning: every rank caches the first rank's winner
    P.plan_cache_clear()
    mine = []
    slab = P.plan_dft(MEASURE_SLAB, "forward", mesh, backend="measure")
    mine.append(("slab", slab.backend, slab.overlap_chunks,
                 slab.wire_dtype))
    mesh2 = meshes["2d"]
    cube = P.plan_dft(MEASURE_3D, "forward", mesh2, decomp="measure")
    mine.append(("decomp", cube.decomp, cube.backend, cube.axis_names))
    both = P.plan_dft(MEASURE_3D, "backward", mesh2, decomp="measure",
                      backend="measure", real=True)
    mine.append(("both", both.decomp, both.backend, both.overlap_chunks,
                 both.wire_dtype))
    y = cube.unplace(*cube.execute(*cube.place(inputs["measure_cube"])),
                     dst=0)
    if rank == 0:
        out["measure_cube_out"] = (y[0] + 1j * y[1]).numpy()
    one_host = P.plan_cache_stats()["wire_codec_candidates"]
    # two named hosts: the "data" exchange of a pencil2d crosses them
    hosted = dataclasses.replace(mesh2, hosts=MEASURE_HOSTS)
    for tol in (1e-2, 1e-9):
        p = P.plan_dft(MEASURE_HOSTED, "forward", hosted, decomp="pencil2d",
                       backend="measure", wire_tol=tol)
        mine.append(("hosted", tol, p.backend, p.overlap_chunks,
                     p.wire_dtype))
    stats = P.plan_cache_stats()
    skips = [(sk.get("wire_dtype"), sk["error"], sk.get("max_rel_err"))
             for sk in P.autotune_skips()
             if sk.get("decomp") == "pencil2d"]
    seen = [None] * WORLD
    dist.all_gather_object(seen, mine)
    if rank == 0:
        out["measure_winners"] = np.array(seen, dtype=object)
        out["measure_codec_candidates"] = np.array(
            [one_host, stats["wire_codec_candidates"]])
        out["measure_profile_candidates"] = np.array(
            stats["wire_profile_candidates"])
        out["measure_hosted_skips"] = np.array(skips, dtype=object)
        out["measure_topology"] = np.array(
            [t["crosses_hosts"] for t in P.plan_dft(
                MEASURE_HOSTED, "forward", hosted,
                decomp="pencil2d").topology()])


def _wire_schedule(wire, s, c, mesh):
    """One exchange with ``wire`` between the specs that make it a full
    transform stage on the (4,) mesh."""
    from repro_torch.core.fft import schedule as S
    spec_in, spec_out = [None] * 3, [None] * 3
    spec_in[c] = spec_out[s] = "data"
    return S.Schedule("wire", 3, (S.AllToAll("data", s, c, mesh.shape["data"],
                                             wire),),
                      tuple(spec_in), tuple(spec_out), 1, 1)


def _mini_schedule(key, mesh):
    """``sched_<mesh>_<kind>_...``: one exchange or one twiddle between
    the specs that make it a full transform stage."""
    from repro_torch.core.fft import schedule as S
    parts = key.split("_")
    if parts[2] == "a2a":
        name, s, c = parts[3], int(parts[4]), int(parts[5])
        spec_in = [None] * 4
        spec_out = [None] * 4
        spec_in[c] = name
        spec_out[s] = name
        return S.Schedule(key, 4, (S.AllToAll(name, s, c,
                                              mesh.shape[name]),),
                          tuple(spec_in), tuple(spec_out))
    name, axis, sign = parts[3], int(parts[4]), float(parts[5])
    spec = [None] * 3
    spec[axis] = name
    return S.Schedule(key, 3, (S.Twiddle(axis, name, mesh.shape[name],
                                         sign),), tuple(spec), tuple(spec))


def transit_chain(mode, decomp, out_dir=None):
    """The Fig. 2 chain the transit consumers run, with the stats
    endpoint; ``out_dir`` adds the writer."""
    eps = [{"endpoint": "fft", "direction": "forward", "backend": "pallas",
            "decomp": decomp},
           {"endpoint": "bandpass", "keep_frac": KEEP_FRAC},
           {"endpoint": "fft", "direction": "backward", "backend": "pallas",
            "decomp": decomp},
           {"endpoint": "stats", "array": "field"}]
    if out_dir is not None:
        eps.append({"endpoint": "writer", "out_dir": str(out_dir)})
    return {"mode": mode, "pipeline_depth": PIPE_DEPTH, "chain": eps}


def job_transit(inputs, out, workdir):
    """The M→N bridge on four ranks: 2 -> 2 and 3 -> 1 bit identity and
    accounting, the guards, the async hop's three behaviours, the Fig. 2
    chain on the consumer mesh (insitu and pipelined, measured planning
    agreed among the consumers only), the multi-host mesh on fake
    hostnames, and a send the ranks disagree on or one rank skips."""
    import time

    import torch
    import torch.distributed as dist
    from repro_torch import compat
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft import plan as P
    from repro_torch.core.insitu.bridge import BridgeData
    from repro_torch.core.insitu.config import build_chain
    from repro_torch.core.insitu.pipeline import PipelineError
    from repro_torch.core.insitu.transit import (
        TransitBridge, require_producer_spans_cluster)
    from repro_torch.launch.mesh import (describe_mesh, make_multihost_mesh,
                                         make_transit_meshes,
                                         make_transit_setup)
    rank = dist.get_rank()
    mine = {}

    def gather(key, value):
        seen = [None] * WORLD
        dist.all_gather_object(seen, value)
        out[key] = np.array(seen, dtype=object)

    def placeholder(shape):
        return torch.empty(shape, device="meta")

    # 2 -> 2: the reference's (16, 8) case, a field and an (re, im) pair
    pm, cm = make_transit_meshes(2, 2, device="cpu")
    f = inputs["transit_f"]
    spec = ("data", None)
    bridge = TransitBridge(pm, cm)
    if bridge.is_producer():
        data = BridgeData(arrays={
            "f": D.shard(f, pm, spec),
            "s": (D.shard(f + 1, pm, spec), D.shard(f - 1, pm, spec))},
            step=3, spec=spec)
    else:
        data = BridgeData(arrays={"f": placeholder(f.shape),
                                  "s": (placeholder(f.shape),) * 2})
    got = bridge.send(data)
    rep = bridge.report()
    if bridge.is_consumer():
        whole = [D.unshard(x, cm, got.spec) for x in
                 (got.arrays["f"], *got.arrays["s"])]
        mine["2to2"] = (bool(np.array_equal(whole[0].numpy(), f)
                             and np.array_equal(whole[1].numpy(), f + 1)
                             and np.array_equal(whole[2].numpy(), f - 1)),
                        got.arrays["f"].device.type, list(got.spec),
                        got.step, tuple(got.arrays["f"].shape))
    else:
        mine["2to2"] = (got.arrays["f"] is None
                        and got.arrays["s"] == (None, None), got.step)
    mine["2to2_report"] = (rep["via"], rep["fields"], rep["bytes_moved"],
                           rep["producer"], rep["consumer"])
    # the same field whole on both producers: the lower rank's copy wins
    both = BridgeData(arrays={"f": torch.from_numpy(f.copy())
                              if bridge.is_producer()
                              else placeholder(f.shape)})
    got = bridge.send(both)
    if bridge.is_consumer():
        mine["replicated"] = bool(np.array_equal(
            D.unshard(got.arrays["f"], cm, got.spec).numpy(), f))
    # 3 -> 1
    pm3, cm3 = make_transit_meshes(3, 1, device="cpu")
    g = inputs["transit_g"]
    b3 = TransitBridge(pm3, cm3)
    got = b3.send(BridgeData(
        arrays={"g": D.shard(g, pm3, spec) if b3.is_producer()
                else placeholder(g.shape)}, spec=spec))
    mine["3to1"] = (bool(np.array_equal(got.arrays["g"].numpy(), g))
                    if b3.is_consumer() else got.arrays["g"] is None,
                    got.spec, b3.report()["bytes_moved"])
    # guards: overlap, device_put, a coverage gap, the role check
    refused = []
    for bad in ((pm, pm), (pm, cm)):
        try:
            TransitBridge(*bad, via="device_put" if bad[1] is cm else "auto")
            refused.append(None)
        except ValueError as err:
            refused.append(str(err))
    try:      # the second producer sends a placeholder: rows 8..15 miss
        bridge.send(BridgeData(arrays={
            "f": D.shard(f, pm, spec) if rank == pm.first_rank
            else placeholder(f.shape)}, spec=spec))
        refused.append(None)
    except ValueError as err:
        refused.append(str(err))
    require_producer_spans_cluster(pm, "--transit-consumers",
                                   consumer_mesh=cm)
    pm21, cm21 = make_transit_meshes(2, 1, device="cpu")
    try:
        require_producer_spans_cluster(pm21, "--transit-consumers",
                                       consumer_mesh=cm21)
        refused.append(None)
    except ValueError as err:
        refused.append(str(err))
    try:
        make_transit_setup(WORLD, device="cpu")
        refused.append(None)
    except SystemExit as err:
        refused.append(str(err))
    mine["refused"] = refused
    # async: in-order and bit-identical, drain mode
    fields = [inputs[f"transit_async_{k}"] for k in range(TRANSIT_ASYNC)]

    def field(k, arr):
        return BridgeData(arrays={"f": D.shard(arr, pm, spec)
                                  if bridge.is_producer()
                                  else placeholder(arr.shape)},
                          step=k, spec=spec)
    ab = TransitBridge(pm, cm)
    for k, arr in enumerate(fields):
        ab.send_async(field(k, arr), depth=2)
    delivered = ab.drain_async()
    arep = ab.report()["async"]
    mine["async"] = (
        [d.step for d in delivered],
        all(np.array_equal(D.unshard(d.arrays["f"], cm, d.spec).numpy(), a)
            for d, a in zip(delivered, fields))
        if ab.is_consumer() else all(d.arrays["f"] is None
                                     for d in delivered),
        sorted(arep), arep["completed"],
        0.0 <= arep["overlap_efficiency"] <= 1.0, ab.drain_async() == [])
    # backpressure: a slow hook bounds the queue at depth 1
    inflight = {"now": 0, "max": 0}

    def slow(data):
        inflight["now"] += 1
        inflight["max"] = max(inflight["max"], inflight["now"])
        time.sleep(0.05)
        inflight["now"] -= 1
    bb = TransitBridge(pm, cm)
    t0 = time.perf_counter()
    for k in range(6):
        bb.send_async(field(k, fields[0]), on_result=slow, depth=1)
    submit_wall = time.perf_counter() - t0
    bb.drain_async()
    brep = bb.report()["async"]
    mine["backpressure"] = (brep["completed"], brep["backpressure_s"] > 0.0,
                            submit_wall > 0.15, inflight["max"])
    # containment: a failed hop surfaces on the next send_async

    def dying(data):
        if data.step == 1:
            raise RuntimeError("consumer died")
    cb = TransitBridge(pm, cm)
    err = None
    try:
        for k in range(3):
            cb.send_async(field(k, fields[0]), on_result=dying, depth=2)
        cb.drain_async(raise_error=False)
        cb.send_async(field(9, fields[0]))
    except PipelineError as e:
        err = (e.step, e.endpoint, str(e.cause))
    crep = cb.report()["async"]
    mine["contained"] = (err, crep["dropped"], crep["error"] is not None)
    # the Fig. 2 chain on the consumer mesh, from the producers' field
    from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
    src = RadiatingSourceAdaptor(TRANSIT_CHAIN, mesh=pm, spec=spec)
    sent = []
    for step in range(2):
        data = src.produce(step) if bridge.is_producer() else BridgeData(
            arrays={"field": placeholder(TRANSIT_CHAIN),
                    "clean_reference": placeholder(TRANSIT_CHAIN)})
        sent.append(bridge.send(data))
    if bridge.is_consumer():
        runs = {}
        for mode in ("insitu", "pipelined"):
            chain = build_chain(transit_chain(
                mode, "slab", workdir / f"transit_{mode}"), mesh=cm,
                grid=sent[0].grid)
            res = [chain.execute(d) for d in sent]
            chain.drain()
            files = chain.finalize()["writer"]["files"]
            runs[mode] = (res, [Path(x).name for x in files])
        res = runs["insitu"][0][0]
        field_ = D.unshard(res.arrays["field"], cm, res.spec)
        mine["chain"] = (
            field_.numpy(),
            [float(res.arrays["insitu_kept_energy"]),
             float(res.arrays["insitu_total_energy"])],
            res.arrays["insitu_stats"].numpy(),
            D.unshard(sent[0].arrays["field"], cm, sent[0].spec).numpy(),
            runs["insitu"][1], runs["pipelined"][1],
            all(torch.equal(a.arrays["field"], b.arrays["field"])
                for a, b in zip(runs["insitu"][0], runs["pipelined"][0])))
        tuned = P.plan_dft(TRANSIT_MEASURE, "forward", cm,
                           backend="measure")
        mine["measured"] = (tuned.backend, tuned.overlap_chunks,
                            str(tuned.wire_dtype))
    # the multi-host mesh on fake hostnames: host-major ranks 0, 2, 1, 3
    compat._hostname = lambda: TRANSIT_HOSTS[rank]
    mh = make_multihost_mesh(device="cpu")
    x = inputs["transit_mh"]
    back = D.unshard(D.shard(x, mh, ("dcn", "data")), mh, ("dcn", "data"))
    y = P.plan_dft(x.shape, "forward", mh, decomp="pencil2d",
                   axis_names=("dcn", "data"), backend="pallas")
    fx = y.unplace(*y.execute(*y.place(x.astype(np.complex64))))
    try:
        make_multihost_mesh(ici_axes={"data": 4}, device="cpu")
        wrong = None
    except ValueError as e:
        wrong = str(e)
    mine["multihost"] = (describe_mesh(mh), mh.ranks,
                         bool(np.array_equal(back.numpy(), x)),
                         (fx[0] + 1j * fx[1]).numpy(), wrong)
    # a send the ranks disagree on, then one the consumers skip
    try:
        bridge.send(BridgeData(arrays={"f": D.shard(f, pm, spec)
                                       if bridge.is_producer()
                                       else placeholder((16, 9))},
                               spec=spec))
        disagree = None
    except ValueError as e:
        disagree = str(e)
    short = TransitBridge(pm, cm, timeout_s=3)
    missed = None
    if short.is_producer():
        t0 = time.perf_counter()
        try:
            short.send(BridgeData(arrays={"f": D.shard(f, pm, spec)},
                                  spec=spec))
        except RuntimeError as e:
            missed = (str(e), time.perf_counter() - t0)
    mine["mismatch"] = (disagree, missed)
    gather("transit", mine)


def job_elastic(inputs, out, workdir):
    """The elastic consumer mesh on four ranks: the reference's chaos
    scenario (cold measured bring-up, a dropped heartbeat detected, a
    failure-driven shrink failing the engine's pending requests, a
    resubmit, a grow planned from wisdom alone, bit-identical output),
    the engine across the grown two-rank mesh, the async chaos, and
    ``distributed.reshard``. Every rank's results go to rank 0."""
    import torch
    import torch.distributed as dist
    from repro_torch.compat import make_mesh
    from repro_torch.core.fft import distributed as D
    from repro_torch.core.fft import plan as P
    from repro_torch.core.insitu.bridge import BridgeData
    from repro_torch.core.insitu.pipeline import PipelineError
    from repro_torch.launch.mesh import make_consumer_mesh, make_elastic_setup
    from repro_torch.runtime.fault import (HEARTBEAT_DROP, KILL_AT_STEP,
                                           SLOW_RANK, FaultSchedule,
                                           InjectedFault, StragglerMonitor)
    from repro_torch.serve.fft_engine import FFTServeEngine
    res = {}
    P.set_wisdom(workdir / "wisdom.json", "readwrite")
    step_box = [0]
    pm, ctl = make_elastic_setup(
        2, lease=1.0, max_misses=2, clock=lambda: float(step_box[0]),
        plan_kwargs={"decomp": "slab", "backend": "measure",
                     "allow_reduced_wire": False}, device="cpu")
    res["producer_devices"] = pm.size
    res["pool"] = {str(r): v["rank"] for r, v in ctl.consumer_ranks().items()}
    field = inputs["elastic_field"]
    ref = np.fft.fftn(field)

    def rel(got, want):
        return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))

    def run_fft():      # the consumers', collective over their mesh
        plan = ctl.plan(field.shape)
        re, im = plan.unplace(*plan.execute(*plan.place(field)))
        return re.numpy() + 1j * im.numpy()

    # generation 0: cold measured bring-up, winners recorded to wisdom
    if ctl.is_consumer():
        out0 = run_fft()
        st = ctl.plan_stats()
        res.update(cold_timed=st["sweep_candidates_timed"],
                   cold_wisdom_hits=st["wisdom_hits"],
                   cold_err=rel(out0, ref), out0=out0)
    # a serving engine rides the consumer mesh; requests stay pending
    eng = FFTServeEngine(ctl.consumer_mesh, max_batch=4, linger_s=10.0,
                         plan_kwargs={"decomp": "slab"})
    ctl.attach_engine(eng)
    pend = [eng.submit((field + i).astype(np.complex64))
            for i in range(ELASTIC_PENDING)] if ctl.is_consumer() else []
    # chaos: pool rank 0 drops its heartbeats from step 2; pool rank 1 is
    # briefly slow (mild: the percentile report must not evict it)
    sched = FaultSchedule([
        InjectedFault(mode=HEARTBEAT_DROP, step=2, rank=0),
        InjectedFault(mode=SLOW_RANK, step=1, rank=1, duration=2,
                      slow_factor=1.5)])
    mon = StragglerMonitor()
    ev = None
    for step in range(1, ELASTIC_STEPS):
        step_box[0] = step
        for r in ctl.active_ranks():
            mon.observe(step, 0.1 * sched.slow_factor(step, r), rank=r)
        ctl.heartbeat_all(drop=[r for r in ctl.active_ranks()
                                if sched.drops_heartbeat(step, r)])
        ev = ctl.tick(straggler_report=mon.rank_report())
        if ev is not None:
            break
    res["detected_at_step"] = step_box[0]
    res["shrink"] = None if ev is None else {
        k: ev[k] for k in ("generation", "to_devices", "drain",
                           "plans_evicted", "engine", "reason",
                           "excluded_ids", "consumer_span", "wall_s")}
    res["rank1_alive"] = 1 in ctl.detector.alive_ranks()
    res["pending_errors"] = sorted({type(f.exception(5)).__name__
                                    for f in pend})
    res["straggler_resets"] = mon.resets
    # containment is per request: a resubmit runs on the rebuilt mesh
    if ctl.is_consumer():
        f2 = eng.submit(field.astype(np.complex64))
    else:
        try:
            eng.submit(field.astype(np.complex64))
            res["outside_submit"] = None
        except ValueError as err:
            res["outside_submit"] = str(err)
    eng.step(force=True)
    eng.drain(timeout=120.0)
    if ctl.is_consumer():
        res["resubmit_err"] = rel(np.asarray(f2.result(timeout=30)), ref)
        out1 = run_fft()             # the shrunk mesh's plan is right too
        res["shrunk_err"] = rel(out1, ref)
    res["engine_rescales"] = eng.report()["rescales"]
    # grow back: generation 0's topology, so planning is wisdom alone
    ev2 = ctl.rescale(n=2, rejoin_ranks=[0], drain=True,
                      reason="capacity rejoined")
    res["grow"] = {k: ev2[k] for k in ("generation", "to_devices",
                                       "excluded_ids", "consumer_span",
                                       "wall_s")}
    if ctl.is_consumer():
        out2 = run_fft()
        st = ctl.plan_stats()
        res.update(warm_timed=st["sweep_candidates_timed"],
                   warm_wisdom_hits=st["wisdom_hits"],
                   bit_identical=bool(np.array_equal(out0, out2)))
        # the engine across the grown mesh: the first rank decides each
        # tick (a full batch of 4 at once, the partial only when forced)
        fields = [(field * (i + 1)).astype(np.complex64)
                  for i in range(ELASTIC_ACROSS)]
        e0 = eng.stats()["executes"]
        futs = [eng.submit(f) for f in fields]
        real = eng.submit(field, op="bandpass", real=True, keep_frac=0.25)
        ticks = [eng.step(), eng.step(force=True)]
        eng.drain(timeout=120.0)
        one = FFTServeEngine(make_mesh((1,), ("data",), device="cpu"),
                             linger_s=0.0)
        want = one.submit(field, op="bandpass", real=True, keep_frac=0.25)
        one.drain(timeout=120.0)
        one.stop()
        res["across"] = {
            "ticks": ticks,
            "fft_err": max(rel(np.asarray(f.result(timeout=30)),
                               np.fft.fftn(x)) for f, x in zip(futs, fields)),
            "bandpass_err": rel(np.asarray(real.result(timeout=30)),
                                np.asarray(want.result(timeout=30))),
            "executes": eng.stats()["executes"] - e0}
        try:
            eng.start()
            res["across"]["start"] = None
        except ValueError as err:
            res["across"]["start"] = str(err)
        # a request submitted on the first consumer alone: the ranks'
        # streams diverged, and both fail the tick instead of hanging
        lone = eng.submit(fields[0]) \
            if dist.get_rank() == ctl.consumer_mesh.first_rank else None
        try:
            eng.step(force=True)
            res["across"]["diverged"] = None
        except RuntimeError as err:
            res["across"]["diverged"] = str(err)
        res["across"]["lone"] = None if lone is None else \
            type(lone.exception(5)).__name__
    eng.stop()
    rep = ctl.report()
    res["state"], res["n_events"] = rep["state"], len(rep["events"])
    res["generation"] = rep["generation"]

    # the async chaos: a contained consumer death, then a rescale that
    # retires the old hop
    pm2, ctl2 = make_elastic_setup(2, lease=1e9, device="cpu")
    afield = inputs["elastic_async_field"]
    spec = ("data", None)

    def payload(step):
        x = D.shard(afield + step, pm2, spec) if ctl2.is_producer() \
            else torch.empty(afield.shape, device="meta")
        return BridgeData(arrays={"f": x}, step=step, spec=spec)

    kill = FaultSchedule([InjectedFault(mode=KILL_AT_STEP,
                                        step=ELASTIC_ASYNC_KILL, rank=0)])
    delivered = []

    def consume(data):
        kill.check_kill(data.step, 0)
        delivered.append(data.step)
    err = None
    try:
        for i in range(4):
            ctl2.send_async(payload(i), on_result=consume, depth=2)
        ctl2.drain_async(raise_error=False)
        ctl2.send_async(payload(9))
    except PipelineError as e:
        err = {"step": e.step, "endpoint": e.endpoint,
               "cause": type(e.cause).__name__}
    hop = ctl2.bridge.report()["async"]
    old = ctl2.bridge
    ev3 = ctl2.rescale(n=1, reason="operator shrink")
    got = []
    for i in range(3):
        ctl2.send_async(payload(i), on_result=got.append, depth=2)
    ctl2.drain_async()
    res["async"] = {
        "delivered_before_kill": delivered, "contained": err,
        "dropped": hop["dropped"], "rescaled_to": ev3["to_devices"],
        "old_hop_closed": old._async._closed,
        "new_bridge": ctl2.bridge is not old,
        "post_rescale_delivered": [g.step for g in got],
        "post_rescale_bit_identical": all(
            np.array_equal(g.arrays["f"].numpy(), afield + g.step)
            for g in got) if ctl2.is_consumer() else None,
        "new_async_clean": ctl2.bridge.report()["async"]["error"] is None}

    # reshard: (4,) rows -> the two-rank consumer mesh's columns -> back
    # to the producers' rows, and one mesh to another spec
    rf = inputs["reshard_field"]
    m4 = make_mesh((4,), ("data",), device="cpu")
    cm = make_consumer_mesh(2, 2, device="cpu")
    x = D.shard(rf, m4, ("data", None))
    cols = D.reshard(x, m4, ("data", None), cm, (None, "data"))
    back = D.reshard(cols if cm.is_member
                     else torch.empty(rf.shape, device="meta"),
                     cm, (None, "data"), pm2, ("data", None))
    same = D.reshard(x, m4, ("data", None), m4, (None, "data"))
    res["reshard"] = {
        "to_consumers": None if cols is None else cols.numpy(),
        "to_producers": None if back is None else back.numpy(),
        "same_mesh": same.numpy(),
        "global": (D.unshard(cols, cm, (None, "data")).numpy()
                   if cm.is_member else None)}
    every = [None] * WORLD
    dist.all_gather_object(every, res)
    out["elastic_ranks"] = np.array(every, dtype=object)


def job_solver(inputs, out, workdir):
    """The spectral solvers on every decomposition of SOLVER_CASES:
    every rank steps its blocks and gathers the fields and the basis
    tables (each rank's block broadcast to its block of the spectral
    grid, gathered under the forward plan's output spec)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.solver import Boussinesq3DSolver, NS2DSolver
    meshes = _meshes()
    for case in SOLVER_CASES:
        solver, decomp, mkey, real = case
        cid = solver_id(solver, decomp, real)
        s = solver_case(NS2DSolver, Boussinesq3DSolver, case, meshes[mkey])
        got = solver_fields(s, solver)
        got["energy"] = np.array(s.energy())
        b = s.basis
        block = tuple(s.state[0].shape if solver == "ns2d"
                      else s.state["u0"][0].shape)
        tables = {f"k{ax}": k for ax, k in enumerate(b.k)}
        tables.update({name: getattr(b, name) for name in SOLVER_TABLES})
        for name, t in tables.items():
            full = torch.broadcast_to(t, block).contiguous()
            got["table_" + name] = b.fwd.unplace(full).numpy()
        if dist.get_rank() == 0:
            for k, v in got.items():
                out[f"solver_{cid}_{k}"] = v


# ---------------------------------------------------------------------------
# the LM substrate across ranks: reduced qwen3-4b on three (data, model)
# meshes, MoE dispatch groups, checkpoints, the entry points
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-4b"
LM_MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
LM_B, LM_S, LM_DECODE = 4, 16, 8
LM_CACHE = LM_S + LM_DECODE
LM_CHUNK = 8
LM_LR, LM_CLIP = 1e-3, 0.05            # the clip binds on every step
LM_STEPS = {"2x2": 3, "1x4": 1, "4x1": 1}
LM_MICRO = {"2x2": 2, "1x4": 1, "4x1": 1}
LM_MONITOR_EVERY = 2
# MoE: a group of 512 tokens routes ~256 picks to each of 4 experts,
# twice the 128 slots a capacity factor of 0.25 leaves, so G = 2 and
# G = 1 drop different tokens
MOE_ARCHS = ("grok-1-314b", "dbrx-132b")
MOE_B, MOE_S, MOE_CF = 4, 256, 0.25
# the other dense decoders on (2, 2): gemma2 (tied embeddings, softcaps,
# post norms, sliding windows, KV heads over the model axis),
# h2o-danube (sliding windows over a rolling cache whose slots shard over
# the model axis) and qwen2.5 (qkv biases, 4 heads padded to 48): prefill
# past the window, greedy decode that wraps the rolling cache; gemma2's
# loss and gradients (the tied embedding takes both uses' gradients)
DENSE_ARCHS = ("gemma2-27b", "h2o-danube-1.8b", "qwen2.5-14b")
DENSE_S, DENSE_DECODE = 48, 4
LM_SERVE = ["--reduced", "--device", "cpu", "--bench-out", "", "--batch",
            "4", "--prompt-len", "16", "--tokens", "4", "--seed", "3"]
LM_TRAIN = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4",
            "--seq", "16", "--ckpt-every", "2", "--insitu-every", "2",
            "--seed", "5"]


def lm_batch(vocab, step, batch=LM_B, seq=LM_S):
    from repro_torch.data import synthetic
    return synthetic.batch_at(step, global_batch=batch, seq_len=seq,
                              vocab=vocab, seed=0)


def moe_config(registry, arch):
    import dataclasses
    cfg = registry.get_reduced(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CF))


def flatten(tree, prefix):
    """Nested dicts of arrays -> {prefix + "a/b": array}."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flatten(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def lm_state(params):
    """The reference's fresh train state over ``params`` (numpy)."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return np.zeros_like(tree)
    return {"params": params, "opt": {"m": zeros(params), "v": zeros(params),
                                      "count": np.int32(0)},
            "step": np.int32(0)}


def job_lm(inputs, out, workdir):
    import torch
    import torch.distributed as dist
    from repro_torch.compat import make_mesh
    from repro_torch.configs import registry
    from repro_torch.core.insitu.chain import InSituChain
    from repro_torch.core.insitu.endpoints.spectral_monitor import (
        SpectralMonitorEndpoint)
    from repro_torch.data.pipeline import ShardedLoader, place_rows
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.models.convert import (params_from_jax,
                                            train_state_from_jax)
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.sharding.policy import make_policy, spec_leaves
    from repro_torch.train import step as tstep
    from repro_torch.tree_util import tree_leaves

    rank = dist.get_rank()
    cfg = registry.get_reduced(LM_ARCH)
    tree = unflatten(inputs, "params/")
    prompts = inputs["prompts"]
    shapes = tstep.train_state_shapes(
        cfg, AdamW(warmup_cosine(LM_LR, 1, 10)))

    def whole_leaves(pol, params):
        return [pol.gather(t, s).numpy() for t, s in
                zip(tree_leaves(params),
                    spec_leaves(pol.tree_specs(shapes["params"])))]

    for mkey, shape in LM_MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        pol = make_policy(mesh, global_batch=LM_B)
        params = params_from_jax(cfg, tree, device="cpu", policy=pol)

        def rows(a):
            return place_rows({"x": a}, pol)["x"]

        def whole(logits):
            return pol.gather(logits, pol.act_logits(cfg.vocab_size)).numpy()

        with torch.no_grad():
            logits, state = lm.prefill(cfg, params, {"tokens": rows(prompts)},
                                       pol, cache_len=LM_CACHE)
            out[f"{mkey}_prefill"] = whole(logits)
            if mkey == "2x2":
                steps, toks = [], []
                tok = out[f"{mkey}_prefill"][:, -1].argmax(-1)[:, None]
                for _ in range(LM_DECODE):
                    toks.append(tok)
                    logits, state = lm.decode_step(
                        cfg, params, rows(tok.astype(np.int32)), state, pol)
                    steps.append(whole(logits))
                    tok = steps[-1][:, -1].argmax(-1)[:, None]
                out["2x2_decode"] = np.stack(steps)
                out["2x2_tokens"] = np.concatenate(toks, axis=1)
                st = lm.init_decode_state(cfg, LM_B, LM_CACHE,
                                          torch.float32, pol,
                                          cache_impl="int8", device="cpu")
                steps = []
                for t in range(LM_DECODE):
                    logits, st = lm.decode_step(
                        cfg, params, rows(prompts[:, t:t + 1]), st, pol)
                    steps.append(whole(logits))
                out["2x2_int8"] = np.stack(steps)

        if mkey == "2x2":
            leaves = tree_leaves(params)
            for t in leaves:
                t.requires_grad_(True)
            batch = place_rows(lm_batch(cfg.vocab_size, 0), pol)
            loss, _ = lm.loss_fn(cfg, params, batch, pol,
                                 loss_chunk=LM_CHUNK)
            grads = torch.autograd.grad(loss, leaves)
            out["2x2_loss"] = np.asarray(float(loss.detach()))
            specs = spec_leaves(pol.tree_specs(shapes["params"]))
            for i, (g, s) in enumerate(zip(grads, specs)):
                out[f"2x2_grad_{i:03d}"] = pol.gather(g, s).numpy()
            for t in leaves:
                t.requires_grad_(False)

        opt = AdamW(warmup_cosine(LM_LR, 1, 10), grad_clip=LM_CLIP)
        hook = None
        if mkey == "2x2":
            hook = InSituChain([SpectralMonitorEndpoint(
                source="grads", nbins=8, max_tensors=4)],
                mesh=mesh).initialize().as_step_hook()
        step_fn = tstep.make_train_step(
            cfg, pol, opt, microbatches=LM_MICRO[mkey], loss_chunk=LM_CHUNK,
            compute_dtype=torch.float32, insitu_chain=hook,
            insitu_every=LM_MONITOR_EVERY)
        tstate = train_state_from_jax(cfg, lm_state(tree), device="cpu",
                                      policy=pol)
        for step in range(LM_STEPS[mkey]):
            tstate, m = step_fn(tstate, place_rows(
                lm_batch(cfg.vocab_size, step), pol))
            out[f"{mkey}_train_loss_{step}"] = np.asarray(float(m["loss"]))
            out[f"{mkey}_train_gnorm_{step}"] = np.asarray(
                float(m["grad_norm"]))
            if hook is not None:
                out[f"{mkey}_train_spectra_{step}"] = \
                    m["insitu"]["insitu_grad_spectra"].numpy()
        for i, w in enumerate(whole_leaves(pol, tstate["params"])):
            out[f"{mkey}_train_param_{i:03d}"] = w

        loader = ShardedLoader(lambda s: lm_batch(cfg.vocab_size, s), pol)
        try:
            _, b = next(loader)
        finally:
            loader.close()
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, {k: v.numpy() for k, v in b.items()})
        for r, blk in enumerate(got):
            for k, v in blk.items():
                out[f"{mkey}_loader_{k}_{r}"] = v

        if mkey == "2x2":
            _lm_checkpoints(out, workdir, cfg, tree, pol, mesh,
                            whole_leaves)
            _lm_moe(inputs, out, registry, mesh)
            _lm_dense(inputs, out, registry, mesh)

    # the entry points on the world's (2, 2) mesh
    flags = ["--num-processes", str(dist.get_world_size()), "--process-id",
             str(rank), "--coordinator", "localhost:1"]
    rep = serve.main(LM_SERVE + flags)
    out["serve_sample"] = np.asarray(rep["sample"])
    out["serve_mesh"] = np.asarray(sorted(rep["mesh"].items()), dtype=object)
    summ = train.main(LM_TRAIN + flags + [
        "--ckpt-dir", str(workdir / "train_ckpt"), "--fail-at", "3"])
    out["train_final_loss"] = np.asarray(summ["final_loss"])
    out["train_restarts"] = np.asarray(summ["restarts"])


def _lm_checkpoints(out, workdir, cfg, tree, pol, mesh, whole_leaves):
    """A (2, 2) save of the fresh state, a restore of it and of the
    reference's own checkpoint onto (2, 2)."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models.convert import train_state_from_jax
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train import step as tstep
    state = train_state_from_jax(cfg, lm_state(tree), device="cpu",
                                 policy=pol)
    full = tstep.train_state_shapes(cfg, AdamW(warmup_cosine(LM_LR, 1, 10)))
    ckpt.save(workdir / "ckpt22", 0, state,
              gather=tstep.state_gathers(pol, full), mesh=mesh)
    back = ckpt.restore(workdir / "ckpt22", 0, full,
                        place=tstep.state_shardings(pol, full))
    for i, w in enumerate(whole_leaves(pol, back["params"])):
        out[f"ckpt_restored_{i:03d}"] = w
    jtree = ckpt.restore(workdir / "jax_ckpt", 0, lm_state(tree))
    jstate = train_state_from_jax(cfg, jtree, device="cpu", policy=pol)
    for i, w in enumerate(whole_leaves(pol, jstate["params"])):
        out[f"ckpt_jax_{i:03d}"] = w


def _lm_moe(inputs, out, registry, mesh):
    """moe_mlp and its gradient on (2, 2) for the TP and EP experts."""
    import torch
    from repro_torch.data.pipeline import place_rows
    from repro_torch.models import moe
    from repro_torch.sharding.policy import make_policy, period_specs
    from repro_torch.tree_util import tree_leaves
    for arch in MOE_ARCHS:
        cfg = moe_config(registry, arch)
        pol = make_policy(mesh, global_batch=MOE_B,
                          ep_mode=cfg.moe.mode == "ep")
        whole_p = unflatten(inputs, f"moe_{arch}/")
        local = pol.shard_tree({"l0": {"moe": whole_p}}, ("blocks", 0))
        spec = period_specs(pol, cfg)["l0"]["moe"]
        leaves = tree_leaves(local)
        for t in leaves:
            t.requires_grad_(True)
        x = place_rows({"x": inputs[f"moe_{arch}_x"]}, pol)["x"]
        w = place_rows({"w": inputs[f"moe_{arch}_w"]}, pol)["w"]
        y, aux = moe.moe_mlp(cfg, pol.use_tree(local["l0"]["moe"], spec),
                             x, pol)
        loss = pol.reduce_batch((y * w).sum()) + aux
        grads = torch.autograd.grad(loss, leaves)
        out[f"moe_{arch}_y"] = pol.gather(
            y.detach(), pol.act_hidden()).numpy()
        out[f"moe_{arch}_aux"] = np.asarray(float(aux))
        names = sorted(whole_p)
        for name, g in zip(names, grads):
            out[f"moe_{arch}_grad_{name}"] = pol.gather(g, spec[name]).numpy()


def _lm_dense(inputs, out, registry, mesh):
    """DENSE_ARCHS on (2, 2): prefill and greedy decode (every arch),
    loss and every gradient leaf (gemma2)."""
    import torch
    from repro_torch.data.pipeline import place_rows
    from repro_torch.models import lm
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.sharding.policy import make_policy, spec_leaves
    from repro_torch.train import step as tstep
    from repro_torch.tree_util import tree_leaves
    for arch in DENSE_ARCHS:
        cfg = registry.get_reduced(arch)
        pol = make_policy(mesh, global_batch=LM_B)
        params = params_from_jax(cfg, unflatten(inputs, f"dense_{arch}/"),
                                 device="cpu", policy=pol)
        prompts = inputs[f"dense_{arch}_prompts"]

        def rows(a):
            return place_rows({"x": a}, pol)["x"]

        def whole(logits):
            return pol.gather(logits, pol.act_logits(cfg.vocab_size)).numpy()
        with torch.no_grad():
            logits, state = lm.prefill(cfg, params, {"tokens": rows(prompts)},
                                       pol, cache_len=DENSE_S + DENSE_DECODE)
            steps = [whole(logits)]
            for _ in range(DENSE_DECODE):
                tok = steps[-1][:, -1].argmax(-1)[:, None].astype(np.int32)
                logits, state = lm.decode_step(cfg, params, rows(tok), state,
                                               pol)
                steps.append(whole(logits))
        out[f"dense_{arch}_logits"] = np.stack(steps)
        if arch != "gemma2-27b":
            continue
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        batch = place_rows(lm_batch(cfg.vocab_size, 0), pol)
        loss, _ = lm.loss_fn(cfg, params, batch, pol, loss_chunk=LM_CHUNK)
        grads = torch.autograd.grad(loss, leaves)
        out[f"dense_{arch}_loss"] = np.asarray(float(loss.detach()))
        specs = spec_leaves(pol.tree_specs(tstep.train_state_shapes(
            cfg, AdamW(warmup_cosine(LM_LR, 1, 10)))["params"]))
        for i, (g, sp) in enumerate(zip(grads, specs)):
            out[f"dense_{arch}_grad_{i:03d}"] = pol.gather(g, sp).numpy()


def job_lm_transit(inputs, out, workdir):
    """``serve`` and ``train`` with ``--transit-consumers 1`` on three
    ranks: a (2, 1) decode / training mesh and one consumer."""
    import torch.distributed as dist
    from repro_torch.launch import serve, train
    rank = dist.get_rank()
    flags = ["--num-processes", "3", "--process-id", str(rank),
             "--coordinator", "localhost:1", "--transit-consumers", "1"]
    rep = serve.main(LM_SERVE + flags + [
        "--monitor-every", "2", "--monitor-batch", "2", "--monitor-dir",
        str(workdir / f"monitor{rank}")])
    summ = train.main(LM_TRAIN + flags + [
        "--ckpt-dir", str(workdir / "ckpt"),
        "--insitu-spectra-dir", str(workdir / f"spectra{rank}")])
    got = [None] * 3
    dist.all_gather_object(got, (rep.get("sample"), rep.get("monitor", {})
                                 .get("files"), summ.get("final_loss"),
                                 summ.get("spectra_files")))
    for r, (sample, files, loss, spectra) in enumerate(got):
        out[f"rank{r}"] = np.asarray([sample, files, loss, spectra],
                                     dtype=object)



def main():
    job, rank, world, workdir = sys.argv[1:5]
    rank, world, workdir = int(rank), int(world), Path(workdir)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    with np.load(workdir / "inputs.npz", allow_pickle=True) as f:
        inputs = dict(f)
    out = {}
    try:
        {"distributed": job_distributed, "schedule": job_schedule,
         "rfft": job_rfft, "wire": job_wire,
         "transit": job_transit, "elastic": job_elastic,
         "solver": job_solver, "lm": job_lm,
         "lm_transit": job_lm_transit}[job](inputs, out, workdir)
        dist.barrier()
        if rank == 0:
            tmp = workdir / "outputs.tmp.npz"
            np.savez(tmp, **out)
            os.replace(tmp, workdir / "outputs.npz")
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    # every rank is past the last collective: leave without running the
    # process groups' destructors, whose gloo threads can abort the
    # process at interpreter exit (SIGABRT) after the work is done
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
