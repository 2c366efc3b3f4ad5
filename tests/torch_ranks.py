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


def case_id(decomp, direction, batched):
    return f"{decomp}-{direction}-{'batched' if batched else 'single'}"


def wire_id(wire, split, concat):
    return f"{wire}_{split}_{concat}"


def a2a_input(rank):
    """Rank ``rank``'s block for the exchange checks."""
    return (np.arange(np.prod(A2A_LOCAL), dtype=np.float32)
            .reshape(A2A_LOCAL) + 1e4 * rank)


def run_ranks(job, workdir, inputs):
    workdir = Path(workdir)
    np.savez(workdir / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r),
                               str(WORLD), str(workdir)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
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
    assert codes == [0] * WORLD, "\n".join(
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
         "rfft": job_rfft, "wire": job_wire}[job](inputs, out, workdir)
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
