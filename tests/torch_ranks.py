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
# every (split, concat) pair of the builders' exchanges
A2A_PAIRS = ((-1, -2), (-2, -1), (-2, -3), (-3, -2), (-3, -4), (-4, -3))
A2A_LOCAL = (4, 8, 4, 8)


def case_id(decomp, direction, batched):
    return f"{decomp}-{direction}-{'batched' if batched else 'single'}"


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
        {"distributed": job_distributed, "schedule": job_schedule}[job](
            inputs, out, workdir)
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
