"""Dry run + roofline for the paper's own workload: the distributed FFT
on the production mesh (counterpart of ``repro/launch/fft_dryrun.py``).

Cells (all single-pod 16×16 unless run with ``--mesh pod2``):

  slab2d-16384           — paper-faithful slab (1-D) decomposition: only
                           the 16-way data axis participates (the
                           scalability ceiling the paper names in §5)
  pencil2d-16384         — 2-axis decomposition of the same 2-D grid:
                           all 256 ranks tile it (three small exchanges
                           instead of one 16-way exchange)
  pencil3d-1024          — pencil (2-D) decomposition over all 256 ranks
  pencil3d-1024-bf16     — + bf16 wire transport (beyond-paper)
  pencil3d-1024-dcnwire  — per-STAGE wire: bf16 on the second (a0)
                           rotation only — the hop that crosses hosts on
                           multi-host meshes
  slab2d-16384-overlap4  — + chunked compute/comm pipelining
  r2c3d-slab3d-1024      — real-input 3-D slab: half-spectrum planes,
                           one exchange, unpadded half axis
  fig2-chain-8192        — forward → bandpass → inverse fused chain (the
                           full paper workflow at scale)
  fig2-r2c-8192          — the same chain on the r2c half-spectrum

Each cell's step runs once on this rank's blocks under
``FakeTensorMode`` in a fake world of 256 (or 512) ranks
(``dryrun.production_mesh``), its local FFTs on ``backend="jnp"``
(``torch.fft``: the CUDA kernels take no fake tensor). No depth, so no
extrapolation. Per rank:

* flops — the classic 5·N·log2 N a length-N 1-D transform, over this
  rank's block (a pass over P points of lines of length N costs
  5·P·log2 N);
* bytes — each pass (each 1-D transform pass, and the chain's filter)
  reads and writes this rank's planes once: the byte bound of
  ``PERF.md`` §6;
* wire bytes — the exchanges' all-to-alls, from
  ``sharding/collectives.WIRE`` (``(n−1)/n`` of each all-to-all's bytes).

``build(kind, mesh)`` also serves the card: on a mesh of CUDA ranks,
with the default backend, the same step runs on the kernels.
"""
import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.core.fft import distributed as D
from repro_torch.core.fft.filters import lowpass_mask
from repro_torch.launch import roofline as rl

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_fft"

F32 = torch.float32


def _meta(shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def build(kind: str, mesh, backend: str = "auto"):
    """Returns (fn, args (global ``meta`` tensors), in_specs, model
    flops, HBM bytes), the last two over the whole grid; ``fn`` takes
    this rank's blocks of ``args`` under ``in_specs``."""
    if kind.startswith("slab2d"):
        n = int(kind.split("-")[1])
        shape = (n, n)
        spec = ("data", None)
        chunks = 4 if "overlap" in kind else 0
        if chunks:
            def fn(r, i):
                return D.slab_fft_2d_overlap(r, i, mesh, "data",
                                             backend=backend, chunks=chunks)
        else:
            def fn(r, i):
                return D.slab_fft_2d(r, i, mesh, "data", backend=backend)
        flops = 2 * 5 * n * n * math.log2(n)     # two 1-D passes
        passes, points = 2, n * n
    elif kind.startswith("pencil3d"):
        n = int(kind.split("-")[1])
        shape = (n, n, n)
        spec = ("data", "model", None)
        # per-stage wire ("dcnwire"): cast only the SECOND rotation (the
        # a0 exchange — the hop that crosses hosts on multi-host meshes)
        wire = ("bfloat16" if kind.endswith("bf16")
                else (None, "bfloat16") if kind.endswith("dcnwire")
                else None)

        def fn(r, i):
            return D.pencil_fft_3d(r, i, mesh, backend=backend,
                                   wire_dtype=wire)
        flops = 3 * 5 * n * n * n * math.log2(n)
        passes, points = 3, n ** 3
    elif kind.startswith("pencil2d"):
        n = int(kind.split("-")[1])
        shape = (n, n)
        spec = ("data", "model")

        def fn(r, i):
            return D.pencil2d_fft_2d(r, i, mesh, backend=backend)
        flops = 2 * 5 * n * n * math.log2(n)
        passes, points = 2, n * n
    elif kind.startswith("r2c3d-slab3d"):
        from repro_torch.core.fft import rfft as rfft_mod
        n = int(kind.split("-")[-1])
        shape = (n, n, n)

        def fn(x):
            return rfft_mod.rfft3_slab3d(x, mesh, "data", backend=backend)
        flops = 3 * 5 * n * n * n * math.log2(n) / 2   # half-spectrum
        # three passes over the half-spectrum planes
        nbytes = 3 * 2 * n * n * rfft_mod.half_bins(n) * 8
        return fn, (_meta(shape),), (("data", None, None),), flops, nbytes
    elif kind.startswith("fig2-r2c"):
        # real-input half-spectrum chain (FFTW r2c analogue)
        from repro_torch.core.fft import rfft as rfft_mod
        n = int(kind.split("-")[-1])
        shape = (n, n)
        mask = lowpass_mask(shape, 0.05)

        def fn(x):
            return rfft_mod.rfft_chain_2d(x, mask, mesh, "data",
                                          backend=backend)
        flops = 2 * 5 * n * n * math.log2(n)     # ~half of the c2c chain
        # four passes and the filter over the half-spectrum planes
        nbytes = 5 * 2 * n * rfft_mod.half_bins(n) * 8
        return fn, (_meta(shape),), (("data", None),), flops, nbytes
    elif kind.startswith("fig2-chain"):
        n = int(kind.split("-")[-1])
        shape = (n, n)
        spec = ("data", None)
        # the mask's block of the forward's output layout P(None, data)
        mask = D.shard(lowpass_mask(shape, 0.05).float(), mesh,
                       (None, "data"))

        def fn(r, i):
            fr, fi = D.slab_fft_2d(r, i, mesh, "data", backend=backend)
            fr, fi = fr * mask, fi * mask
            return D.slab_fft_2d(fr, fi, mesh, "data", inverse=True,
                                 backend=backend)
        flops = 4 * 5 * n * n * math.log2(n)
        passes, points = 5, n * n                 # four passes + filter
    else:
        raise ValueError(kind)
    nbytes = passes * 2 * points * 8              # complex64 planes
    return fn, (_meta(shape), _meta(shape)), (spec, spec), flops, nbytes


def _block_fraction(mesh, spec) -> float:
    """The share of a grid one rank's block under ``spec`` holds."""
    return 1.0 / math.prod(mesh.shape[a] for e in spec
                           for a in D._names(e))


def run_cell(kind: str, mesh_name: str = "pod1") -> dict:
    from repro_torch.launch.dryrun import production_mesh
    from repro_torch.launch.specs import local_shapes
    multi_pod = mesh_name == "pod2"
    chips = 512 if multi_pod else 256
    t0 = time.time()
    result = {"arch": f"fft:{kind}", "shape": "-", "mesh": mesh_name,
              "chips": chips, "status": "ok"}
    try:
        mesh = production_mesh(multi_pod)
        fn, args, in_specs, mf, nbytes = build(kind, mesh, backend="jnp")
        local = local_shapes(args, in_specs, mesh)
        costs = rl.trace_costs(fn, local, device=mesh.device)
        share = _block_fraction(mesh, in_specs[0])
        result["memory"] = rl.memory_report(costs)
        cell = rl.CellCost(flops=mf * share, bytes_hbm=nbytes * share,
                           coll_bytes=costs["coll"].get("total", 0.0),
                           coll_by_kind=costs["coll"],
                           compute_dtype=torch.float32)
        result["roofline"] = cell.to_dict()
        result["roofline"]["model_flops_per_chip"] = mf / chips
        result["roofline"]["useful_ratio"] = (
            mf / chips / cell.flops if cell.flops else 0.0)
        result["roofline"]["trips"] = 1
    except Exception as e:  # noqa: BLE001
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-3000:]
    result["compile_seconds"] = round(time.time() - t0, 1)
    return result


CELLS = ["slab2d-16384", "slab2d-16384-overlap4", "pencil2d-16384",
         "pencil3d-1024", "pencil3d-1024-bf16", "pencil3d-1024-dcnwire",
         "r2c3d-slab3d-1024", "fig2-chain-8192", "fig2-r2c-8192"]


def main():
    ap = argparse.ArgumentParser(
        description="Dry run + roofline for the distributed FFT on the "
                    "production mesh (see module docstring for what "
                    "each cell exercises).")
    ap.add_argument("--cell", default=None,
                    help="run ONE cell instead of the full grid; known: "
                         + ", ".join(CELLS))
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2"],
                    help="pod1 = 16x16 single pod (256 ranks), "
                         "pod2 = 2x16x16 (512 ranks)")
    args = ap.parse_args()
    RESULTS.mkdir(parents=True, exist_ok=True)
    cells = [args.cell] if args.cell else CELLS
    for kind in cells:
        r = run_cell(kind, args.mesh)
        name = f"fft_{kind}__{args.mesh}.json"
        (RESULTS / name).write_text(json.dumps(r, indent=2, default=str))
        rf = r.get("roofline", {})
        print(f"[{r['status']:5s}] fft:{kind:24s} {args.mesh} "
              f"t_comp={rf.get('t_compute_s', 0)*1e3:8.3f}ms "
              f"t_mem={rf.get('t_memory_s', 0)*1e3:8.3f}ms "
              f"t_coll={rf.get('t_collective_s', 0)*1e3:8.3f}ms "
              f"dom={rf.get('dominant', '-')}", flush=True)
        if r["status"] == "error":
            print("   ", r["error"][:200])


if __name__ == "__main__":
    main()
