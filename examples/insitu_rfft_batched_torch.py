"""Batched real-input in-situ chain on the PyTorch port — many fields per
step, one plan (counterpart of ``examples/insitu_rfft_batched.py``).

A simulation rarely publishes one field: velocity components, pressure,
tracers all need the same spectral processing every step. This example
runs the paper's fwd → bandpass → inv chain over a STACK of real fields
with a single cached, batched r2c/c2r plan pair:

  * ``real=True``      — Hermitian half-spectrum (r2c forward, c2r
                          back): half the FFT work and wire bytes
  * ``batch_ndim=1``   — the leading dim is a batch of fields sharing
                          one plan
  * plan cache         — both endpoints and every later step reuse the
                          process-wide plans (FFTW-style: plan once,
                          execute forever)

The mesh is the world's: ``(1,)`` in one process, ``(P,)`` over the P
ranks of a cluster (``tools/launch_multihost_torch.py --nprocs P --
python examples/insitu_rfft_batched_torch.py``). It runs on the CUDA card
unless ``--device cpu`` is given; without a card it stops with an error
that names that flag.

Run:  PYTHONPATH=src python examples/insitu_rfft_batched_torch.py
          [--batch 4] [--n 128] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.compat import make_mesh
from repro_torch.core.fft import distributed as D
from repro_torch.core.fft.plan import plan_cache_stats
from repro_torch.core.insitu.bridge import BridgeData, GridMeta
from repro_torch.core.insitu.config import build_chain
from repro_torch.runtime.cluster import init_cluster

KEEP_FRAC = 0.08


def make_fields(batch: int, n: int, seed: int = 0):
    """(clean, noisy) float32 numpy stacks of ``batch`` fields of n x n:
    field b is sin(2πk(x + 2y)/n)/k with k = b + 2, plus noise of std 0.5
    from ``seed`` (the reference's fields at its 4 x 128²)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    clean = np.stack([np.sin(2 * np.pi * k * (xx + 2 * yy) / n) / k
                      for k in range(2, 2 + batch)]).astype(np.float32)
    fields = clean + 0.5 * rng.standard_normal(
        (batch, n, n)).astype(np.float32)
    return clean, fields


def chain_config(keep_frac: float = KEEP_FRAC) -> dict:
    return {"mode": "insitu", "chain": [
        {"endpoint": "fft", "array": "field", "direction": "forward",
         "real": True, "batch_ndim": 1},
        {"endpoint": "bandpass", "array": "field", "keep_frac": keep_frac,
         "use_kernel": False},
        {"endpoint": "fft", "array": "field", "direction": "backward",
         "real": True, "batch_ndim": 1}]}


def denoise(fields, mesh, keep_frac: float = KEEP_FRAC):
    """One step of the batched chain on ``fields`` (the global (B, N0, N1)
    stack, numpy or torch): each rank takes its block under the forward
    plan's input spec. Returns (the denoised global stack, gathered on
    every rank, and the chain)."""
    grid = GridMeta(tuple(fields.shape[1:]))
    chain = build_chain(chain_config(keep_frac), mesh=mesh, grid=grid)
    spec = chain.endpoints[0].plan.schedule().in_spec
    data = BridgeData(arrays={"field": D.shard(fields, mesh, spec)},
                      grid=grid, spec=spec)
    out = chain.execute(data)
    return D.unshard(out.arrays["field"], mesh, out.spec), chain


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4,
                    help="fields a step (default 4)")
    ap.add_argument("--n", type=int, default=128,
                    help="grid side (default 128)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the "
                           "batched chain on the CPU")
    init_cluster(device=args.device)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    mesh = make_mesh((world,), ("data",), device=args.device)
    rank0 = mesh.coordinate["data"] == 0

    clean, fields = make_fields(args.batch, args.n)
    den, chain = denoise(fields, mesh)
    den = den.cpu().numpy()
    mse0 = [float(np.mean((fields[b] - clean[b]) ** 2))
            for b in range(args.batch)]
    mse1 = [float(np.mean((den[b] - clean[b]) ** 2))
            for b in range(args.batch)]
    stats = plan_cache_stats()
    if rank0:
        for b in range(args.batch):
            print(f"field {b}: MSE {mse0[b]:.4f} -> {mse1[b]:.4f} "
                  f"({mse0[b] / mse1[b]:.1f}x better)")
        print("plan cache:", stats)
        print("timings:", chain.marshaling_report()["timings_s"])
    assert all(a < b for a, b in zip(mse1, mse0))
    if rank0:
        print("OK")
    return {"mesh": dict(mesh.shape), "mse0": mse0, "mse1": mse1,
            "denoised": den, "plan_cache": stats}


if __name__ == "__main__":
    main()
