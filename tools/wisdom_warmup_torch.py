"""Wisdom warm-up / warm-start assertion CLI on the PyTorch port
(counterpart of ``tools/wisdom_warmup.py``; docs/wisdom.md).

Plans the canonical measured signatures — the sweep-heavy bring-up of
the reference's ``fft_wisdom_*`` bench and CI — against a persistent
wisdom file, then prints one JSON stats line. Two jobs:

* **Warm-up** (populate): on a cold file, the measured sweeps run and
  their winners are persisted, so the NEXT process boots warm.
* **Assertion** (``--require-hits``): exit 1 unless this run planned
  from wisdom (``wisdom_hits > 0``); with ``--require-zero-timed`` also
  unless not a single sweep candidate was timed. A restored but useless
  file (stale version, another topology) fails loudly instead of
  silently re-measuring forever.

A process is one rank here, so the reference's ``--devices`` has no
counterpart: the tool plans on the world's mesh from the ``REPRO_*``
env contract, ``(world/2, 2)`` over a world of several ranks (the
reference's ``(devices/2, 2)``) and ``(1, 1)`` alone, and runs under
``tools/launch_multihost_torch.py`` too. The wisdom key holds the
world's size. It runs on the CUDA card unless ``--device cpu`` is given;
without a card it exits 2 with an error that names that flag.

Usage:
  python tools/wisdom_warmup_torch.py --file .ci_wisdom/wisdom.json
  python tools/wisdom_warmup_torch.py --file .ci_wisdom/wisdom.json \\
         --require-hits --require-zero-timed
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--file", required=True, metavar="PATH",
                    help="wisdom file to read/populate")
    ap.add_argument("--mode", default="readwrite",
                    choices=("read", "readwrite"))
    ap.add_argument("--require-hits", action="store_true",
                    help="fail unless wisdom_hits > 0 (the CI "
                         "warm-start assertion)")
    ap.add_argument("--require-zero-timed", action="store_true",
                    help="fail if ANY sweep candidate was timed")
    ap.add_argument("--device", default="cuda",
                    help="torch device to plan on (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to plan on the CPU")

    from repro_torch.core.fft.plan import (FORWARD, plan_cache_stats, plan_dft,
                                           plan_rfft, set_wisdom)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.cluster import init_cluster

    init_cluster(device=args.device)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    store = set_wisdom(args.file, args.mode)
    mesh = make_host_mesh((max(1, world // 2), 2), device=args.device)

    # the canonical measured signatures (one decomp+knob double sweep,
    # one r2c knob sweep), brought all the way up to "ready to serve" —
    # first executes included
    t0 = time.perf_counter()
    p3 = plan_dft((24, 24, 24), FORWARD, mesh, decomp="measure",
                  backend="measure")
    pr = plan_rfft((48, 64), FORWARD, mesh, decomp="slab",
                   axis_names=("data",), backend="measure")
    p3.execute_complex(np.zeros((24, 24, 24), np.complex64))
    pr.execute(*pr.place(np.zeros((48, 64), np.float32)))
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    s = plan_cache_stats()
    out = {"wall_s": round(wall, 3), "wisdom_file": args.file,
           "wisdom_hits": s["wisdom_hits"],
           "wisdom_misses": s["wisdom_misses"],
           "wisdom_stale": s["wisdom_stale"],
           "sweep_candidates_timed": s["sweep_candidates_timed"],
           "store": store.stats() if store else None}
    if not torch.distributed.is_initialized() \
            or torch.distributed.get_rank() == 0:
        print(json.dumps(out, indent=2, sort_keys=True))

    if args.require_hits and s["wisdom_hits"] == 0:
        print("FAIL: --require-hits but this run planned nothing from "
              "wisdom (cold or stale file?)", file=sys.stderr)
        return 1
    if args.require_zero_timed and s["sweep_candidates_timed"] > 0:
        print(f"FAIL: --require-zero-timed but "
              f"{s['sweep_candidates_timed']} sweep candidate(s) were "
              f"timed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
