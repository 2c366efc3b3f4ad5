#!/usr/bin/env python3
"""The FFT serving engine's trace with and without the cluster kernel.

Runs ``chip_smoke.py``'s phase 7b (``engine_trace``: 96 requests of
2048², 1000² and 128 x 4096, c2c and r2c FFTs and bandpass filters,
served one request an execute, then batched from four client threads,
every answer against float64) four times in one process: with the
column route as built (columns of 1000 points, and the r2c requests'
501-wide half columns, in one pass on ``mixed_cluster_kernel``), then
with ``fft_plan.COLUMN_CLUSTER_MIN`` past every N (the same columns as
two line passes through a scratch buffer, the design the cluster kernel
replaced), then again with and without. Prints one JSON line a run:
wall seconds, requests a second, the engine's latency report and the
cluster kernel's launches, sequential and batched.

Run from the repository root on a machine with a CUDA card:

    python3 tools/engine_cluster.py
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("engine_cluster: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import fft_plan
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    built = fft_plan.COLUMN_CLUSTER_MIN
    counters = chip_smoke.kernel_counters()
    for cluster in (True, False, True, False):
        fft_plan.COLUMN_CLUSTER_MIN = built if cluster else 1 << 62
        fft_plan.route.cache_clear()
        res = chip_smoke.engine_trace(counters)
        print(json.dumps({"cluster_route": cluster, **{
            mode: {k: res[mode][k] for k in (
                "wall_s", "throughput_rps", "latency_ms", "executes",
                "cluster_launches", "max_rel_err")}
            for mode in ("sequential", "batched")}}), flush=True)
    fft_plan.COLUMN_CLUSTER_MIN = built
    fft_plan.route.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
