#!/usr/bin/env python3
"""Peak device memory of the Fig. 2 chain's step on one CUDA card.

For each ``--root`` (a checkout whose ``src/`` is imported; this one by
default), in the order given, a fresh process builds the chain
(forward FFT → bandpass → backward FFT, ``backend: "pallas"``, one-device
mesh) at ``--dims``, runs one warm-up step, then two measured steps,
and prints one JSON line: the bytes allocated before the first
measured step, ``torch.cuda.max_memory_allocated()`` over each step, and
the bytes still allocated after. Give a parent checkout (a ``git
archive`` unpacked under ``build/``) and this one in turns, e.g.

    python3 tools/chain_peak.py --root build/parent --root . --root . \\
        --root build/parent
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STEP = r'''
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.compat import make_mesh
from repro_torch.core.insitu.adaptors import RadiatingSourceAdaptor
from repro_torch.core.insitu.config import build_chain
dims = tuple(int(d) for d in sys.argv[2].split("x"))
mesh = make_mesh((1,), ("data",))
data = RadiatingSourceAdaptor(dims, mesh=mesh).produce(0)


def chain():
    return build_chain({"mode": "insitu", "chain": [
        {"endpoint": "fft", "direction": "forward", "backend": "pallas"},
        {"endpoint": "bandpass", "keep_frac": 0.05},
        {"endpoint": "fft", "direction": "backward", "backend": "pallas"},
    ]}, mesh=mesh, grid=data.grid)


chain().execute(data)
c = chain()
torch.cuda.synchronize()
res = {"root": sys.argv[1], "dims": list(dims),
       "device": torch.cuda.get_device_name(0),
       "allocated_before": torch.cuda.memory_allocated()}
for step in ("first", "second"):
    torch.cuda.reset_peak_memory_stats()
    c.execute(data)
    torch.cuda.synchronize()
    res["peak_" + step] = torch.cuda.max_memory_allocated()
res["allocated_after"] = torch.cuda.memory_allocated()
print(json.dumps(res))
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--dims", default="8192x8192")
    args = ap.parse_args()
    for root in args.root or [str(ROOT)]:
        res = subprocess.run([sys.executable, "-c", STEP,
                              str(Path(root).resolve()), args.dims],
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
