#!/usr/bin/env python3
"""Time the four-step FFT kernel's routes on one CUDA card.

For each shape: the route's device time per call (torch.profiler, the
sum of its kernels' device time), ``torch.fft``'s device time on the
same input, the byte bound (two planes in, two out, at 3.35 TB/s), and
the route's largest error against a float64 ``torch.fft`` oracle,
relative to max |X|, forward and inverse. Rows are (B, N); columns are
(outer, N, inner) along the middle axis.

    python3 tools/fft_routes.py [--root DIR] [--out FILE]

``--root`` names a checkout whose ``src/`` is imported (by default this
one), so a parent commit unpacked beside the tree runs the same
measurement. Prints one JSON line per shape and writes them all to
``--out`` as one JSON list.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

# chip_smoke puts this tree's src/ on the path; main() puts --root's first
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import device_profile  # noqa: E402

PEAK_HBM_BYTES = 3.35e12
ROWS = ((64, 200), (64, 360), (64, 257), (200, 200), (10000, 10000),
        (64, 20000), (64, 32768), (8, 65536), (4, 1 << 20), (8, 10007),
        (16, 4097))
COLUMNS = ((1, 200, 200), (1, 10000, 10000))


def device_ms(fn, iters=10):
    """Device time of one call of ``fn``: its kernels' device time under
    torch.profiler over ``iters`` calls, per call, as chip_smoke.py takes
    it (a spin kernel first, so that the trace drops none of them)."""
    for _ in range(2):
        fn()

    def run():
        for _ in range(iters):
            fn()
    _, rows = device_profile(run)
    return sum(r[1] for r in rows) / iters


def measure(shape, columns, gen):
    import torch
    from repro_torch.kernels import fft_fourstep as fs
    re = torch.randn(shape, generator=gen, device="cuda")
    im = torch.randn(shape, generator=gen, device="cuda")
    dim = 1 if columns else -1
    wrapper = fs.fft_fourstep_columns if columns else fs.fft_fourstep
    z64 = torch.complex(re.double(), im.double())
    err = {}
    for inverse in (False, True):
        want = (torch.fft.ifft if inverse else torch.fft.fft)(z64, dim=dim)
        before = fs.fft_fourstep.launches
        got = wrapper(re, im, inverse=inverse)
        launches = fs.fft_fourstep.launches - before
        scale = float(want.abs().max())
        err["inverse" if inverse else "forward"] = max(
            float((got[0].double() - want.real).abs().max()),
            float((got[1].double() - want.imag).abs().max())) / scale
        del want, got
    z = torch.complex(re, im)
    n = re.numel()
    return {"shape": list(shape), "route": "columns" if columns else "rows",
            "launches": launches, "device_ms": device_ms(
                lambda: wrapper(re, im)),
            "torch_fft_device_ms": device_ms(
                lambda: torch.fft.fft(z, dim=dim)),
            "bound_ms": 16.0 * n / PEAK_HBM_BYTES * 1e3,
            "rel_err_vs_f64": err}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root) / "src"))
    import torch
    if not torch.cuda.is_available():
        print("fft_routes: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for shapes, columns in ((ROWS, False), (COLUMNS, True)):
        for shape in shapes:
            res = measure(shape, columns, gen)
            res["root"], res["card"] = args.root, smi
            print(json.dumps(res), flush=True)
            out.append(res)
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
