#!/usr/bin/env python3
"""Time the real paths' two odd-width kernels of one source tree on one
CUDA card, to set two trees' designs side by side.

The half-spectrum planes of the real (r2c/c2r) paths have an odd width
(4097 at 8192², 5001 at 10000², 257 for Boussinesq 512³). Two kernels run
on them: the radix column route (``fft_fourstep_columns`` along axis -2,
two passes of ``fft_lines_kernel`` through a scratch buffer, also inside
Bluestein's power-of-two transforms) and the fused bandpass.

The process imports ``repro_torch`` from ``--src`` (this repository by
default), builds that tree's kernels from its own sources into its own
``build/``, and times every shape once. To compare a change with the
tree it replaced, unpack the other commit into a directory that
``.gitignore`` lists and run the two in turns in one call (other, this,
this, other), for example:

    git archive HEAD~1 | tar -x -C build/parent
    for src in build/parent . . build/parent; do
        python3 tools/odd_width_variants.py --src $src --out FILE
    done

For every column shape: device ms a call (torch.profiler, the sum of its
kernels) with each kernel's ms, busy ms of calls queued behind a spin
kernel (CUDA events), ``torch.fft``'s device ms, the byte bound of one
pass over the planes, and the largest error against a float64 oracle
(forward and inverse). For every bandpass shape: device ms (both
launches), busy ms, the byte bound (20 bytes a point), whether the planes
equal the plain version bit for bit, the sums' error against float64 and
whether a second run gives the same sums bit for bit.

Run from the repository root on a machine with a CUDA card:

    python3 tools/odd_width_variants.py [--src DIR] [--out FILE] [--reps N]
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (device_ms_by_kernel, ptxas_report,  # noqa: E402
                        queued_device_ms)

PEAK_HBM_BYTES = 3.35e12
# (outer, N, inner) along the middle axis: the real 8192² step's half
# width and the pitches around it (16-byte, 32-byte and 128-byte rows),
# the full width, the batched real example's, NS2D's; Boussinesq 512³'s
# columns at inner 257 (and 256), and along its first axis; Bluestein
# columns on the power-of-two transforms at M = 1024 and 16384 (the first
# one the script's (3, 257, 100))
COLUMNS = ((1, 8192, 4096), (1, 8192, 4097), (1, 8192, 4100),
           (1, 8192, 4104), (1, 8192, 4128), (1, 8192, 8192),
           (4, 8192, 4097), (4608, 512, 257), (4608, 512, 256),
           (9, 512, 131584), (3, 257, 100), (1, 4097, 1001))
# (R, C): the complex 8192² plane, the real chains' half-spectrum planes,
# a 32-byte pitch, and the logits monitor's plane
BANDPASS = ((8192, 8192), (8192, 4097), (8192, 4104), (10000, 5001),
            (4, 32000))


def columns(shape, gen, reps):
    import torch
    from repro_torch.kernels.fft_fourstep import fft_fourstep_columns
    re = torch.randn(shape, generator=gen, device="cuda")
    im = torch.randn(shape, generator=gen, device="cuda")
    z64 = torch.complex(re.double(), im.double())
    want = {inv: (torch.fft.ifft if inv else torch.fft.fft)(z64, dim=1)
            for inv in (False, True)}
    scale = {k: float(v.abs().max()) for k, v in want.items()}
    del z64
    out = {"shape": list(shape), "points": re.numel(),
           "bound_ms_one_pass": 16.0 * re.numel() / PEAK_HBM_BYTES * 1e3}
    err = 0.0
    for inv in (False, True):
        gr, gi = fft_fourstep_columns(re, im, inverse=inv)
        err = max(err, max(float((gr.double() - want[inv].real).abs().max()),
                           float((gi.double() - want[inv].imag).abs().max()))
                  / scale[inv])
        del gr, gi
    del want
    out["device_ms"], out["kernels"] = device_ms_by_kernel(
        lambda: fft_fourstep_columns(re, im), reps)
    out["busy_ms"] = queued_device_ms(lambda: fft_fourstep_columns(re, im),
                                      reps)
    out["rel_err_vs_f64"] = err
    torch.cuda.empty_cache()
    z = torch.complex(re, im)
    out["torch_fft_device_ms"], _ = device_ms_by_kernel(
        lambda: torch.fft.fft(z, dim=1), reps)
    return out


def bandpass(shape, gen, reps, offset=0):
    import torch
    from repro_torch.kernels.bandpass import bandpass_filter
    from repro_torch.kernels.ref import bandpass_ref
    n = shape[0] * shape[1]

    def plane(draw):
        flat = draw(n + offset)
        return flat[offset:].view(shape)
    re = plane(lambda k: torch.randn(k, generator=gen, device="cuda"))
    im = plane(lambda k: torch.randn(k, generator=gen, device="cuda"))
    mask = plane(lambda k: torch.rand(k, generator=gen, device="cuda"))
    pr, pi, _, _ = bandpass_ref(re, im, mask)
    p64 = re.double() ** 2 + im.double() ** 2
    kept64, tot64 = float((p64 * mask.double()).sum()), float(p64.sum())
    del p64
    out = {"shape": list(shape), "offset": offset,
           "bound_ms": 20.0 * n / PEAK_HBM_BYTES * 1e3}
    r, i, kept, tot = bandpass_filter(re, im, mask)
    again = bandpass_filter(re, im, mask)
    ms, by = device_ms_by_kernel(lambda: bandpass_filter(re, im, mask), reps)
    busy = queued_device_ms(lambda: bandpass_filter(re, im, mask),
                            reps * (10 if n < 1 << 20 else 1))
    out.update({
        "device_ms": ms, "busy_ms": busy, "kernels": by,
        "planes_bitwise": bool(torch.equal(r, pr) and torch.equal(i, pi)),
        "kept_rel_err": abs(float(kept) - kept64) / kept64,
        "total_rel_err": abs(float(tot) - tot64) / tot64,
        "sums_bitwise_rerun": bool(torch.equal(kept, again[2])
                                   and torch.equal(tot, again[3]))})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT), help="the tree whose "
                    "src/repro_torch is built and timed (default: this "
                    "repository)")
    ap.add_argument("--out", default="", help="also append each JSON line "
                    "to this file (where only the end of the standard output "
                    "is kept)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src / "src"))
    import torch
    if not torch.cuda.is_available():
        print("odd_width_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    if Path(_build.__file__).resolve().parents[3] != src:
        raise RuntimeError(f"repro_torch came from {_build.__file__}, not "
                           f"from {src}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    lib = _build.build()
    _build.library()
    regs, entry = {}, None
    for ln in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        entry = m.group(1) if m else entry
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry and ("bandpass" in entry or "fft_lines" in entry):
            regs[entry] = int(m.group(1))
    lines = [{"src": str(src), "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi,
              "spills": ptxas_report(lib.with_suffix(".log"))["spilling"],
              "registers": regs}]
    print(json.dumps(lines[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in COLUMNS:
        lines.append({"kernel": "fft_fourstep_columns",
                      **columns(shape, gen, args.reps)})
        print(json.dumps(lines[-1]), flush=True)
        torch.cuda.empty_cache()
    for shape, offset in [*((s, 0) for s in BANDPASS), ((8192, 4097), 1)]:
        lines.append({"kernel": "bandpass_filter",
                      **bandpass(shape, gen, args.reps, offset)})
        print(json.dumps(lines[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
