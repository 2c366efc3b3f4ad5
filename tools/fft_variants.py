#!/usr/bin/env python3
"""Time design variants of the four-step kernel's mixed-radix routes.

A variant is the tree's ``src/repro_torch/kernels/csrc`` with a few
lines of its sources replaced (each edit in the one source that holds
its text; built into its own library under ``build/fft_variants/``), or
the tree's library with ``fft_plan``'s routing constants set otherwise
(no build: the earlier designs' kernels stay in the library, so
"lines_rows", "passes_columns" and "passes_rows" time the routes that
the composite rows, the cluster columns and the tile register kernel's
rows replaced; "bluestein_pow2" and "bluestein_tile_all" route every
Bluestein N to the power-of-two design with its three pointwise kernels,
or to the tile register kernel's fused passes, where the tree splits
them at ``fft_plan.BLUESTEIN_TILE_MIN``).

Run from the repository root on a machine with a CUDA card:

    python3 tools/fft_variants.py [--n 10000,5000] [--out FILE] [variant ...]
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tools")]

# rows: the 10000^2 step's, rows on the register kernel (10000, 5000,
# 3000) and off it (13824), the composites' threshold's neighbours, the
# short rows that keep mixed_lines_kernel, the long rows of the 2048 x
# 32768 chain and beyond (the tile register kernel's), Bluestein (M in
# two, one and three passes each way)
ROWS = ((10000, 10000), (64, 10000), (3, 13824), (64, 5000), (64, 3000),
        (64, 2000), (64, 1680), (64, 1000), (200, 200), (64, 360),
        (2048, 32768), (64, 32768), (4, 1 << 20), (1, 1 << 25),
        (1, 5 ** 10), (8, 10007), (16, 4097), (64, 257), (4, 100003),
        (1, 1000003), (1, 2000003), (1, 4000037), (1, 8000009),
        (1, (1 << 24) + 1))
# columns (outer, N, inner), along the middle axis: the 10000^2 step's,
# the real step's half width, the FFT engine's 1000^2 and its half width
# (odd inner), another odd inner, the cluster's other sizes, and Bluestein
COLUMNS = ((1, 10000, 10000), (1, 10000, 5001), (1, 1000, 1000),
           (1, 1000, 501), (3, 10000, 7), (1, 600, 600), (1, 1680, 1680),
           (1, 2000, 2000), (1, 3000, 3000), (1, 4000, 4000),
           (1, 5000, 5000), (1, 200, 200), (3, 257, 100))

# name -> (what it shows, [(text in the tree, replacement)], fft_plan
# attributes to set, the shapes it times: "rows", "columns" or "both")
VARIANTS = {
    "tree": ("the routes as built", [], {}, "both"),
    # the row designs the register kernel replaced
    "rows_one_cta": ("rows of 2048 points and up on the composite radices "
                     "in mixed_lines_kernel, one CTA a row with two shared "
                     "buffers (the design the register kernel replaced)", [
                         ("  if (st.E == kRowRegE) return launch_row_reg("
                          "re, im, ore, oim, g, stream);\n", "")],
                     {}, "rows"),
    "lines_rows": ("rows on radix_plan's radices (10000: 16, 5, 5, 5, 5) in "
                   "mixed_lines_kernel, the design before the composites",
                   [], {"ROW_WIDE_MIN": 1 << 62}, "rows"),
    # the column designs
    "passes_columns": ("columns past 439 points as line passes through a "
                       "scratch buffer, the design the cluster columns "
                       "replaced", [], {"COLUMN_CLUSTER_MIN": 1 << 62},
                       "columns"),
    "cluster_columns_all": ("the cluster kernel for every column it holds "
                            "(8 and 16 CTAs too)", [],
                            {"COLUMN_CLUSTER_CTAS": 16}, "columns"),
    # the designs the tile register kernel replaced
    "passes_rows": ("rows past one CTA as line passes of <= 439 points "
                    "(mixed_lines_kernel, tiles of 32 lines; 2^25 in four "
                    "passes), the design the tile register kernel's rows "
                    "replaced", [], {"TILE_ROWS_MIN": 1 << 62}, "rows"),
    "bluestein_least_m": ("Bluestein at the least M of the fewest passes "
                          "(33592320 at 2^24 + 1, its lines on 12 radix "
                          "passes), not the fewest radix passes within 1% "
                          "of it", [], {"BLUESTEIN_M_SLACK": 0.0}, "both"),
    "tile_448": ("the tile register kernel at up to 448 threads (72 "
                 "registers, lines to 1344 points) instead of 384 (80)",
                 [("constexpr int kTileThreads = 384;",
                   "constexpr int kTileThreads = 448;")],
                 {"TILE_THREADS": 448}, "both"),
    "bluestein_pow2": ("Bluestein at a power-of-two M (2^26 at 2^24 + 1) on "
                       "the radix routes or the line passes of <= 439 "
                       "points, with three pointwise kernels, at every N",
                       [], {"BLUESTEIN_TILE_MIN": 1 << 62}, "both"),
    "bluestein_tile_all": ("Bluestein on the tile register kernel, the "
                           "chirps fused, at every N", [],
                           {"BLUESTEIN_TILE_MIN": 0}, "both"),
    "wide_tiles": ("every tile stage of the line passes (columns past the "
                   "cluster, long rows) on the composite radices, 256 "
                   "threads a CTA, not radices to 8 or the register kernel",
                   [], {"plan_array": "wide_lanes"}, "both"),
}

PLAN_DEFAULTS = {}


def wide_lanes(lines, columns):
    """fft_plan.plan_array with every tile stage on the composite radices
    (E = 0: mixed_lines_kernel's wide instantiation)."""
    from repro_torch.kernels import fft_plan
    if len(lines) == 1 and not columns:
        return PLAN_DEFAULTS["plan_array"](lines, columns)
    flat = [len(lines)]
    for n in lines:
        rad = fft_plan.wide_radix_plan(n)
        flat += [n, len(rad), 0, *rad]
    return (ctypes.c_int * len(flat))(*flat)


def build_variant(name, edits, plan):
    from repro_torch.kernels import _build, fft_fourstep, fft_plan
    for key in ("COLUMN_CLUSTER_MIN", "ROW_WIDE_MIN", "COLUMN_CLUSTER_CTAS",
                "TILE_ROWS_MIN", "TILE_THREADS", "BLUESTEIN_M_SLACK",
                "BLUESTEIN_TILE_MIN", "plan_array"):
        PLAN_DEFAULTS.setdefault(key, getattr(fft_plan, key))
    for key, default in PLAN_DEFAULTS.items():
        value = plan.get(key, default)
        setattr(fft_plan, key, globals()[value] if isinstance(value, str)
                else value)
    for fn in vars(fft_plan).values():
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    fft_fourstep._CHIRPS.clear()
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    if not edits:
        _build.CSRC, _build._LIB = src, None
        return _build.library()
    dst = ROOT / "build" / "fft_variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for old, new in edits:
        holders = [f for f in sorted(dst.iterdir()) if old in f.read_text()]
        if len(holders) != 1:
            raise ValueError(f"{name}: {len(holders)} sources hold "
                             f"{old[:60]!r}")
        holders[0].write_text(holders[0].read_text().replace(old, new))
    _build.CSRC, _build._LIB = dst, None
    return _build.library()


def ptxas_lines(lib: Path, kernel: str):
    """ptxas's spill and register lines for ``kernel`` in the build log."""
    lines = lib.with_suffix(".log").read_text().splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            out += [x.strip() for x in lines[i + 1:i + 3]]
    return out


def main() -> int:
    import argparse
    import torch
    import fft_routes
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", help="names in VARIANTS (all, "
                    "then the tree again, when none is given)")
    ap.add_argument("--n", default="", help="time only the shapes of these "
                    "comma-separated N")
    ap.add_argument("--out", default="", help="also append each variant's "
                    "JSON line to this file (a chip call returns only the "
                    "end of its output)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fft_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, fft_plan
    only = {int(x) for x in args.n.split(",") if x}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    for name in args.variants or [*VARIANTS, "tree"]:
        what, edits, plan, which = VARIANTS[name]
        build_variant(name, edits, plan)
        gen = torch.Generator(device="cuda").manual_seed(0)
        res = {"variant": name, "what": what, "ptxas": {
            k: ptxas_lines(_build.build(), k)
            for k in ("mixed_cluster_kernel", "mixed_lines_kernel",
                      "mixed_row_reg_kernel", "mixed_tile_reg_kernel")}}
        if not edits and name != "tree":
            res.pop("ptxas")
        for shapes, columns in ((ROWS, False), (COLUMNS, True)):
            if which != "both" and which != ("columns" if columns
                                             else "rows"):
                continue
            for shape in shapes:
                n, inner = (shape[1], shape[2]) if columns else (shape[1], 1)
                if only and n not in only:
                    continue
                r = fft_routes.measure(shape, columns, gen)
                route = fft_plan.route(n, inner > 1)
                res[("cols" if columns else "rows") + str(list(shape))] = {
                    "device_ms": r["device_ms"],
                    "queued_ms": r["queued_ms"],
                    "torch_fft_device_ms": r["torch_fft_device_ms"],
                    "bound_ms": r["bound_ms"], "launches": r["launches"],
                    "plan": list(route.plan) if route.plan else None,
                    "lines": list(route.lines or (
                        route.m_route.lines if route.m_route else ())),
                    "m": route.m or None, "tile": route.tile,
                    "cluster": route.cluster,
                    "by_kernel": r["by_kernel"],
                    "err": max(r["rel_err_vs_f64"].values())}
                torch.cuda.empty_cache()
        print(json.dumps(res), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
