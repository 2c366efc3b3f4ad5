#!/usr/bin/env python3
"""Time design variants of the four-step kernel's mixed-radix routes.

Each variant is the tree's ``src/repro_torch/kernels/csrc`` with a few
lines of ``fft_fourstep.cu`` replaced, built into its own library under
``build/fft_variants/`` and timed by ``tools/fft_routes.py``'s
measurement (device ms by torch.profiler, error against a float64
oracle) at the shapes below. The tree runs first and last, so the spread
of one build shows.

Run from the repository root on a machine with a CUDA card:

    python3 tools/fft_variants.py [variant ...]
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tools")]

SOURCE = "fft_fourstep.cu"
ROWS = ((10000, 10000), (64, 32768), (4, 1 << 20), (8, 10007), (200, 200))
COLUMNS = ((1, 10000, 10000), (1, 200, 200))

# name -> (what it shows, [(text in the tree, replacement)], fft_plan
# attributes to set)
VARIANTS = {
    "tree": ("the kernel as built", [], {}),
    "rows_in_passes": ("rows past 4096 points as two or three passes of "
                       "tiles through a scratch buffer, not one CTA a row",
                       [], {"MIXED_ROW_MAX": 4096}),
    "sincospif_twiddle": ("the four-step twiddle by sincospif on each point, "
                          "not from tables", [
                              ("      g.tw_lg = 1;\n", "      g.tw_lg = 0;\n"),
                              ("      while ((1LL << (2 * g.tw_lg)) < g.tw_M) "
                               "++g.tw_lg;\n", "")], {}),
    "lane_t256_four": ("tiles: up to 256 threads, four CTAs an SM", [
        ("kLaneThreads = 512, kLaneMinBlocks = 2",
         "kLaneThreads = 256, kLaneMinBlocks = 4")], {}),
    "lane_p4": ("tiles: about 4 points a thread instead of 8", [
        ("kLanePoints = 8;", "kLanePoints = 4;")], {}),
}


PLAN_DEFAULTS = {"ROW_MAX_RADIX": 16, "MIXED_ROW_MAX": None}


def build_variant(name, edits, plan):
    from repro_torch.kernels import _build, fft_fourstep, fft_plan
    for key, default in PLAN_DEFAULTS.items():
        setattr(fft_plan, key, plan.get(key, default))
    for fn in (fft_plan.radix_plan, fft_plan.stages, fft_plan.route):
        fn.cache_clear()
    fft_fourstep._CHIRPS.clear()
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    dst = ROOT / "build" / "fft_variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    text = (dst / SOURCE).read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{name}: text not in {SOURCE}: {old[:60]!r}")
        text = text.replace(old, new)
    (dst / SOURCE).write_text(text)
    _build.CSRC, _build._LIB = dst, None
    return _build.library()


def ptxas_lines(lib: Path, kernel: str = "mixed_lines_kernel"):
    """ptxas's spill and register lines for ``kernel`` in the build log."""
    lines = lib.with_suffix(".log").read_text().splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            out += [x.strip() for x in lines[i + 1:i + 3]]
    return out


def main() -> int:
    import torch
    from repro_torch.kernels import fft_plan
    PLAN_DEFAULTS["MIXED_ROW_MAX"] = fft_plan.MIXED_ROW_MAX
    import fft_routes
    if not torch.cuda.is_available():
        print("fft_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    names = sys.argv[1:] or [*VARIANTS, "tree"]
    for name in names:
        build_variant(name, *VARIANTS[name][1:])
        from repro_torch.kernels import _build
        gen = torch.Generator(device="cuda").manual_seed(0)
        res = {"variant": name, "what": VARIANTS[name][0],
               "ptxas": ptxas_lines(_build.build())}
        for shapes, columns in ((ROWS, False), (COLUMNS, True)):
            for shape in shapes:
                r = fft_routes.measure(shape, columns, gen)
                key = ("cols" if columns else "rows") + str(list(shape))
                res[key] = {"device_ms": r["device_ms"],
                            "err": max(r["rel_err_vs_f64"].values())}
                torch.cuda.empty_cache()
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
