"""Generate the §Dry-run / §Roofline tables from the dry-run JSON
artifacts (counterpart of ``repro/launch/report.py``: the same logic, so
the same JSON files give the same Markdown).
Usage: python -m repro_torch.launch.report [results/dryrun]"""
from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(results_dir: Path):
    cells = {}
    for f in sorted(results_dir.glob("*.json")):
        r = json.loads(f.read_text())
        cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def note_for(r) -> str:
    rf = r.get("roofline", {})
    dom = rf.get("dominant")
    kind = r["shape"].split("_")[0]
    coll = rf.get("collective_by_kind", {})
    ar = coll.get("all-reduce", 0) / max(coll.get("total", 1), 1)
    if dom == "collective":
        if r["shape"] == "train_4k" and ar > 0.5:
            return ("TP all-reduce dominates: sequence-shard activations "
                    "(Megatron-SP) to halve wire bytes + overlap")
        return "overlap collectives with compute; coarser TP/EP grouping"
    if dom == "memory":
        if kind == "decode":
            return "KV-cache bound: int8 KV cache / more batch per chip"
        return "fuse attention into a Pallas flash kernel (VMEM-resident)"
    return "compute-bound (good): raise per-chip batch for MXU utilization"


def dryrun_table(cells) -> str:
    lines = ["| arch | shape | mesh | status | HBM/chip (GiB) | "
             "compile (s) | collectives |",
             "|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in sorted(
            cells.items(), key=lambda kv: (kv[0][0],
                                           SHAPE_ORDER.index(kv[0][1]),
                                           kv[0][2])):
        mem = r.get("memory", {}).get("total_hbm_per_chip", 0)
        colls = r.get("raw_cost_full", {}).get("coll", {})
        kinds = ",".join(sorted(k for k in colls if k != "total")) or "-"
        lines.append(
            f"| {arch} | {shape} | {mesh} | {r['status']} | "
            f"{fmt_bytes(mem)} | {r.get('compile_seconds', '-')} | "
            f"{kinds} |")
    return "\n".join(lines)


def roofline_table(cells) -> str:
    lines = ["| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
             "dominant | compute-fraction | 6ND/HLO | bottleneck note |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in sorted(
            cells.items(), key=lambda kv: (kv[0][0],
                                           SHAPE_ORDER.index(kv[0][1]))):
        if mesh != "pod1" or "roofline" not in r:
            continue
        rf = r["roofline"]
        tc, tm, tl = (rf["t_compute_s"], rf["t_memory_s"],
                      rf["t_collective_s"])
        bound = max(tc, tm, tl)
        frac = tc / bound if bound else 0.0
        lines.append(
            f"| {arch} | {shape} | {tc*1e3:.1f} | {tm*1e3:.1f} | "
            f"{tl*1e3:.1f} | {rf['dominant']} | {frac:.2f} | "
            f"{rf['useful_ratio']:.2f} | {note_for(r)} |")
    return "\n".join(lines)


def summary(cells) -> str:
    ok = sum(1 for r in cells.values() if r["status"] == "ok")
    pod1 = sum(1 for (a, s, m) in cells if m == "pod1")
    pod2 = sum(1 for (a, s, m) in cells if m == "pod2")
    worst = None
    most_coll = None
    for (arch, shape, mesh), r in cells.items():
        if mesh != "pod1" or "roofline" not in r:
            continue
        rf = r["roofline"]
        bound = max(rf["t_compute_s"], rf["t_memory_s"],
                    rf["t_collective_s"])
        frac = rf["t_compute_s"] / bound if bound else 0
        if worst is None or frac < worst[1]:
            worst = ((arch, shape), frac)
        cfrac = rf["t_collective_s"] / bound if bound else 0
        if most_coll is None or cfrac > most_coll[1]:
            most_coll = ((arch, shape), cfrac)
    return (f"- cells: {len(cells)} ({pod1} single-pod 16×16 + {pod2} "
            f"multi-pod 2×16×16), **{ok} ok / {len(cells) - ok} failed**\n"
            f"- worst compute-fraction: {worst[0]} ({worst[1]:.2f})\n"
            f"- most collective-bound: {most_coll[0]} "
            f"({most_coll[1]:.2f} of bound)")


def main():
    d = Path(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
    cells = load(d)
    print("## Summary\n")
    print(summary(cells))
    print("\n## Dry-run\n")
    print(dryrun_table(cells))
    print("\n## Roofline (single-pod, per chip)\n")
    print(roofline_table(cells))


if __name__ == "__main__":
    main()
