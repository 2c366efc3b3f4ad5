"""Hillclimb runner (counterpart of ``repro/launch/hillclimb.py``):
traces named cell *variants* with ``launch/dryrun.run_cell`` on the fake
world and records their roofline terms into results/hillclimb/.

Variants are (cell, overrides) pairs; each run re-derives the three
roofline terms with the same methodology as the main dry run, so
before/after numbers are directly comparable.

  python -m repro_torch.launch.hillclimb --list
  python -m repro_torch.launch.hillclimb --variant qwen3_fsdp
  python -m repro_torch.launch.hillclimb --all
"""
import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import run_cell

RESULTS = Path(__file__).resolve().parents[3] / "results" / "hillclimb"

VARIANTS = {
    # Cell A — qwen3-4b train_4k
    "qwen3_base": ("qwen3-4b", "train_4k", {}),
    "qwen3_fsdp": ("qwen3-4b", "train_4k", {"parallelism": "fsdp"}),
    "qwen3_fsdp_micro1": ("qwen3-4b", "train_4k",
                          {"parallelism": "fsdp", "microbatches": 1}),
    "qwen3_insitu": ("qwen3-4b", "train_4k", {"insitu": True}),
    "qwen3_fsdp_insitu": ("qwen3-4b", "train_4k",
                          {"parallelism": "fsdp", "insitu": True}),
    # Cell B — gemma2-27b decode_32k
    "gemma2_decode_base": ("gemma2-27b", "decode_32k", {}),
    "gemma2_decode_int8": ("gemma2-27b", "decode_32k",
                           {"cache_impl": "int8"}),
    "gemma2_decode_tponly": ("gemma2-27b", "decode_32k",
                             {"fsdp_params": False}),
    "gemma2_decode_tponly_int8": ("gemma2-27b", "decode_32k",
                                  {"fsdp_params": False,
                                   "cache_impl": "int8"}),
    # Prefill probes
    "qwen3_prefill_base": ("qwen3-4b", "prefill_32k", {}),
    "qwen3_prefill_tponly": ("qwen3-4b", "prefill_32k",
                             {"fsdp_params": False}),
    # MoE expert-sharding probes
    "dbrx_train_base": ("dbrx-132b", "train_4k", {}),
    "dbrx_train_tpmoe": ("dbrx-132b", "train_4k", {"moe_mode": "tp"}),
    "dbrx_train_cap1": ("dbrx-132b", "train_4k", {"capacity_factor": 1.0}),
    # MoE train memory/collective probes
    "dbrx_train_fsdp": ("dbrx-132b", "train_4k",
                        {"parallelism": "fsdp"}),
    "grok_train_fsdp": ("grok-1-314b", "train_4k",
                        {"parallelism": "fsdp"}),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    if args.list:
        for k, v in VARIANTS.items():
            print(k, v)
        return
    RESULTS.mkdir(parents=True, exist_ok=True)
    todo = list(VARIANTS) if args.all else [args.variant]
    for name in todo:
        arch, shape, overrides = VARIANTS[name]
        r = run_cell(arch, shape, "pod1", **overrides)
        r["variant"] = name
        r["overrides"] = {k: str(v) for k, v in overrides.items()}
        (RESULTS / f"{name}.json").write_text(
            json.dumps(r, indent=2, default=str))
        rf = r.get("roofline", {})
        mem = r.get("memory", {}).get("total_hbm_per_chip", 0) / 2**30
        print(f"[{r['status']:5s}] {name:22s} "
              f"t_comp={rf.get('t_compute_s', 0)*1e3:7.1f}ms "
              f"t_mem={rf.get('t_memory_s', 0)*1e3:7.1f}ms "
              f"t_coll={rf.get('t_collective_s', 0)*1e3:7.1f}ms "
              f"hbm={mem:6.2f}GiB dom={rf.get('dominant', '-')}",
              flush=True)
        if r["status"] == "error":
            print("   ", r["error"][:200])


if __name__ == "__main__":
    main()
