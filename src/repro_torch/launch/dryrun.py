"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake
tensors over a fake world (counterpart of ``repro/launch/dryrun.py``).

For each cell this proves, without hardware:
  * the sharding policy is coherent on the production mesh (every
    collective the policy issues has blocks that divide; the step runs
    to its end on this rank's blocks),
  * what it holds per rank (``roofline.memory_report``),
  * and extracts the roofline terms (``roofline.trace_costs``, with the
    L ∈ {0, 1} depth extrapolation — see roofline.py).

The world: one process, ``torch.distributed`` initialised with the
``"fake"`` backend (``torch.testing._internal.distributed.fake_pg``) at
256 ranks (``pod1``, the (16, 16) mesh) or 512 (``pod2``, (2, 16, 16)).
Its collectives move nothing and its tensors are ``FakeTensorMode``'s,
so a cell of the production mesh traces on the CPU. Every cell is built
at depth 0 and 1 (``_with_groups``) and traced there; the totals are
extrapolated over the real depth (``roofline.extrapolate``). No trace
runs at full depth: the full-depth cell is built (shapes only) for its
argument bytes; a train step is traced at depth 2 too, for the peak of
its temporaries alone (``roofline.extrapolate_raw``). The roofline
traces force ``microbatches=1``: the micro=1 step is the
bandwidth-optimal variant of the same algorithm, and the memory
report's temporaries come from it too.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh pod1
  python -m repro_torch.launch.dryrun --all               # every cell, 1-pod + 2-pod
  python -m repro_torch.launch.dryrun --all --mesh pod1   # single-pod only

Results land in results/dryrun/<arch>__<shape>__<mesh>.json, in the
reference's keys (``compile_seconds`` is the build and trace time).
"""
import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import blocks as blk

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun"

_MESHES = {}


def fake_world(size: int) -> None:
    """Make this process a fake world of ``size`` ranks (rank 0): the
    ``"fake"`` backend, whose collectives move nothing. A fake world of
    another size is replaced; a real one raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run needs a fake world; this process already "
                f"runs a {dist.get_backend()!r} one")
        if dist.get_world_size() == size:
            return
        _MESHES.clear()
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def production_mesh(multi_pod: bool):
    """The production mesh over a fake world of its size, on the CPU
    (built once a world)."""
    fake_world(512 if multi_pod else 256)
    if multi_pod not in _MESHES:
        _MESHES[multi_pod] = make_production_mesh(multi_pod=multi_pod,
                                                  device="cpu")
    return _MESHES[multi_pod]


def _with_groups(cfg, groups: int):
    """Copy of cfg with the period count forced to `groups`."""
    period = len(cfg.layer_pattern)
    reps = {"num_layers": period * groups}
    if cfg.family == "encdec":
        reps.update(encoder_layers=groups, decoder_layers=groups)
    return dataclasses.replace(cfg, **reps)


def trace_cell(cfg, shape, mesh, *, multi_pod: bool, **overrides):
    """Build one cell and trace its step once on this rank's blocks."""
    built, policy = specs_mod.build_cell(cfg, shape, mesh,
                                         multi_pod=multi_pod, **overrides)
    return built, rl.trace_costs(built["fn"], built["local_args"],
                                 device=mesh.device)


def run_cell(arch: str, shape_name: str, mesh_name: str,
             *, full_roofline: bool = True, **overrides) -> dict:
    cfg = registry.get_config(arch)
    if "moe_mode" in overrides:     # EP↔TP expert-sharding probe
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         mode=overrides.pop("moe_mode")))
    if "capacity_factor" in overrides:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=overrides.pop("capacity_factor")))
    shape = SHAPES[shape_name]
    multi_pod = mesh_name == "pod2"
    chips = 512 if multi_pod else 256

    t0 = time.time()
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "chips": chips, "status": "ok"}
    try:
        mesh = production_mesh(multi_pod)
        built, _ = specs_mod.build_cell(cfg, shape, mesh,
                                        multi_pod=multi_pod, **overrides)
        result["meta"] = built["meta"]
        trips = (cfg.encoder_layers if cfg.family == "encdec"
                 else blk.n_groups(cfg))
        ro = dict(overrides)
        if shape.kind == "train":
            ro["microbatches"] = 1
        # depth 2 for a train step's temporaries only (roofline.py)
        depths = (0, 1, 2) if shape.kind == "train" else (0, 1)
        costs = {g: trace_cell(_with_groups(cfg, g), shape, mesh,
                               multi_pod=multi_pod, **ro)[1]
                 for g in depths}
        raw = rl.extrapolate_raw(costs[0], costs[1], trips, costs.get(2))
        result["memory"] = rl.memory_report(
            raw, args_bytes=rl.tree_bytes(built["local_args"]))
        result["raw_cost_full"] = {k: raw[k] for k in
                                   ("flops", "bytes", "trans", "coll")}
        result["raw_costs_by_depth"] = costs
        if full_roofline:
            cell = rl.extrapolate(costs[0], costs[1], trips,
                                  compute_dtype=torch.bfloat16)
            result["roofline"] = cell.to_dict()
            result["roofline"]["trips"] = trips
            mf = rl.model_flops(cfg, shape, per_chip=True, chips=chips)
            result["roofline"]["model_flops_per_chip"] = mf
            result["roofline"]["useful_ratio"] = (
                mf / cell.flops if cell.flops else 0.0)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["compile_seconds"] = round(time.time() - t0, 1)
    return result


def save(result: dict):
    RESULTS.mkdir(parents=True, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    (RESULTS / name).write_text(json.dumps(result, indent=2, default=str))
    mem = result.get("memory", {}).get("total_hbm_per_chip", 0) / 2**30
    dom = result.get("roofline", {}).get("dominant", "-")
    print(f"[{result['status']:5s}] {result['arch']:16s} "
          f"{result['shape']:12s} {result['mesh']}  "
          f"hbm/chip={mem:6.2f}GiB dom={dom:10s} "
          f"t={result['compile_seconds']}s", flush=True)
    if result["status"] == "error":
        print("   ", result["error"].splitlines()[0][:160], flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    args = ap.parse_args()

    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s.name) for a in registry.list_archs()
                for s in registry.cells(a)]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]

    for arch, shape in todo:
        for mesh_name in meshes:
            out = (RESULTS /
                   f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and out.exists():
                prev = json.loads(out.read_text())
                if prev.get("status") == "ok":
                    continue
            # roofline terms are a single-pod report; pod2 is the
            # sharding-coherence proof for the pod axis
            full = (mesh_name == "pod1") and not args.no_roofline
            save(run_cell(arch, shape, mesh_name, full_roofline=full))


if __name__ == "__main__":
    main()
