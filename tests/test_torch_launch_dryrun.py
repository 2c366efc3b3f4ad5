"""The port's dry run (``launch/dryrun.py``, ``launch/fft_dryrun.py``) on
a fake world of 256 ranks, in one subprocess (a process holds one
world): reduced qwen3-4b's train and decode cells (its heads widened to
16 so they split over the model axis of 16) run on the (16, 16)
production mesh with status ok; their L ∈ {0, 1} extrapolation equals a
direct trace at the reduced depth (two periods) for flops, and for HBM
bytes and wire bytes by kind to a scalar's few bytes; ``fft_dryrun``'s slab2d at N = 1024 counts the
all-to-all wire bytes of the reference's ring formula. And
``launch/hillclimb.py``'s variants are the reference's, read from its
source (importing ``repro.launch.hillclimb`` would set ``XLA_FLAGS`` to
512 devices in this process)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import hillclimb

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun, fft_dryrun
# the reduced cells: the registry's config and the shapes replaced here
cfg = registry.reduce_common(registry.get_config("qwen3-4b"), num_heads=16,
                             num_kv_heads=4)
registry.get_config = lambda arch: cfg
mesh = dryrun.production_mesh(False)
out = {}
for kind, name in (("train", "train_4k"), ("decode", "decode_32k")):
    shape = SHAPES[name] = ShapeConfig(name, 32, 32, kind)
    r = dryrun.run_cell("qwen3-4b", name, "pod1")
    _, direct = dryrun.trace_cell(
        cfg, shape, mesh, multi_pod=False,
        **({"microbatches": 1} if kind == "train" else {}))
    out[kind] = {"result": r, "direct": direct}
out["fft"] = fft_dryrun.run_cell("slab2d-1024")
print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def fake_world_run():
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_reduced_cells_run_on_the_production_mesh(fake_world_run, kind):
    r = fake_world_run[kind]["result"]
    assert r["status"] == "ok", r.get("traceback")
    assert r["chips"] == 256 and r["roofline"]["trips"] == 2
    assert r["roofline"]["flops_per_chip"] > 0
    assert r["roofline"]["collective_by_kind"]["total"] > 0
    mem = r["memory"]
    assert mem["total_hbm_per_chip"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    if kind == "train":
        # the donated state comes back in place
        assert mem["alias_size_in_bytes"] > 0
        assert r["meta"] == {"microbatches": 1}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_depth_extrapolation_equals_a_direct_trace(fake_world_run, kind):
    raw = fake_world_run[kind]["result"]["raw_cost_full"]
    direct = fake_world_run[kind]["direct"]
    assert raw["flops"] == direct["flops"]
    # bytes and wire bytes: exact but for one scalar that only depth >= 1
    # has, once (the gradient norm's partial sum over a class of leaves
    # that only a period holds, and its all-reduce): a few bytes in
    # ~1e5-1e6
    assert abs(raw["bytes"] - direct["bytes"]) <= 16
    assert set(raw["coll"]) == set(direct["coll"])
    for k, v in direct["coll"].items():
        assert abs(raw["coll"][k] - v) <= 16, k


def test_fft_slab_wire_bytes_follow_the_reference_formula(fake_world_run):
    r = fake_world_run["fft"]
    assert r["status"] == "ok", r.get("traceback")
    n, p = 1024, 16
    block = (n // p) * n * 4                     # one float32 plane's block
    a2a = 2 * (p - 1) / p * block                # re and im, one exchange
    assert r["roofline"]["collective_by_kind"] == {"all-to-all": a2a,
                                                   "total": a2a}
    # per rank: a 16th of the two passes' 5·N·log2 N flops
    assert r["roofline"]["flops_per_chip"] == 2 * 5 * n * n * 10 / p


def test_hillclimb_variants_are_the_reference_variants():
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "hillclimb.py")
                     .read_text())
    want = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "VARIANTS")
    assert hillclimb.VARIANTS == want
