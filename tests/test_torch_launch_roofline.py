"""The port's ``launch/roofline.py`` against the reference's
(``tests/test_roofline.py``, for each function the port has): MODEL_FLOPS
for every arch and cell, the L-extrapolation, the terms and the dominant
one at the H100's peaks, the byte model of ``trace_costs`` on a toy
function against a hand count, and the wire bytes of each collective
kind against the ring formulas on a fake world of four ranks (in a
subprocess: a process holds one world)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import roofline as rl

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch,shape", jregistry.all_cells())
def test_model_flops_matches_reference(arch, shape):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for per_chip in (False, True):
        assert rl.model_flops(cfg, SHAPES[shape], per_chip=per_chip) == \
            jrl.model_flops(jcfg, JSHAPES[shape], per_chip=per_chip)


def test_extrapolation():
    c0 = {"flops": 10.0, "bytes": 100.0, "trans": 0.0,
          "coll": {"all-reduce": 5.0, "total": 5.0}}
    c1 = {"flops": 14.0, "bytes": 160.0, "trans": 0.0,
          "coll": {"all-reduce": 8.0, "total": 8.0}}
    cell = rl.extrapolate(c0, c1, 10)
    want = jrl.extrapolate(c0, c1, 10)
    assert cell.flops == want.flops == 10 + 10 * 4
    assert cell.bytes_hbm == want.bytes_hbm == 100 + 10 * 60
    assert cell.coll_bytes == want.coll_bytes == 5 + 10 * 3
    assert cell.coll_by_kind == want.coll_by_kind
    assert cell.dominant in ("compute", "memory", "collective")
    # the memory terms: linear but for the temporaries' peak, the
    # depth-1 one, or from depths 1 and 2
    m0 = dict(c0, args_bytes=1.0, out_bytes=2.0, alias_bytes=0.0,
              temp_bytes=30.0)
    m1 = dict(c1, args_bytes=3.0, out_bytes=4.0, alias_bytes=0.0,
              temp_bytes=50.0)
    m2 = dict(m1, temp_bytes=55.0)
    raw = rl.extrapolate_raw(m0, m1, 10)
    assert (raw["flops"], raw["args_bytes"], raw["temp_bytes"]) == \
        (50.0, 21.0, 50.0)
    assert rl.extrapolate_raw(m0, m1, 10, m2)["temp_bytes"] == 50 + 9 * 5


def test_terms_and_dominant():
    """Each term is one second at its H100 peak: bf16 and float32
    products, HBM, the NVLink figure."""
    for dtype, peak in ((torch.bfloat16, 989e12), (torch.float32, 67e12),
                        ("tf32", 495e12)):
        cell = rl.CellCost(flops=peak, bytes_hbm=0.0, coll_bytes=0.0,
                           coll_by_kind={}, compute_dtype=dtype)
        assert abs(cell.t_compute - 1.0) < 1e-9
        assert cell.dominant == "compute"
    mem = rl.CellCost(flops=0.0, bytes_hbm=3.35e12, coll_bytes=0.0,
                      coll_by_kind={})
    assert abs(mem.t_memory - 1.0) < 1e-9 and mem.dominant == "memory"
    link = rl.CellCost(flops=0.0, bytes_hbm=0.0, coll_bytes=450e9,
                       coll_by_kind={"total": 450e9})
    assert abs(link.t_collective - 1.0) < 1e-9
    assert link.dominant == "collective"
    d = link.to_dict()
    assert set(jrl.CellCost(0.0, 0.0, 0.0, {}).to_dict()) <= set(d)


def test_moe_uses_active_params():
    cfg = registry.get_config("grok-1-314b")
    tr = rl.model_flops(cfg, SHAPES["train_4k"])
    assert tr < 0.5 * 6 * cfg.param_count() * 256 * 4096


def test_byte_model_counts_products_and_a_gather():
    """Two matmuls and a gather under ``trace_costs``: operand and output
    bytes of each product, the gather's output, and the arguments and
    the output once; flops 2·M·N·K a product."""
    def fn(a, b, d, idx):
        e = (a @ b) @ d
        return e.index_select(0, idx)

    meta = {"device": "meta"}
    args = (torch.empty(8, 16, **meta), torch.empty(16, 32, **meta),
            torch.empty(32, 4, **meta),
            torch.empty(3, dtype=torch.int64, **meta))
    got = rl.trace_costs(fn, args)
    f32 = 4
    mm1 = (8 * 16 + 16 * 32 + 8 * 32) * f32
    mm2 = (8 * 32 + 32 * 4 + 8 * 4) * f32
    gather = 3 * 4 * f32
    io = (8 * 16 + 16 * 32 + 32 * 4) * f32 + 3 * 8 + 3 * 4 * f32
    assert got["bytes"] == mm1 + mm2 + gather + io
    assert got["flops"] == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    assert got["coll"] == {}
    assert got["args_bytes"] == (8 * 16 + 16 * 32 + 32 * 4) * f32 + 3 * 8
    assert got["out_bytes"] == 3 * 4 * f32 and got["alias_bytes"] == 0
    # the peak of what lived beside the arguments and the output: some
    # of the two products' outputs
    assert 0 < got["temp_bytes"] <= (8 * 32 + 8 * 4) * f32
    report = rl.memory_report(got)
    assert set(report) == {"argument_size_in_bytes", "output_size_in_bytes",
                           "temp_size_in_bytes", "alias_size_in_bytes",
                           "generated_code_size_in_bytes",
                           "total_hbm_per_chip"}


WIRE_SCRIPT = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch.compat import make_mesh
from repro_torch.core.fft.schedule import AllToAll
from repro_torch.sharding import collectives as C
g = dist.group.WORLD
x = torch.zeros(8, 6)
out = {}
for kind, call in (
        ("all-reduce", lambda: C._all_reduce(x, g)),
        ("all-gather", lambda: C._all_gather(x, 0, 4, g)),
        ("reduce-scatter", lambda: C._reduce_scatter(x, 0, 4, g)),
        ("all-to-all", lambda: C._all_to_all(x, 0, 1, 4, g))):
    C.reset_wire()
    call()
    out[kind] = dict(C.WIRE)
mesh = make_mesh((4,), ("data",), device="cpu")
C.reset_wire()
AllToAll("data", 0, 1, 4).apply((x,), mesh)
out["fft"] = dict(C.WIRE)
print(json.dumps(out))
"""


def test_wire_counts_follow_the_ring_formulas():
    res = subprocess.run(
        [sys.executable, "-c", WIRE_SCRIPT], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    n, nbytes = 4, 8 * 6 * 4
    want = {"all-reduce": 2 * (n - 1) / n * nbytes,          # its bytes
            "all-gather": (n - 1) / n * (n * nbytes),        # its result
            "reduce-scatter": (n - 1) * (nbytes / n),        # its result
            "all-to-all": (n - 1) / n * nbytes}
    for kind, wire in want.items():
        assert got[kind] == {kind: wire, "total": wire}, kind
    assert got["fft"] == {"all-to-all": want["all-to-all"],
                          "total": want["all-to-all"]}
