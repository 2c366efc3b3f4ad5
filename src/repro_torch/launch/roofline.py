"""Roofline terms of a cell, from a trace on fake tensors, at the H100's
peaks (counterpart of ``repro/launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds, per rank:

    compute    = FLOPs / peak FLOP/s of the cell's compute dtype
    memory     = HBM bytes / HBM bandwidth
    collective = wire bytes / link bandwidth

``trace_costs(fn, args)`` runs ``fn`` once under ``FakeTensorMode``: no
memory is allocated and no kernel runs, so a cell of the production mesh
traces on one CPU process (``launch/dryrun.py`` gives it a world of 256
or 512 ranks of torch's ``"fake"`` process-group backend). Its terms:

* **flops** — ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, convolutions and attention; elementwise work counts nothing,
  as in XLA's ``cost_analysis``).
* **bytes** — the reference's dot-centric HBM traffic model
  (``hbm_traffic_model`` there, over XLA's HLO; here a
  ``TorchDispatchMode`` over the ops the trace dispatches): operand and
  output bytes of every matrix product or convolution (weights and
  activations cross HBM at each product, remat's recomputations
  included), output bytes of the data-movement and reduction ops that do
  not fuse (scatter, gather, index, sort, reductions: ``MOVE_OPS``), plus
  the step's arguments and outputs once (optimizer state traffic).
* **coll** — per-rank wire bytes by kind from
  ``sharding/collectives.WIRE``: each collective the policy or an FFT
  exchange issues, converted with a ring's factors on its group size n
  (all-reduce 2(n−1)/n of its bytes, all-gather (n−1)/n of its result,
  reduce-scatter (n−1) times its result, all-to-all (n−1)/n of its
  bytes). The kinds are named as the reference's ``collective_by_kind``.

``memory_report(costs, args_bytes)`` gives the reference's keys per
rank. ``argument_size_in_bytes`` is measured on the cell's own
arguments (at full depth: they are shapes, built without a trace).
``output_size_in_bytes`` (the traced outputs' bytes),
``alias_size_in_bytes`` (outputs sharing an argument's storage: the
donated train state, updated in place) and ``temp_size_in_bytes`` (the
peak of live tensors in the trace, from
``torch.distributed._tools.mem_tracker.MemTracker``, less arguments and
outputs) are measured at depth 0 and 1 and extrapolated over depth by
the dry run, as flops, bytes and wire bytes are (``extrapolate``:
``total = c(0) + L·(c(1) − c(0))``), but for the temporaries' peak: a
prefill or decode step frees each period's temporaries before the next
(what a period keeps, its caches, are outputs), so there the depth-1
peak stands; a train step keeps for its backward what each period
saves, so its peak is extrapolated from depths 1 and 2, ``p(1) + (L −
1)·(p(2) − p(1))``, which parts what a period keeps from the one
period's transient (``extrapolate_raw``). No trace runs at full depth.

Hardware constants: one NVIDIA H100 80GB HBM3 SXM — 67 TFLOP/s float32
(CUDA cores), 495 TF32, 989 bfloat16 (dense tensor cores), 3.35 TB/s
HBM. The link is NVLink 4 at 450 GB/s a direction a GPU, a spec-sheet
figure: the port's ranks on the one card this repo measures on run over
gloo through host memory, so no measurement stands behind it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding import collectives as C

PEAK_FLOPS = {torch.float32: 67e12,     # CUDA cores
              "tf32": 495e12,           # float32 products on tensor cores
              torch.bfloat16: 989e12,
              torch.float16: 989e12}
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 450e9              # NVLink 4, bytes/s per direction per GPU

DOT_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "convolution",
                     "_convolution", "addbmm"})
MOVE_OPS = frozenset({
    # scatter / dynamic-update-slice
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_put", "index_put_", "_index_put_impl_",
    "index_add", "index_add_", "index_copy", "index_copy_",
    "slice_scatter", "select_scatter", "masked_scatter", "masked_scatter_",
    # gather / dynamic-slice
    "gather", "index", "index_select", "embedding", "take_along_dim",
    # sort
    "sort", "argsort", "topk",
    # reductions
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "var", "std", "var_mean", "std_mean", "linalg_vector_norm", "norm",
    "argmax", "argmin", "cumsum", "any", "all"})


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _walk(tree):
    """Every tensor of a tree of dicts, sequences and dataclasses."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name))


def map_tensors(fn: Callable, tree):
    """``fn`` over every tensor of a tree of dicts, lists, tuples (named
    ones too) and dataclasses; other leaves as they are."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree, each storage once."""
    seen, total = set(), 0
    for t in _walk(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


class ByteCounter(TorchDispatchMode):
    """The dot-centric traffic model's op terms over the ops dispatched
    under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name in DOT_OPS:
            self.bytes += sum(_tensor_bytes(t) for t in _walk(out))
            self.bytes += sum(_tensor_bytes(t) for t in _walk(list(args)))
        elif name in MOVE_OPS and not func.__name__.endswith(".other"):
            self.bytes += sum(_tensor_bytes(t) for t in _walk(out))
        return out


def fake_args(args, device=None):
    """The arguments as fake tensors (call inside ``FakeTensorMode``):
    each ``meta`` tensor becomes a tensor of its shape and dtype on
    ``device`` (default cpu); real tensors (host scalars such as a train
    state's step) stay as they are."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return map_tensors(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
        if t.device.type == "meta" else t, args)


def trace_costs(fn: Callable, args, *, device=None,
                memory: bool = True) -> Dict[str, Any]:
    """One call of ``fn(*args)`` under ``FakeTensorMode`` (``args``: meta
    tensors, made fake on ``device``, default cpu): flops, HBM bytes
    (the traffic model plus arguments and outputs once), wire bytes by
    kind, and the memory terms ``memory_report`` reads (see the module
    docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    C.reset_wire()
    peak = 0
    with FakeTensorMode(allow_non_fake_inputs=True):
        fargs = fake_args(args, device)
        in_bytes = tree_bytes(fargs)
        counter = ByteCounter()
        flops = FlopCounterMode(display=False)
        if memory:
            from torch.distributed._tools.mem_tracker import MemTracker
            tracker = MemTracker()
            tracker.track_external(*[t for t in _walk(fargs)
                                     if t.is_floating_point()
                                     or t.dim() > 0])
        else:
            tracker = None
        with flops, counter, (tracker or _null()):
            out = fn(*fargs)
        if tracker is not None:
            peak = max(int(v.get("Total", 0)) for v in
                       tracker.get_tracker_snapshot("peak").values())
        in_store = {t.untyped_storage()._cdata for t in _walk(fargs)}
        out_bytes = tree_bytes(out)
        alias = tree_bytes([t for t in _walk(out)
                            if t.untyped_storage()._cdata in in_store])
    coll = dict(C.WIRE)
    C.reset_wire()
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes + in_bytes + out_bytes),
            "trans": 0.0,
            "coll": coll,
            "args_bytes": float(in_bytes), "out_bytes": float(out_bytes),
            "alias_bytes": float(alias),
            "temp_bytes": float(max(peak - in_bytes - out_bytes + alias, 0))
            if memory else 0.0}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@dataclasses.dataclass
class CellCost:
    """Extrapolated per-rank totals for one cell."""
    flops: float
    bytes_hbm: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    transcendentals: float = 0.0
    compute_dtype: Any = torch.bfloat16

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.compute_dtype]

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def to_dict(self) -> dict:
        dt = self.compute_dtype
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.bytes_hbm,
            "collective_wire_bytes_per_chip": self.coll_bytes,
            "collective_by_kind": self.coll_by_kind,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "compute_dtype": dt if isinstance(dt, str)
            else str(dt).replace("torch.", ""),
            "peak_flops": self.peak_flops,
        }


def _ex(a: float, b: float, trips: int) -> float:
    return a + trips * (b - a)


def extrapolate(c0: dict, c1: dict, trips: int,
                compute_dtype=torch.bfloat16) -> CellCost:
    """total = c0 + trips·(c1 − c0) applied to flops/bytes/collectives."""
    kinds = set(c0["coll"]) | set(c1["coll"])
    coll = {k: max(_ex(c0["coll"].get(k, 0.0), c1["coll"].get(k, 0.0),
                       trips), 0.0) for k in kinds}
    return CellCost(
        flops=_ex(c0["flops"], c1["flops"], trips),
        bytes_hbm=_ex(c0["bytes"], c1["bytes"], trips),
        coll_bytes=coll.get("total", 0.0),
        coll_by_kind=coll,
        transcendentals=_ex(c0.get("trans", 0.0), c1.get("trans", 0.0),
                            trips),
        compute_dtype=compute_dtype,
    )


def extrapolate_raw(c0: dict, c1: dict, trips: int,
                    c2: Optional[dict] = None) -> dict:
    """Every number of ``trace_costs`` results at depth 0 and 1
    extrapolated to ``trips`` periods (negative results clamped to 0),
    but the temporaries' peak: the depth-1 one, or with ``c2`` (depth 2)
    extrapolated from depths 1 and 2 (see the module docstring)."""
    out = {}
    for k, a in c0.items():
        b = c1.get(k, a)
        if k == "coll":
            kinds = set(a) | set(b)
            out[k] = {n: max(_ex(a.get(n, 0.0), b.get(n, 0.0), trips), 0.0)
                      for n in kinds}
        elif k == "temp_bytes" and trips:
            out[k] = b if c2 is None else max(
                _ex(b, c2[k], trips - 1), 0.0)
        else:
            out[k] = max(_ex(a, b, trips), 0.0)
    return out


def model_flops(cfg, shape, *, per_chip: bool = False, chips: int = 256
                ) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params."""
    n = cfg.param_count(active_only=cfg.moe is not None)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:
        tokens = shape.global_batch * 1
        factor = 2.0
    total = factor * n * tokens
    return total / chips if per_chip else total


def memory_report(costs: dict, args_bytes: Optional[float] = None) -> dict:
    """The reference's per-rank memory keys from (extrapolated)
    ``trace_costs`` terms; ``args_bytes`` the cell's own arguments at
    full depth where known."""
    out = {
        "argument_size_in_bytes": int(costs["args_bytes"]
                                      if args_bytes is None else args_bytes),
        "output_size_in_bytes": int(costs["out_bytes"]),
        "temp_size_in_bytes": int(costs["temp_bytes"]),
        "alias_size_in_bytes": int(costs["alias_bytes"]),
        "generated_code_size_in_bytes": 0,
    }
    out["total_hbm_per_chip"] = (out["argument_size_in_bytes"]
                                 + out["temp_size_in_bytes"]
                                 + out["output_size_in_bytes"]
                                 - out["alias_size_in_bytes"])
    return out

