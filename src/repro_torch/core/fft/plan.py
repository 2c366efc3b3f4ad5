"""FFTW-style plan lifecycle (counterpart of ``repro/core/fft/plan.py``).

An ``FFTPlan`` captures (grid shape, mesh, decomposition, direction,
backend, overlap chunking, batch rank) and the matching ``Schedule``;
``execute`` runs it on this rank's local blocks. PyTorch runs eagerly,
so ``compile`` only binds the schedule. ``place`` cuts a global array
to this rank's input block (the plan's ``in_spec``), and ``unplace``
gathers output blocks back to the global array (``out_spec``).
``plan_dft`` keeps the reference's process-wide plan cache: identical
arguments return the SAME plan object, and ``plan_cache_stats()``
counts hits and misses.

Not here, each raising ``NotImplementedError`` that names its ROADMAP
queue 1 item: ``backend="measure"`` / ``decomp="measure"`` autotuning
(item 10), persistent wisdom (item 13), ``real=True`` half-spectrum
plans (item 9) and ``wire_dtype`` (item 12).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

from repro_torch.compat import Mesh
from repro_torch.core.fft import distributed
from repro_torch.core.fft.dft import BACKENDS, to_complex, to_pair
from repro_torch.core.fft.schedule import (CAPS, Schedule, build_schedule,
                                           exchange_topology,
                                           execute_schedule, overlap_site)

FORWARD = "forward"
BACKWARD = "backward"

MEASURE = "measure"                   # backend/decomp sentinel: autotune

_PLAN_CACHE: Dict[tuple, "FFTPlan"] = {}
_STATS = {"hits": 0, "misses": 0}
_LOCK = threading.Lock()


def _mesh_key(mesh: Mesh) -> tuple:
    # the axes' process groups tell apart meshes of one shape built over
    # different groups (each make_mesh of more than one rank makes its own)
    groups = tuple(mesh.group(n).group_name for n in mesh.axis_names) \
        if mesh.device_mesh is not None else ()
    return tuple(mesh.shape.items()), str(mesh.device), groups


def plan_cache_stats() -> Dict[str, int]:
    """Plan-cache counters: ``hits``/``misses``/``size``."""
    with _LOCK:
        return dict(_STATS, size=len(_PLAN_CACHE))


def plan_cache_clear() -> None:
    """Empty the plan cache and zero its counters."""
    with _LOCK:
        _PLAN_CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0


def set_wisdom(path, mode: str = "readwrite"):
    """Persistent wisdom stores measured winners; the port has no
    measured sweep yet."""
    raise NotImplementedError("wisdom is ROADMAP queue 1 item 13")


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FFTPlan:
    shape: Tuple[int, ...]            # transform (grid) shape, no batch dims
    direction: str
    mesh: Mesh
    decomp: str                       # key into schedule.CAPS
    axis_names: Tuple[str, ...]
    backend: str = "auto"
    overlap_chunks: int = 0           # >1: chunked overlap pipelining
    batch_ndim: int = 0               # extra leading batch dims at execute
    _fn: Optional[Callable] = None
    _sched: Optional[Schedule] = None

    def schedule(self) -> Schedule:
        """The stage schedule this plan runs (built lazily)."""
        if self._sched is None:
            self._sched = build_schedule(
                self.decomp, self.shape, self.mesh, self.axis_names,
                inverse=self.direction == BACKWARD, backend=self.backend)
        return self._sched

    def topology(self) -> Tuple[dict, ...]:
        """The plan's wire profile: one ``{axis_name, shards, wire_dtype,
        wire_codec, crosses_hosts}`` dict per exchange, in order."""
        return exchange_topology(self.schedule())

    def compile(self) -> "FFTPlan":
        """Bind the schedule (there is nothing to trace: eager PyTorch);
        an ineligible ``overlap_chunks`` raises here, at plan time."""
        sched, mesh = self.schedule(), self.mesh
        chunks = self.overlap_chunks
        if chunks and chunks > 1:
            overlap_site(sched)

        def fn(*arrays):
            return execute_schedule(sched, mesh, *arrays,
                                    overlap_chunks=chunks)

        self._fn = fn
        return self

    def _spec(self, tail) -> tuple:
        return (None,) * self.batch_ndim + tuple(tail)

    def place(self, x):
        """This rank's block of the global array ``x`` (numpy or torch,
        real or complex) under the plan's input spec, on the mesh's
        device, as a split (re, im) pair."""
        spec = self._spec(self.schedule().in_spec)
        return to_pair(distributed.shard(x, self.mesh, spec))

    def unplace(self, *arrays, dst=None):
        """The global arrays from every rank's output blocks under the
        plan's output spec (collective): on every rank, or with ``dst``
        only there (None elsewhere)."""
        spec = self._spec(self.schedule().out_spec)
        out = tuple(distributed.unshard(a, self.mesh, spec, dst=dst)
                    for a in arrays)
        return out if len(out) > 1 else out[0]

    def block_shape(self) -> Tuple[int, ...]:
        """This rank's input block of the grid under the plan's input
        spec (leading batch dims not included)."""
        return tuple(n // distributed.shard_count(self.mesh, entry)
                     for n, entry in zip(self.shape,
                                         self.schedule().in_spec))

    def execute(self, *arrays):
        """Run the transform on this rank's blocks: ``execute(re, im)``
        → (re, im). A block of another shape (the whole grid on a mesh
        of several ranks, say) raises."""
        want = self.block_shape()
        got = tuple(arrays[0].shape[arrays[0].dim() - len(want):])
        if got != want:
            raise ValueError(
                f"the plan for grid {self.shape} takes this rank's block "
                f"{want} (input spec {self.schedule().in_spec}), got "
                f"{got}: cut the global array with place() or "
                f"distributed.shard")
        if self._fn is None:
            self.compile()
        return self._fn(*arrays)

    def execute_complex(self, x):
        return to_complex(self.execute(*self.place(x)))


# ---------------------------------------------------------------------------
# Planner entry points (cached)
# ---------------------------------------------------------------------------

def _infer(shape, decomp, axis_names, mesh):
    if decomp is None:
        if len(shape) == 1:
            decomp = "fourstep1d"
        elif len(shape) == 2:
            decomp = "slab"
        else:
            # pencil wants two mesh axes; a 1-axis mesh still gets 3-D
            # grids via the one-exchange slab3d schedule
            decomp = "pencil" if len(mesh.axis_names) >= 2 else "slab3d"
    if axis_names is None:
        names = tuple(mesh.axis_names)
        caps = CAPS.get(decomp)
        take = caps.mesh_axes if caps is not None else 1
        axis_names = names[:take]
    return decomp, tuple(axis_names)


def plan_dft(shape, direction: str, mesh: Mesh, *,
             decomp: Optional[str] = None,
             axis_names: Optional[Tuple[str, ...]] = None,
             backend: str = "auto", overlap_chunks: int = 0,
             real: bool = False, batch_ndim: int = 0,
             wire_dtype=None) -> FFTPlan:
    """``fftw_mpi_plan_dft_*`` equivalent: decomposition inference and a
    process-wide plan cache. Identical arguments return the SAME plan
    object."""
    if backend == MEASURE or decomp == MEASURE:
        raise NotImplementedError(
            "measured planning (FFTW_MEASURE) is ROADMAP queue 1 item 10")
    if real:
        raise NotImplementedError(
            "real (r2c/c2r) plans are ROADMAP queue 1 item 9")
    if wire_dtype is not None:
        raise NotImplementedError("wire_dtype is ROADMAP queue 1 item 12")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if direction not in (FORWARD, BACKWARD):
        raise ValueError(f"direction {direction!r} not in "
                         f"{(FORWARD, BACKWARD)}")
    shape = tuple(int(s) for s in shape)
    decomp, axis_names = _infer(shape, decomp, axis_names, mesh)
    overlap_chunks = int(overlap_chunks or 0)
    key = (shape, direction, _mesh_key(mesh), decomp, axis_names, backend,
           overlap_chunks, batch_ndim)
    with _LOCK:
        plan = _PLAN_CACHE.get(key)
        _STATS["hits" if plan is not None else "misses"] += 1
        if plan is None:
            plan = FFTPlan(shape, direction, mesh, decomp, axis_names,
                           backend, overlap_chunks, batch_ndim).compile()
            _PLAN_CACHE[key] = plan
    return plan


def plan_rfft(shape, direction: str, mesh: Mesh, **kw) -> FFTPlan:
    """Real-input plan (FFTW's ``plan_dft_r2c``/``c2r``)."""
    return plan_dft(shape, direction, mesh, real=True, **kw)
