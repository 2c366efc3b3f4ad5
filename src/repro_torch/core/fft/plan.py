"""FFTW-style plan lifecycle on one device (counterpart of
``repro/core/fft/plan.py``).

An ``FFTPlan`` captures (grid shape, mesh, decomposition, direction,
backend, batch rank) and the matching ``Schedule``; ``execute`` runs it
on tensors. PyTorch runs eagerly, so ``compile`` only binds the
schedule. ``plan_dft`` keeps the reference's process-wide plan cache:
identical arguments return the SAME plan object, and
``plan_cache_stats()`` counts hits and misses.

Not in this slice, each raising ``NotImplementedError`` that names its
ROADMAP queue 1 item: ``backend="measure"`` / ``decomp="measure"``
autotuning (item 10), persistent wisdom (item 13), ``real=True``
half-spectrum plans (item 9), ``wire_dtype`` (item 12), and
``overlap_chunks`` (item 8).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

from repro_torch.compat import Mesh
from repro_torch.core.fft.dft import BACKENDS, to_complex, to_pair
from repro_torch.core.fft.schedule import (CAPS, Schedule, build_schedule,
                                           execute_schedule)

FORWARD = "forward"
BACKWARD = "backward"

MEASURE = "measure"                   # backend/decomp sentinel: autotune

_PLAN_CACHE: Dict[tuple, "FFTPlan"] = {}
_STATS = {"hits": 0, "misses": 0}
_LOCK = threading.Lock()


def _mesh_key(mesh: Mesh) -> tuple:
    return tuple(mesh.shape.items()), str(mesh.device)


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

    def compile(self) -> "FFTPlan":
        """Bind the schedule (there is nothing to trace: eager PyTorch)."""
        sched, mesh = self.schedule(), self.mesh

        def fn(*arrays):
            return execute_schedule(sched, mesh, *arrays)

        self._fn = fn
        return self

    def place(self, x):
        """Move onto the plan's device as a split (re, im) pair."""
        return to_pair(x, device=self.mesh.device)

    def execute(self, *arrays):
        """Run the transform: ``execute(re, im)`` → (re, im)."""
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
    if overlap_chunks and overlap_chunks > 1:
        raise NotImplementedError(
            "overlap_chunks is ROADMAP queue 1 item 8")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if direction not in (FORWARD, BACKWARD):
        raise ValueError(f"direction {direction!r} not in "
                         f"{(FORWARD, BACKWARD)}")
    shape = tuple(int(s) for s in shape)
    decomp, axis_names = _infer(shape, decomp, axis_names, mesh)
    key = (shape, direction, _mesh_key(mesh), decomp, axis_names, backend,
           batch_ndim)
    with _LOCK:
        plan = _PLAN_CACHE.get(key)
        _STATS["hits" if plan is not None else "misses"] += 1
        if plan is None:
            plan = _PLAN_CACHE[key] = FFTPlan(
                shape, direction, mesh, decomp, axis_names, backend,
                batch_ndim).compile()
    return plan


def plan_rfft(shape, direction: str, mesh: Mesh, **kw) -> FFTPlan:
    """Real-input plan (FFTW's ``plan_dft_r2c``/``c2r``)."""
    return plan_dft(shape, direction, mesh, real=True, **kw)
