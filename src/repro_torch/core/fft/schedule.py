"""Stage-schedule FFT engine on one device (counterpart of
``repro/core/fft/schedule.py``).

A decomposition is a ``Schedule``: a list of stages run in order by
``execute_schedule``. This slice holds the part a one-device mesh
needs: the ``LocalFFT`` and ``AllToAll`` stages and the two builders
``_infer`` picks on a one-axis mesh, ``slab_2d`` and ``slab_3d``. An
exchange over one shard moves nothing, so ``AllToAll`` is the identity
here. The other decompositions, exchanges over more than one shard
(``torch.distributed``), the twiddle/reorder stages and overlap
chunking are ROADMAP queue 1 item 8; the r2c/c2r builders are item 9;
wire codecs are item 12.

All stage axes are NEGATIVE (counted from the trailing transform
dims), so any leading dims are batch for free.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.compat import Mesh
from repro_torch.core.fft.dft import fft_along


# ---------------------------------------------------------------------------
# Stage IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalFFT:
    """1-D FFT along one (negative) local axis."""
    axis: int
    inverse: bool = False
    backend: str = "auto"

    def apply(self, state):
        re, im = state
        return fft_along(re, im, self.axis, inverse=self.inverse,
                         backend=self.backend)


@dataclasses.dataclass(frozen=True)
class AllToAll:
    """Tiled all_to_all over one mesh axis. With one shard it moves
    nothing: the identity."""
    axis_name: str
    split: int
    concat: int
    shards: int
    wire_dtype: Optional[str] = None
    wire_codec: Optional[str] = None

    def __post_init__(self):
        if self.shards != 1:
            raise NotImplementedError(
                f"all_to_all over {self.shards} shards needs "
                f"torch.distributed (ROADMAP queue 1 item 8)")
        if self.wire_dtype is not None or self.wire_codec is not None:
            raise NotImplementedError(
                "reduced-precision and compressed wire are ROADMAP queue 1 "
                "item 12")

    def apply(self, state):
        return state


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """A transform as data: stages + the sharding contract. ``in_spec``
    / ``out_spec`` are the PartitionSpec tails over the transform dims
    (mesh axis name or None); ``in_arity``/``out_arity`` count the
    arrays flowing in/out (2 = split (re, im) pair)."""
    name: str
    rank: int
    stages: Tuple
    in_spec: Tuple
    out_spec: Tuple
    in_arity: int = 2
    out_arity: int = 2


@dataclasses.dataclass(frozen=True)
class Caps:
    """Planner-visible capabilities of one decomposition's schedules."""
    rank: int
    mesh_axes: int
    overlap: bool = True
    wire: bool = True
    real: bool = False


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def execute_schedule(sched: Schedule, mesh: Mesh, *arrays,
                     overlap_chunks: int = 0):
    """Run a schedule's stages in order. Leading dims beyond
    ``sched.rank`` are batch."""
    if len(arrays) != sched.in_arity:
        raise ValueError(f"{sched.name}: expected {sched.in_arity} "
                         f"arrays, got {len(arrays)}")
    if arrays[0].dim() < sched.rank:
        raise ValueError(f"rank-{arrays[0].dim()} input for a "
                         f"rank-{sched.rank} transform")
    if int(overlap_chunks or 0) > 1:
        raise NotImplementedError(
            "overlap chunking pipelines an exchange; exchanges across "
            "devices are ROADMAP queue 1 item 8")
    state = tuple(arrays)
    for st in sched.stages:
        state = st.apply(state)
    return state if len(state) > 1 else state[0]


# ---------------------------------------------------------------------------
# Builders — complex (c2c) decompositions
# ---------------------------------------------------------------------------

def slab_2d(mesh: Mesh, axis_name: str = "data", *, inverse: bool = False,
            backend: str = "auto", wire_dtype=None) -> Schedule:
    """FFTW-MPI's slab: local FFT, one exchange, local FFT.
    forward P(ax, None) → P(None, ax); inverse mirrors."""
    pn = mesh.shape[axis_name]
    if inverse:
        stages = (LocalFFT(-2, True, backend),
                  AllToAll(axis_name, -2, -1, pn, wire_dtype),
                  LocalFFT(-1, True, backend))
        return Schedule("slab2d_inv", 2, stages,
                        (None, axis_name), (axis_name, None))
    stages = (LocalFFT(-1, False, backend),
              AllToAll(axis_name, -1, -2, pn, wire_dtype),
              LocalFFT(-2, False, backend))
    return Schedule("slab2d", 2, stages,
                    (axis_name, None), (None, axis_name))


def slab_3d(mesh: Mesh, axis_name: str = "data", *, inverse: bool = False,
            backend: str = "auto", wire_dtype=None) -> Schedule:
    """3-D slab on ONE mesh axis: three local passes, one exchange.
    forward P(ax, None, None) → P(None, ax, None); inverse mirrors."""
    pn = mesh.shape[axis_name]
    if inverse:
        stages = (LocalFFT(-3, True, backend),
                  AllToAll(axis_name, -3, -2, pn, wire_dtype),
                  LocalFFT(-2, True, backend),
                  LocalFFT(-1, True, backend))
        return Schedule("slab3d_inv", 3, stages,
                        (None, axis_name, None), (axis_name, None, None))
    stages = (LocalFFT(-1, False, backend),
              LocalFFT(-2, False, backend),
              AllToAll(axis_name, -2, -3, pn, wire_dtype),
              LocalFFT(-3, False, backend))
    return Schedule("slab3d", 3, stages,
                    (axis_name, None, None), (None, axis_name, None))


# ---------------------------------------------------------------------------
# Registry — what the planner picks from
# ---------------------------------------------------------------------------

CAPS = {
    "slab":       Caps(rank=2, mesh_axes=1, overlap=True, wire=True,
                       real=True),
    "slab3d":     Caps(rank=3, mesh_axes=1, overlap=True, wire=True,
                       real=True),
    "pencil":     Caps(rank=3, mesh_axes=2, overlap=True, wire=True,
                       real=True),
    "pencil_tf":  Caps(rank=3, mesh_axes=2, overlap=True, wire=True,
                       real=True),
    "pencil2d":   Caps(rank=2, mesh_axes=2, overlap=True, wire=True,
                       real=True),
    "fourstep1d": Caps(rank=1, mesh_axes=1, overlap=False, wire=True),
}

_BUILDERS = {
    "slab": slab_2d,
    "slab3d": slab_3d,
}


def build_schedule(decomp: str, shape: Tuple[int, ...], mesh: Mesh,
                   axis_names: Tuple[str, ...], *, inverse: bool = False,
                   backend: str = "auto", wire_dtype=None,
                   real: bool = False) -> Schedule:
    """One entry point from (decomp, knobs) to a runnable Schedule."""
    caps = CAPS.get(decomp)
    if caps is None:
        raise ValueError(f"unknown decomposition {decomp!r}; "
                         f"known: {sorted(CAPS)}")
    if len(shape) != caps.rank:
        raise ValueError(f"{decomp} transforms rank-{caps.rank} grids, "
                         f"got shape {shape}")
    if real:
        raise NotImplementedError(
            "r2c/c2r schedules are ROADMAP queue 1 item 9")
    build = _BUILDERS.get(decomp)
    if build is None:
        raise NotImplementedError(
            f"decomposition {decomp!r} is ROADMAP queue 1 item 8; "
            f"ported: {sorted(_BUILDERS)}")
    return build(mesh, axis_names[0], inverse=inverse, backend=backend,
                 wire_dtype=wire_dtype)
