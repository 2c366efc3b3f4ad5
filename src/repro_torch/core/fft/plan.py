"""FFTW-style plan lifecycle: cached and measured (counterpart of
``repro/core/fft/plan.py``).

An ``FFTPlan`` captures (grid shape, mesh, decomposition, direction,
backend, overlap chunking, real/complex, batch rank, wire dtype) and the
matching ``Schedule``; ``execute`` runs it on this rank's local blocks.
PyTorch runs eagerly, so ``compile`` only binds the schedule. ``place``
cuts a global array to this rank's input block (the plan's ``in_spec``),
and ``unplace`` gathers output blocks back to the global array
(``out_spec``). Three FFTW behaviours, as in the reference:

* **Plan cache.** ``plan_dft``/``plan_rfft`` keep a process-wide cache
  keyed by every field that changes the plan (the mesh's shape, process
  groups, device and hosts included): identical arguments return the
  SAME plan object. ``plan_cache_stats()`` has the reference's counters;
  ``plan_cache_clear()`` empties every cache a plan owns, the Bluestein
  tables on the devices (``kernels.fft_fourstep``) included, and
  ``plan_cache_evict(mesh)`` drops one mesh's entries.
* **FFTW_ESTIMATE.** ``backend="auto"`` picks without measuring: the
  hand-written kernels on CUDA tensors, their plain versions on CPU ones.
* **FFTW_MEASURE.** ``backend="measure"`` sweeps the schedule variants
  on first use and pins the fastest: backend × ``overlap_chunks`` ∈
  {0, 2, 4} (overlap-capable schedules) × wire ∈ {None, bfloat16} ∪ {the
  per-stage profile that casts only host-crossing exchanges, where the
  profile is mixed} ∪ {int8 and int8_block64 codec tuples on
  host-crossing exchanges, each held to ``wire_tol`` against the exact
  wire before it is timed, else skipped with reason
  ``"wire-error-budget"``}. The backends swept are the reference's
  ``["fourstep", "jnp"]`` (+ ``"stockham"`` when every axis is a power
  of two) on CPU tensors, and ``["pallas", "jnp"]`` on CUDA tensors:
  the plain ``fourstep``/``stockham`` are the kernels' test references
  and never run on the card's main path (the plain four-step's float32
  angles fail past 2^16). When ``"jnp"`` (cuFFT) wins, that is the
  sweep's measured and recorded choice. ``decomp="measure"`` races the
  decompositions that keep natural index order (slab vs pencil2d for
  2-D grids, pencil vs slab3d for 3-D). Candidates that fail to build or
  run are recorded (``autotune_skips()``), never dropped silently.
* **Wisdom.** With a store configured (``set_wisdom(path, mode)``, or
  ``REPRO_WISDOM_FILE``/``REPRO_WISDOM_MODE``), both sweeps read it
  through first (a hit times zero candidates) and write each newly
  agreed winner behind them (``wisdom.py``).

Across ranks, every rank of a mesh runs the same sweep: each candidate's
build and timing are agreed by an ``all_reduce(MIN)`` of an ok flag
(``_sweep_ok``), and the winner is the mesh's first rank's, sent by
``broadcast_object_list`` (``_agree_choice``) before anything is cached
or written, so every rank builds the same collectives. Agreement runs on
the mesh's own process group, scoped to the mesh's ranks as the
reference scopes it to the mesh's process span (reference
``plan.py:603-612``): a mesh over a subset of the world (a transit
consumer mesh) sweeps and agrees among its own ranks, and the ranks
outside it join nothing.

Real plans (``plan_rfft``, or ``real=True``) run the r2c/c2r schedules
of ``rfft.py``: forward ``execute(x)`` maps a real block to a
half-spectrum (re, im) block pair; backward maps it back to a real
block. Batched plans (``batch_ndim=k``) take ``k`` leading batch dims.

Locking: one re-entrant module lock (``_LOCK``) guards every module
structure; cache population is single-flight per key
(``_single_flight``): the first thread builds outside the lock, the
others wait for it (``thread_waits``), and a builder that raises lets
the next waiter build.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.compat import Mesh
from repro_torch.core.fft import distributed
from repro_torch.core.fft import rfft as rfft_mod
from repro_torch.core.fft import wire as wire_lib
from repro_torch.core.fft import wisdom as wisdom_mod
from repro_torch.core.fft.dft import BACKENDS, to_complex, to_pair
from repro_torch.core.fft.schedule import (CAPS, Schedule, build_schedule,
                                           exchange_topology,
                                           execute_schedule, overlap_site,
                                           wire_entry)
from repro_torch.kernels import fft_fourstep

FORWARD = "forward"
BACKWARD = "backward"

MEASURE = "measure"                   # backend/decomp sentinel: autotune

# decompositions the decomp="measure" sweep may substitute for each
# other: the same natural index order per rank (only the sharding the
# winner publishes differs). The cyclic/digit-permuted family
# (pencil_tf, fourstep1d) would change the layout the caller sees.
_SWEEP_DECOMPS = {2: ("slab", "pencil2d"), 3: ("pencil", "slab3d")}

_PLAN_CACHE: Dict[tuple, "FFTPlan"] = {}
_TUNE_CACHE: Dict[tuple, dict] = {}
_DECOMP_CACHE: Dict[tuple, str] = {}
_TUNE_SKIPS: List[dict] = []
_STATS = {"hits": 0, "misses": 0, "wire_profile_candidates": 0,
          "wire_codec_candidates": 0,
          "thread_waits": 0, "sweep_candidates_timed": 0,
          "wisdom_hits": 0, "wisdom_misses": 0, "wisdom_stale": 0}

# Compressed-wire candidate policy of the measured sweep (a test and
# bench hook, never part of a cache or wisdom key): "auto" makes codec
# candidates only on host-crossing exchanges, "always" treats every
# exchange as crossing, "never" makes none.
_WIRE_SWEEP_POLICY = "auto"

# Persistent wisdom: set_wisdom() wins; else the env contract, read once.
# It survives plan_cache_clear(): outliving cache resets is its point.
_WISDOM: Optional[wisdom_mod.WisdomStore] = None
_WISDOM_INIT = False

_LOCK = threading.RLock()
_PENDING: Dict[tuple, threading.Event] = {}


def _single_flight(cache_name: str, cache: dict, key, build):
    """``(value, was_cached)`` for ``cache[key]``, built at most once
    across threads. The builder runs outside ``_LOCK``; threads racing
    the same key wait on the builder's marker. A builder that raises
    clears its marker, so a waiter becomes the next builder."""
    while True:
        with _LOCK:
            if key in cache:
                return cache[key], True
            ev = _PENDING.get((cache_name, key))
            if ev is None:
                _PENDING[(cache_name, key)] = threading.Event()
                break
            _STATS["thread_waits"] += 1
        ev.wait()
    try:
        value = build()
    except BaseException:
        with _LOCK:
            _PENDING.pop((cache_name, key)).set()
        raise
    with _LOCK:
        cache[key] = value
        _PENDING.pop((cache_name, key)).set()
    return value, False


def _record_skip(entry: dict) -> None:
    with _LOCK:
        _TUNE_SKIPS.append(entry)


def _mesh_key(mesh: Mesh) -> tuple:
    # the axes' process groups tell apart meshes of one shape built over
    # different groups (each make_mesh of more than one rank makes its
    # own); the hosts make the key topology-aware, as the reference's
    # process indices do: a winner depends on which exchanges cross hosts
    groups = tuple(mesh.group(n).group_name for n in mesh.axis_names) \
        if mesh.axis_groups else ()
    return (tuple(mesh.shape.items()), str(mesh.device), groups,
            tuple(mesh.hosts), mesh.members)


def _wire_name(wire_dtype):
    """Hashable canonical wire spec: codec names verbatim, dtype names
    canonical (``schedule.wire_entry``), tuples per exchange."""
    if wire_dtype is None:
        return None
    if isinstance(wire_dtype, (tuple, list)):
        return tuple(wire_entry(w) for w in wire_dtype)
    return wire_entry(wire_dtype)


def _plan_key(shape, direction, mesh, decomp, axis_names, backend,
              overlap_chunks, real, batch_ndim, wire,
              measure_flag=None) -> tuple:
    return (shape, direction, _mesh_key(mesh), decomp, axis_names,
            backend, overlap_chunks, real, batch_ndim, wire, measure_flag)


def plan_cache_stats() -> Dict[str, int]:
    """Planner counters: ``hits``/``misses``/``size`` (plan cache),
    ``autotune_skipped`` (recorded sweep exclusions), ``decomp_sweeps``,
    ``wire_profile_candidates`` / ``wire_codec_candidates`` (per-stage
    wire tuples the knob sweep made), ``thread_waits`` (calls that
    waited on another thread's build of the same key),
    ``sweep_candidates_timed`` (zero on a wisdom-warm start) and
    ``wisdom_hits``/``wisdom_misses``/``wisdom_stale``."""
    with _LOCK:
        return dict(_STATS, size=len(_PLAN_CACHE),
                    autotune_skipped=len(_TUNE_SKIPS),
                    decomp_sweeps=len(_DECOMP_CACHE))


def autotune_skips() -> List[dict]:
    """Variants the measured sweeps could not build or run, each with
    the error that excluded it."""
    with _LOCK:
        return list(_TUNE_SKIPS)


def plan_cache_clear() -> None:
    """Empty every in-memory planner structure (the plan, tune and
    decomp caches, the skip record, every counter) and the Bluestein
    tables the kernels keep on the devices. The wisdom store is kept:
    the next measured plan warm-starts from it."""
    with _LOCK:
        _PLAN_CACHE.clear()
        _TUNE_CACHE.clear()
        _DECOMP_CACHE.clear()
        _TUNE_SKIPS.clear()
        for k in _STATS:
            _STATS[k] = 0
    fft_fourstep.clear_tables()


def plan_cache_evict(mesh: Mesh) -> int:
    """Drop every cached plan, knob winner and decomp winner keyed on
    ``mesh``; return how many went. Counters and wisdom stay."""
    mk = _mesh_key(mesh)
    evicted = 0
    with _LOCK:
        # all three caches key as (shape, direction, mesh_key, ...)
        for cache in (_PLAN_CACHE, _TUNE_CACHE, _DECOMP_CACHE):
            doomed = [k for k in cache if k[2] == mk]
            for k in doomed:
                del cache[k]
            evicted += len(doomed)
    return evicted


def set_wire_sweep_policy(policy: str) -> str:
    """Set the compressed-wire candidate policy (``auto`` / ``always`` /
    ``never``) and return the previous one. ``always`` lets one-host
    tests drive the codec candidates and the error-budget gate."""
    global _WIRE_SWEEP_POLICY
    if policy not in ("auto", "always", "never"):
        raise ValueError(f"wire sweep policy {policy!r} not in "
                         f"auto/always/never")
    with _LOCK:
        prev, _WIRE_SWEEP_POLICY = _WIRE_SWEEP_POLICY, policy
    return prev


def set_wisdom(path, mode: str = "readwrite"):
    """Configure persistent wisdom for this process: ``path`` names the
    store file, ``mode`` is ``off|read|readwrite``; ``set_wisdom(None)``
    (or ``mode="off"``) turns it off. Overrides the env contract. Returns
    the active store (or None)."""
    global _WISDOM, _WISDOM_INIT
    store = None
    if path is not None and mode != "off":
        store = wisdom_mod.WisdomStore(path, mode=mode)
    with _LOCK:
        _WISDOM, _WISDOM_INIT = store, True
    return store


def wisdom_store() -> Optional[wisdom_mod.WisdomStore]:
    """The active wisdom store: ``set_wisdom``'s, or (read once) the env
    contract's; None means wisdom is off."""
    global _WISDOM, _WISDOM_INIT
    with _LOCK:
        if not _WISDOM_INIT:
            _WISDOM = wisdom_mod.store_from_env()
            _WISDOM_INIT = True
        return _WISDOM


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
    real: bool = False                # r2c (fwd) / c2r (bwd) half-spectrum
    batch_ndim: int = 0               # extra leading batch dims at execute
    wire_dtype: Optional[object] = None  # name or per-stage name tuple
    _fn: Optional[Callable] = None
    _sched: Optional[Schedule] = None

    def schedule(self) -> Schedule:
        """The stage schedule this plan runs (built lazily)."""
        if self._sched is None:
            self._sched = build_schedule(
                self.decomp, self.shape, self.mesh, self.axis_names,
                inverse=self.direction == BACKWARD, backend=self.backend,
                wire_dtype=self.wire_dtype, real=self.real)
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

    def in_shape(self) -> Tuple[int, ...]:
        """The global grid the plan takes: the half-spectrum (last dim at
        the decomposition's padded half extent) for a real backward
        plan, else ``shape``."""
        if self.real and self.direction == BACKWARD:
            return self.shape[:-1] + (rfft_mod.spectral_half_extent(
                self.decomp, self.shape[-1], self.mesh, self.axis_names),)
        return tuple(self.shape)

    def place(self, x):
        """This rank's block of the global array ``x`` (numpy or torch)
        under the plan's input spec, on the mesh's device: the real field
        alone, ``(x,)``, for a real forward plan, else a split (re, im)
        pair."""
        spec = self._spec(self.schedule().in_spec)
        if self.real and self.direction == FORWARD:
            x = torch.as_tensor(x).float()
            return (distributed.shard(x, self.mesh, spec),)
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
                     for n, entry in zip(self.in_shape(),
                                         self.schedule().in_spec))

    def execute(self, *arrays):
        """Run the transform on this rank's blocks: complex plans and
        real backward take ``execute(re, im)``, real forward
        ``execute(x)``; real backward returns the real block alone. A
        block of another shape (the whole grid on a mesh of several
        ranks, say) raises."""
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
        out = self.execute(*self.place(x))
        return to_complex(out) if isinstance(out, tuple) else out


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
             wire_dtype=None, allow_reduced_wire: bool = True,
             wire_tol: float = 1e-2) -> FFTPlan:
    """``fftw_mpi_plan_dft_*`` equivalent: decomposition inference, a
    process-wide plan cache, and ``"measure"`` autotuning (of the
    backend and knobs, and/or of the decomposition). Identical arguments
    return the SAME plan object. ``wire_tol`` is the measured sweep's
    error budget for compressed-wire candidates (max relative error
    against the exact wire)."""
    if backend not in BACKENDS and backend != MEASURE:
        raise ValueError(f"backend {backend!r} not in "
                         f"{BACKENDS + (MEASURE,)}")
    if direction not in (FORWARD, BACKWARD):
        raise ValueError(f"direction {direction!r} not in "
                         f"{(FORWARD, BACKWARD)}")
    shape = tuple(int(s) for s in shape)
    wire_tol = float(wire_tol)
    overlap_chunks = int(overlap_chunks or 0)
    if decomp == MEASURE:
        axis_names = tuple(axis_names) if axis_names is not None else None
        decomp = _autotune_decomp(shape, direction, mesh, backend=backend,
                                  overlap_chunks=overlap_chunks,
                                  wire_dtype=wire_dtype,
                                  real=real, batch_ndim=batch_ndim,
                                  allow_reduced_wire=allow_reduced_wire,
                                  axis_names=axis_names,
                                  wire_tol=wire_tol)
        if axis_names is not None and decomp in CAPS:
            # the sweep raced each candidate over the prefix of the
            # caller's axes it needs; build the winner the same way
            axis_names = axis_names[: CAPS[decomp].mesh_axes]
    decomp, axis_names = _infer(shape, decomp, axis_names, mesh)
    wire = _wire_name(wire_dtype)

    key = _plan_key(shape, direction, mesh, decomp, axis_names, backend,
                    overlap_chunks, real, batch_ndim, wire,
                    (allow_reduced_wire, wire_tol)
                    if backend == MEASURE else None)

    def _build() -> FFTPlan:
        if backend == MEASURE:
            tuned = _autotune(shape, direction, mesh, decomp, axis_names,
                              real=real, batch_ndim=batch_ndim,
                              allow_reduced_wire=allow_reduced_wire,
                              wire_tol=wire_tol)
            return plan_dft(shape, direction, mesh, decomp=decomp,
                            axis_names=axis_names, real=real,
                            batch_ndim=batch_ndim, **tuned)
        return FFTPlan(shape, direction, mesh, decomp, axis_names,
                       backend, overlap_chunks, real, batch_ndim,
                       wire).compile()

    plan, cached = _single_flight("plan", _PLAN_CACHE, key, _build)
    with _LOCK:
        _STATS["hits" if cached else "misses"] += 1
    return plan


def plan_rfft(shape, direction: str, mesh: Mesh, **kw) -> FFTPlan:
    """Real-input plan (FFTW's ``plan_dft_r2c``/``c2r``): forward maps a
    real field to its Hermitian half-spectrum, backward inverts it."""
    return plan_dft(shape, direction, mesh, real=True, **kw)


# ---------------------------------------------------------------------------
# FFTW_MEASURE-style autotuner: cluster agreement
# ---------------------------------------------------------------------------

def _pow2(n: int) -> bool:
    return n & (n - 1) == 0


def _sweep_ok(ok: bool, mesh: Mesh) -> bool:
    """True only when EVERY rank of the mesh reports ``ok``: an
    ``all_reduce(MIN)`` of an int flag. The sweeps call it around each
    timed candidate, so a candidate failing on one rank only cannot send
    that rank on to the next candidate's exchanges while the others sit
    in this one's. A one-rank mesh passes ``ok`` through."""
    if mesh.size <= 1:
        return ok
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32,
                        device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.mesh_group)
    return bool(flag.item() == 1)


def _broadcast(obj, mesh: Mesh):
    """The mesh's first rank's ``obj`` on every rank (a one-rank mesh
    keeps its own)."""
    if mesh.size <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.first_rank,
                               group=mesh.mesh_group)
    return box[0]


def _agree_choice(options: list, choice, mesh: Mesh):
    """Cluster agreement for the measured sweeps: timings are per rank,
    so noise (or a failure on one rank) could hand ranks different
    winners, which would build different collectives and deadlock the
    next ``execute``. The first rank's pick wins everywhere: its index
    into ``options`` (made from shapes, the same on every rank) is
    broadcast before anything is cached."""
    return options[_broadcast(options.index(choice), mesh)]


# ---------------------------------------------------------------------------
# Persistent wisdom read-through (core/fft/wisdom.py)
# ---------------------------------------------------------------------------

_WISDOM_BACKENDS = {"auto", "jnp", "fourstep", "stockham", "pallas"}


def _tune_from_wisdom(value):
    """Validate and normalise a recorded knob dict; anything off (or
    naming a backend or wire this build does not have) is STALE wisdom
    and returns None, so the caller measures."""
    if not isinstance(value, dict):
        return None
    try:
        backend = value["backend"]
        overlap = int(value["overlap_chunks"])
        wire = value["wire_dtype"]
    except (KeyError, TypeError, ValueError):
        return None
    if backend not in _WISDOM_BACKENDS or overlap < 0:
        return None

    def _wire_ok(w) -> bool:
        try:
            wire_entry(w)
            return True
        except TypeError:
            return False

    if isinstance(wire, (list, tuple)):
        wire = tuple(None if w is None else str(w) for w in wire)
        if not all(_wire_ok(w) for w in wire):
            return None
    elif wire is not None and (not isinstance(wire, str)
                               or not _wire_ok(wire)):
        return None
    return {"backend": backend, "overlap_chunks": overlap,
            "wire_dtype": wire}


def _wisdom_sweep_hit(kind: str, key: str, mesh: Mesh, decode):
    """An agreed, validated wisdom hit for this sweep, or None (measure).
    The hit is all-or-nothing across the mesh's ranks (``_sweep_ok``), and
    the first rank's recorded value is broadcast and used everywhere, so
    per-host files that drifted cannot build different collectives.
    Invalid recorded values are booked stale and fall through."""
    store = wisdom_store()
    if store is None:
        return None
    raw = store.lookup(kind, key)
    value = decode(raw) if raw is not None else None
    if raw is not None and value is None:
        store.count_stale()
        with _LOCK:
            _STATS["wisdom_stale"] += 1
    if mesh.size > 1:
        if not _sweep_ok(value is not None, mesh):
            value = None
        else:
            agreed = _broadcast(value, mesh)
            value = decode(agreed) if agreed is not None else None
    with _LOCK:
        _STATS["wisdom_hits" if value is not None else
               "wisdom_misses"] += 1
    return value


def _wisdom_record(kind: str, key: str, value) -> None:
    """Persist a freshly AGREED winner (identical on every rank)."""
    store = wisdom_store()
    if store is not None:
        store.record(kind, key, value)


# ---------------------------------------------------------------------------
# Timing and the error-budget oracle
# ---------------------------------------------------------------------------

def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _time_plan(plan: FFTPlan, args, iters: int = 3) -> float:
    """Seconds a call of ``plan`` on ``args``, host clock after a warm-up
    call, each timing ending in ``torch.cuda.synchronize()`` on a CUDA
    mesh."""
    with _LOCK:
        # the warm-start signal: a wisdom-warm bring-up times ZERO
        _STATS["sweep_candidates_timed"] += 1
    plan.execute(*args)
    _sync(plan.mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        plan.execute(*args)
    _sync(plan.mesh)
    return (time.perf_counter() - t0) / iters


def _dummy_args(shape, direction, mesh, decomp, axis_names, real,
                batch_ndim):
    """Zero blocks of this rank's input under the plan's spec: the real
    block alone for a real forward plan, else a pair (a real backward
    plan takes the half-spectrum, at the decomposition's extent)."""
    probe = FFTPlan(shape, direction, mesh, decomp, axis_names,
                    real=real, batch_ndim=batch_ndim)
    block = (2,) * batch_ndim + probe.block_shape()
    zero = torch.zeros(block, dtype=torch.float32, device=mesh.device)
    if real and direction == FORWARD:
        return (zero,)
    return (zero, zero)


def _oracle_args(shape, direction, mesh, decomp, axis_names, real,
                 batch_ndim):
    """Deterministic NON-zero sweep input for the wire error budget
    (every codec is exact on zeros): each rank's block holds a fixed
    sum of cosines of the GLOBAL indices, so every rank's input is the
    same on every run."""
    probe = FFTPlan(shape, direction, mesh, decomp, axis_names,
                    real=real, batch_ndim=batch_ndim)
    full = (2,) * batch_ndim + probe.in_shape()
    spec = probe._spec(probe.schedule().in_spec)
    cut = distributed._slices(mesh, spec, full, mesh.coordinate)
    args = _dummy_args(shape, direction, mesh, decomp, axis_names, real,
                       batch_ndim)
    nd = len(full)
    out = []
    for seed, z in enumerate(args):
        fill = torch.zeros_like(z)
        for d, sl in enumerate(cut):
            start = sl.start or 0
            idx = torch.arange(start, start + z.shape[d], dtype=torch.float32,
                               device=z.device)
            view = [1] * nd
            view[d] = z.shape[d]
            fill = fill + torch.cos((0.37 + 0.11 * seed) * (d + 1)
                                    * idx.reshape(view) + 0.1)
        out.append(fill)
    return tuple(out)


def _max_rel_err(got, want, mesh: Mesh) -> float:
    """max |got - want| / max |want| over the (re, im) pair and over the
    mesh's ranks (an all-reduce of the two maxima), the same scalar on
    every rank, so budget decisions never diverge."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    num = max(float((g - w).abs().max()) for g, w in zip(got, want))
    den = max(float(w.abs().max()) for w in want)
    if mesh.size > 1:
        both = torch.tensor([num, den], dtype=torch.float64,
                            device=mesh.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.mesh_group)
        num, den = float(both[0]), float(both[1])
    return num / max(den, 1e-30)


# ---------------------------------------------------------------------------
# The sweep space
# ---------------------------------------------------------------------------

def _wire_codec_variant(wire_dtype) -> bool:
    """True when a wire spec carries a compressed codec entry (the
    candidates the error-budget gate must vet)."""
    entries = wire_dtype if isinstance(wire_dtype, tuple) else (wire_dtype,)
    return any(wire_lib.is_codec(w) for w in entries)


def _wire_codec_candidates(shape, direction, mesh, decomp, axis_names,
                           real):
    """Compressed-wire candidates: one per-stage tuple per stock int8
    codec, compressing ONLY the host-crossing exchanges (``always``
    counts every exchange as crossing). Made from the mesh's placement
    only, so the same on every rank."""
    if _WIRE_SWEEP_POLICY == "never":
        return []
    sched = build_schedule(decomp, shape, mesh, axis_names,
                           inverse=direction == BACKWARD, real=real)
    flags = [bool(t["crosses_hosts"]) for t in exchange_topology(sched)]
    if _WIRE_SWEEP_POLICY == "always":
        flags = [True] * len(flags)
    if not any(flags):
        return []
    return [tuple(codec if f else None for f in flags)
            for codec in ("int8", f"int8_block{wire_lib.DEFAULT_BLOCK}")]


def _wire_profile_candidate(shape, direction, mesh, decomp, axis_names,
                            real):
    """The per-stage wire tuple that casts ONLY the host-crossing
    exchanges to bfloat16, when the schedule's profile is mixed; else the
    reason it would duplicate a uniform candidate (a string)."""
    sched = build_schedule(decomp, shape, mesh, axis_names,
                           inverse=direction == BACKWARD, real=real)
    flags = [bool(t["crosses_hosts"]) for t in exchange_topology(sched)]
    if len(flags) < 2:
        return (f"per-stage wire needs >=2 exchanges to differ from "
                f"uniform wire ({decomp} has {len(flags)})")
    if not any(flags):
        return ("no cross-host exchange on this topology; the "
                "per-stage candidate would duplicate the uniform "
                "candidates")
    if all(flags):
        return ("every exchange crosses hosts; the per-stage candidate "
                "would duplicate the uniform bfloat16 candidate")
    return tuple("bfloat16" if f else None for f in flags)


def _sweep_backends(shape, mesh: Mesh) -> List[str]:
    """The local-FFT backends the knob sweep times: on CUDA the
    hand-written kernels and torch.fft; on the CPU the reference's list
    (the plain four-step, torch.fft, and Stockham when every axis is a
    power of two)."""
    if mesh.device.type == "cuda":
        return ["pallas", "jnp"]
    backends = ["fourstep", "jnp"]
    if all(_pow2(s) for s in shape):
        backends.append("stockham")
    return backends


def _schedule_variants(shape, decomp, *, allow_reduced_wire,
                       direction=FORWARD, mesh=None, axis_names=None,
                       real=False, record_skip=None) -> List[dict]:
    """The sweep space: every (backend, overlap_chunks, wire_dtype) the
    decomposition's schedules might take (``schedule.CAPS``). Ineligible
    combinations are found by trying them and recorded in
    ``autotune_skips()``. The per-stage bfloat16 profile joins where the
    exchanges' host-crossing profile is mixed (else its reason goes to
    ``record_skip``); the codec tuples join at ``overlap_chunks=0``
    only (chunking does not change wire bytes, and would change the
    blocks the budget checks)."""
    caps = CAPS[decomp]
    backends = (_sweep_backends(shape, mesh) if mesh is not None
                else ["fourstep", "jnp"])
    overlaps = [0, 2, 4] if caps.overlap else [0]
    wires = [None]
    codec_wires = []
    if allow_reduced_wire and caps.wire:
        wires.append("bfloat16")
        if mesh is not None:
            try:
                prof = _wire_profile_candidate(shape, direction, mesh,
                                               decomp, axis_names, real)
            except Exception as e:  # noqa: BLE001 — schedule unbuildable
                prof = f"{type(e).__name__}: {e}"
            if isinstance(prof, tuple):
                wires.append(prof)
                with _LOCK:
                    _STATS["wire_profile_candidates"] += 1
            elif record_skip is not None:
                record_skip(prof)
            try:
                codec_wires = _wire_codec_candidates(
                    shape, direction, mesh, decomp, axis_names, real)
            except Exception:  # noqa: BLE001 — schedule unbuildable
                codec_wires = []
            with _LOCK:
                _STATS["wire_codec_candidates"] += len(codec_wires)
    variants = [{"backend": be, "overlap_chunks": ov, "wire_dtype": wr}
                for be in backends for ov in overlaps for wr in wires]
    variants.extend({"backend": be, "overlap_chunks": 0, "wire_dtype": wr}
                    for be in backends for wr in codec_wires)
    return variants


# ---------------------------------------------------------------------------
# The sweeps
# ---------------------------------------------------------------------------

def _autotune_decomp(shape, direction, mesh, *, backend, overlap_chunks,
                     wire_dtype, real, batch_ndim,
                     allow_reduced_wire, axis_names=None,
                     wire_tol: float = 1e-2) -> str:
    """``decomp="measure"``: time every layout-compatible decomposition
    for this (grid, mesh topology, knobs) and return the fastest, agreed
    across the mesh's ranks and cached per ``_mesh_key``. Candidates run
    under the caller's knobs, or knob-tuned first with
    ``backend="measure"``; each races over the prefix of the caller's
    axes it needs. Failed candidates land in ``autotune_skips()``."""
    rank = len(shape)
    candidates = _SWEEP_DECOMPS.get(rank)
    if candidates is None:
        # rank 1 has only the cyclic-layout four-step; nothing to sweep
        return _infer(shape, None, None, mesh)[0]
    dkey = (shape, direction, _mesh_key(mesh), axis_names, real,
            batch_ndim, backend, overlap_chunks, _wire_name(wire_dtype),
            allow_reduced_wire, float(wire_tol))

    def _sweep() -> str:
        fallback = _infer(shape, None, None, mesh)[0]
        wkey = wisdom_mod.wisdom_key(
            "decomp", mesh, shape=shape, direction=direction,
            axis_names=axis_names, real=real, batch_ndim=batch_ndim,
            backend=backend, overlap_chunks=overlap_chunks,
            wire_dtype=_wire_name(wire_dtype),
            allow_reduced_wire=allow_reduced_wire,
            wire_tol=float(wire_tol))

        def _decode(value):
            # a recorded decomp must still be a legal substitution here
            if isinstance(value, str) and (value in candidates
                                           or value == fallback):
                return value
            return None

        hit = _wisdom_sweep_hit("decomp", wkey, mesh, _decode)
        if hit is not None:
            return hit
        best, best_t = None, float("inf")
        for decomp in candidates:
            caps = CAPS[decomp]

            def skip(err):
                _record_skip({
                    "shape": shape, "direction": direction,
                    "decomp": decomp, "real": real,
                    "batch_ndim": batch_ndim, "backend": backend,
                    "sweep": "decomp", "error": err})

            cand, args, err, t = None, None, None, None
            try:  # build phase: no candidate collective runs yet
                if caps.mesh_axes > len(mesh.axis_names):
                    raise ValueError(
                        f"{decomp} needs {caps.mesh_axes} mesh axes, "
                        f"mesh has {len(mesh.axis_names)}")
                if real and not caps.real:
                    raise ValueError(f"{decomp} has no r2c/c2r schedules")
                cand_axes = tuple(axis_names if axis_names is not None
                                  else mesh.axis_names)[: caps.mesh_axes]
                if backend == MEASURE:
                    tuned = _autotune(
                        shape, direction, mesh, decomp, cand_axes,
                        real=real, batch_ndim=batch_ndim,
                        allow_reduced_wire=allow_reduced_wire,
                        wire_tol=wire_tol)
                else:
                    tuned = {"backend": backend,
                             "overlap_chunks": overlap_chunks,
                             "wire_dtype": wire_dtype}
                cand = FFTPlan(shape, direction, mesh, decomp, cand_axes,
                               tuned["backend"], tuned["overlap_chunks"],
                               real, batch_ndim,
                               _wire_name(tuned["wire_dtype"])).compile()
                args = _dummy_args(shape, direction, mesh, decomp,
                                   cand_axes, real, batch_ndim)
            except Exception as e:  # noqa: BLE001 — candidate unsupported
                err = f"{type(e).__name__}: {e}"
            # every rank must agree the candidate built before ANY of
            # them enters its timed collectives, and that timing
            # succeeded everywhere after
            if not _sweep_ok(err is None, mesh):
                skip(err or "candidate failed on another rank")
                continue
            try:
                t = _time_plan(cand, args)
            except Exception as e:  # noqa: BLE001 — candidate unsupported
                err = f"{type(e).__name__}: {e}"
            if not _sweep_ok(err is None, mesh):
                skip(err or "timing failed on another rank")
                continue
            if t < best_t:
                best, best_t = decomp, t
        if best is None:
            best = fallback
        agreed = _agree_choice([*candidates, fallback], best, mesh)
        _wisdom_record("decomp", wkey, agreed)
        return agreed

    best, _ = _single_flight("decomp", _DECOMP_CACHE, dkey, _sweep)
    return best


def _autotune(shape, direction, mesh, decomp, axis_names, *, real,
              batch_ndim, allow_reduced_wire,
              wire_tol: float = 1e-2) -> dict:
    """Sweep the schedule variants and return the fastest knob setting,
    agreed across the mesh's ranks and cached per (shape, mesh, decomp,
    direction, real, batch). A compressed-wire candidate must first come
    within ``wire_tol`` (max relative error) of the exact-wire oracle on
    a deterministic non-zero input (``_oracle_args``), else it is skipped
    with reason ``"wire-error-budget"``: a lossy wire may win on speed,
    never on accuracy it does not have."""
    tkey = (shape, direction, _mesh_key(mesh), decomp, axis_names, real,
            batch_ndim, allow_reduced_wire, float(wire_tol))

    def _sweep() -> dict:
        fallback = {"backend": "auto", "overlap_chunks": 0,
                    "wire_dtype": None}
        wkey = wisdom_mod.wisdom_key(
            "tune", mesh, shape=shape, direction=direction,
            decomp=decomp, axis_names=axis_names, real=real,
            batch_ndim=batch_ndim, allow_reduced_wire=allow_reduced_wire,
            wire_tol=float(wire_tol))
        hit = _wisdom_sweep_hit("tune", wkey, mesh, _tune_from_wisdom)
        if hit is not None:
            return hit
        base = {"shape": shape, "direction": direction, "decomp": decomp,
                "real": real, "batch_ndim": batch_ndim}
        err = None
        try:
            args = _dummy_args(shape, direction, mesh, decomp,
                               axis_names, real, batch_ndim)
        except Exception as e:  # noqa: BLE001 — per-rank input failure
            err = f"{type(e).__name__}: {e}"
        # agreed BEFORE the variant loop, so a rank whose input failed
        # does not leave while its peers run per-variant collectives
        if not _sweep_ok(err is None, mesh):
            _record_skip({**base, "sweep": "knobs",
                          "error": err or "dummy input failed on another "
                                          "rank"})
            return fallback

        def _record_wire_skip(reason):
            _record_skip({**base, "sweep": "wire-profile",
                          "wire_dtype": "per-stage", "error": reason})

        variants = _schedule_variants(
            shape, decomp, allow_reduced_wire=allow_reduced_wire,
            direction=direction, mesh=mesh, axis_names=axis_names,
            real=real, record_skip=_record_wire_skip)
        # the exact-wire reference output on a non-zero input, built at
        # the first codec candidate that builds; every gate below is
        # agreed, so every rank builds (or fails) it at the same point
        oracle = {"tried": False, "args": None, "want": None}

        def _oracle_ready() -> bool:
            if not oracle["tried"]:
                oracle["tried"] = True
                oerr = None
                try:
                    oracle["args"] = _oracle_args(
                        shape, direction, mesh, decomp, axis_names,
                        real, batch_ndim)
                    ref = FFTPlan(shape, direction, mesh, decomp,
                                  axis_names, real=real,
                                  batch_ndim=batch_ndim).compile()
                    oracle["want"] = ref.execute(*oracle["args"])
                    _sync(mesh)
                except Exception as e:  # noqa: BLE001 — per-rank
                    oerr = f"{type(e).__name__}: {e}"
                if not _sweep_ok(oerr is None, mesh):
                    oracle["want"] = None
            return oracle["want"] is not None

        best, best_t, best_plan = None, float("inf"), None
        for variant in variants:
            cand = FFTPlan(shape, direction, mesh, decomp, axis_names,
                           variant["backend"], variant["overlap_chunks"],
                           real, batch_ndim, variant["wire_dtype"])
            err, t = None, None
            try:  # build phase: schedule and overlap checks, no collective
                cand.compile()
            except Exception as e:  # noqa: BLE001 — variant unsupported
                err = f"{type(e).__name__}: {e}"
            if not _sweep_ok(err is None, mesh):
                _record_skip({**base, **variant,
                              "error": err or "variant failed on another "
                                              "rank"})
                continue
            if _wire_codec_variant(variant["wire_dtype"]):
                if not _oracle_ready():
                    _record_skip({**base, **variant,
                                  "error": "wire-oracle-unavailable"})
                    continue
                rel = None
                try:
                    rel = _max_rel_err(cand.execute(*oracle["args"]),
                                       oracle["want"], mesh)
                except Exception as e:  # noqa: BLE001 — cand collective
                    err = f"{type(e).__name__}: {e}"
                if not _sweep_ok(err is None, mesh):
                    _record_skip({**base, **variant,
                                  "error": err or "wire oracle failed on "
                                                  "another rank"})
                    continue
                # rel is reduced over the mesh: the same on every rank
                if rel > wire_tol:
                    _record_skip({**base, **variant,
                                  "error": "wire-error-budget",
                                  "max_rel_err": rel, "wire_tol": wire_tol})
                    continue
            try:
                t = _time_plan(cand, args)
            except Exception as e:  # noqa: BLE001 — variant unsupported
                err = f"{type(e).__name__}: {e}"
            if not _sweep_ok(err is None, mesh):
                _record_skip({**base, **variant,
                              "error": err or "timing failed on another "
                                              "rank"})
                continue
            if t < best_t:
                best, best_t, best_plan = dict(variant), t, cand
        if best is None:
            best, best_plan = fallback, None
        agreed = _agree_choice([*variants, fallback], best, mesh)
        _wisdom_record("tune", wkey, agreed)
        if agreed == best and best_plan is not None:
            # the winner is built and warm: seed the plan cache with it
            with _LOCK:
                _PLAN_CACHE.setdefault(
                    _plan_key(shape, direction, mesh, decomp, axis_names,
                              best["backend"], best["overlap_chunks"],
                              real, batch_ndim,
                              _wire_name(best["wire_dtype"])),
                    best_plan)
        return agreed

    agreed, _ = _single_flight("tune", _TUNE_CACHE, tkey, _sweep)
    return agreed

