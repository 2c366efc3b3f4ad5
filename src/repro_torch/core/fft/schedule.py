"""Stage-schedule FFT engine: distributed FFTs as data (counterpart of
``repro/core/fft/schedule.py``).

A decomposition is a ``Schedule``: a list of stages plus the
input/output PartitionSpec tails, run by ONE generic
``execute_schedule``. The reference runs it inside ``shard_map``; here
it is the per-rank function itself, taking and returning this rank's
local blocks. The stage IR:

* ``LocalFFT(axis, inverse, backend)`` — 1-D FFT along one local axis;
* ``LocalRFFT(pad_to)`` / ``LocalIRFFT(n, half)`` — the real (r2c /
  c2r) endcaps along the last axis, through ``torch.fft.rfft``/``irfft``
  where the reference calls ``jnp.fft``; the half-spectrum is zero-padded
  to ``pad_to`` (a multiple of the shard counts that split it) for the
  tiled exchange;
* ``AllToAll(axis_name, split, concat, shards, wire_dtype,
  crosses_hosts, wire_codec)`` — the tiled exchange of
  ``jax.lax.all_to_all(tiled=True)``: the ``split`` axis is cut into P
  chunks, chunk j goes to the axis's rank j, and what arrives is
  concatenated along ``concat`` in source-rank order, through
  ``torch.distributed.all_to_all_single`` on the mesh axis's group.
  ``wire_dtype`` (``"bfloat16"``, ...) casts the payload for the wire;
  ``wire_codec`` (a ``wire.py`` codec name) encodes it and moves the
  encoded parts packed into ONE byte buffer. A reduced or encoded wire
  always moves as ``uint8`` bytes, whatever dtypes the backend takes
  (gloo refuses ``int16``; the collectives of other backends differ).
  ``crosses_hosts`` is metadata (``annotate_topology``);
* ``Twiddle(axis, axis_name, shards, sign)`` — the four-step inter-shard
  twiddle exp(sign·2πi·p·k/N), p = this rank's coordinate on the axis;
* ``Reorder(op, axis, parts)`` — local index reorders (``expand``,
  ``merge``, ``fold_T``, ``unfold_T``).

Builders: ``slab_2d``, ``slab_3d``, ``pencil_3d``, ``pencil_tf_3d``,
``pencil_2d`` and ``fourstep_1d``; the r2c/c2r builders live in
``rfft.py`` and ``build_schedule(real=True)`` dispatches to them. A wire
spec is one name for every exchange or a tuple with one entry per
exchange (``_wire_tuple``). ``overlap_chunks > 1`` pipelines the first
exchange against the local stages before it, chunk by chunk, with a
bit-identical result; a real endcap before the exchange owns the last
axis, so that axis cannot be the chunk axis.

All stage axes are NEGATIVE (counted from the trailing transform dims),
so any leading dims are batch for free.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.compat import Mesh, axis_crosses_processes
from repro_torch.core.fft import wire as wire_mod
from repro_torch.core.fft.dft import cmul, fft_along
from repro_torch.sharding import collectives as C

# A wire spec entry is a dtype NAME ("bfloat16"), a wire CODEC name
# ("int8", "int8_block64", "bf16"; see wire.py), or None (exact).
WireSpec = Union[None, str, Tuple[Optional[str], ...]]


# ---------------------------------------------------------------------------
# Stage IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalFFT:
    """1-D FFT along one (negative) local axis."""
    axis: int
    inverse: bool = False
    backend: str = "auto"

    def apply(self, state, mesh):
        re, im = state
        return fft_along(re, im, self.axis, inverse=self.inverse,
                         backend=self.backend)


@dataclasses.dataclass(frozen=True)
class LocalRFFT:
    """r2c endcap: real field → padded half-spectrum pair (last axis)."""
    pad_to: int

    def apply(self, state, mesh):
        (x,) = state
        z = torch.fft.rfft(x.float(), dim=-1)
        re = z.real.new_zeros(z.shape[:-1] + (self.pad_to,))
        im = torch.zeros_like(re)
        re[..., :z.shape[-1]] = z.real
        im[..., :z.shape[-1]] = z.imag
        return re, im


@dataclasses.dataclass(frozen=True)
class LocalIRFFT:
    """c2r endcap: padded half-spectrum pair → real field of extent n."""
    n: int
    half: int

    def apply(self, state, mesh):
        re, im = state
        z = torch.complex(re[..., :self.half], im[..., :self.half])
        return (torch.fft.irfft(z, n=self.n, dim=-1).float(),)


@dataclasses.dataclass(frozen=True)
class AllToAll:
    """Tiled all_to_all over one mesh axis, with an optional reduced
    (``wire_dtype``) or encoded (``wire_codec``) wire. ``crosses_hosts``
    says whether the axis's ranks span more than one node (None: not
    annotated); execution is the same either way."""
    axis_name: str
    split: int
    concat: int
    shards: int
    wire_dtype: Optional[str] = None        # dtype NAME (hashable)
    crosses_hosts: Optional[bool] = None    # None = not annotated
    wire_codec: Optional[str] = None        # codec NAME (wire.py)

    def __post_init__(self):
        # builders pass one wire spec entry positionally as wire_dtype;
        # codec names reroute to the codec slot, as in the reference
        if self.wire_dtype is not None and self.wire_codec is None \
                and wire_mod.is_codec(self.wire_dtype):
            object.__setattr__(self, "wire_codec", self.wire_dtype)
            object.__setattr__(self, "wire_dtype", None)

    def _encode(self, x, s: int, c: int):
        """(the tensor that travels, what ``_decode`` needs). A reduced
        or encoded wire travels as uint8 bytes along a widened last axis,
        which splits and concatenates as the elements do."""
        if self.wire_codec is not None:
            codec = wire_mod.get_codec(self.wire_codec)
            parts = codec.encode_wire(x)
            if len(parts) == 1:
                return (wire_mod.as_bytes(parts[0]),
                        ("part", codec, parts[0].dtype, x.dtype))
            # payload and scales ride ONE packed collective
            last = x.dim() - 1
            packed, meta = wire_mod.pack_wire(
                parts, self.shards, split_last=(s == last),
                concat_last=(c == last))
            return packed, ("packed", codec, meta, x.dtype)
        wd = _torch_dtype(self.wire_dtype) if self.wire_dtype else None
        if wd is not None and x.dtype != wd:
            return (wire_mod.as_bytes(x.to(wd)),
                    ("cast", None, wd, x.dtype))
        return x, None

    @staticmethod
    def _decode(y, meta):
        if meta is None:
            return y
        kind, codec, how, dtype = meta
        if kind == "cast":
            return wire_mod.from_bytes(y, how).to(dtype)
        if kind == "part":
            return codec.decode((wire_mod.from_bytes(y, how),), dtype)
        return codec.decode(wire_mod.unpack_wire(y, how), dtype)

    def start(self, x, mesh):
        """Encode ``x`` for the wire and issue its exchange; returns the
        handle ``finish`` takes: (work, received, sent, wire meta), work
        None where nothing moves (one shard). The sent buffer stays
        referenced until the wait."""
        s, c = self.split % x.dim(), self.concat % x.dim()
        if x.shape[s] % self.shards:
            raise ValueError(f"all_to_all: split extent {x.shape[s]} does "
                             f"not divide into {self.shards} shards")
        payload, meta = self._encode(x, s, c)
        if self.shards == 1:
            return None, payload, None, meta
        n = payload.shape[s]
        # chunk j (along split) to the front, for rank j of the group
        send = payload.unflatten(s, (self.shards, n // self.shards))
        send = send.movedim(s, 0).contiguous()
        out = torch.empty_like(send)
        C.record_wire("all-to-all", send.numel() * send.element_size(),
                      self.shards)
        work = dist.all_to_all_single(out, send,
                                      group=mesh.group(self.axis_name),
                                      async_op=True)
        return work, out, send, meta

    def finish(self, handle, ndim: int):
        """Wait for the exchange, fold the source-rank dim in front of
        the concat axis, and decode the wire."""
        work, out, _, meta = handle
        if work is not None:
            work.wait()
            c = self.concat % ndim
            out = out.movedim(0, c).flatten(c, c + 1)
        return self._decode(out, meta)

    def apply(self, state, mesh):
        started = [self.start(x, mesh) for x in state]
        return tuple(self.finish(h, x.dim()) for h, x in zip(started, state))


@dataclasses.dataclass(frozen=True)
class Twiddle:
    """Inter-shard four-step twiddle exp(sign·2πi·p·k/N) along ``axis``;
    N = shards · local extent, p = this rank's coordinate on
    ``axis_name``. The angle is taken in float32, as the reference takes
    it."""
    axis: int
    axis_name: str
    shards: int
    sign: float

    def apply(self, state, mesh):
        re, im = state
        ax = self.axis % re.dim()
        m = re.shape[ax]
        total = m * self.shards
        # made on the device (a fill, not a host copy that would wait
        # for the stream)
        p = torch.full((), float(mesh.coordinate[self.axis_name]),
                       dtype=torch.float32, device=re.device)
        k = torch.arange(m, dtype=torch.float32, device=re.device)
        ang = self.sign * 2.0 * math.pi * p * k / total
        bshape = [1] * re.dim()
        bshape[ax] = m
        return cmul(re, im, torch.cos(ang).reshape(bshape),
                    torch.sin(ang).reshape(bshape))


@dataclasses.dataclass(frozen=True)
class Reorder:
    """Named local index reorder.

    op ∈ {"expand", "merge", "fold_T", "unfold_T"}:
      expand    — insert a singleton at ``axis``
      merge     — merge axes (axis, axis+1) row-major
      fold_T    — swap (axis, axis+1) then merge: the four-step's
                  column-major output flatten
      unfold_T  — split ``axis`` into (n/parts, parts) then swap →
                  (parts, n/parts): fold_T's exact inverse
    Views where the layout allows; the kernels' wrappers make what they
    read contiguous."""
    op: str
    axis: int
    parts: int = 0

    def _one(self, x):
        if self.op == "expand":
            return x.unsqueeze(self.axis)
        ax = self.axis % x.dim()
        if self.op == "merge":
            return x.flatten(ax, ax + 1)
        if self.op == "fold_T":
            return x.transpose(ax, ax + 1).flatten(ax, ax + 1)
        if self.op == "unfold_T":
            m = x.shape[ax]
            return x.unflatten(ax, (m // self.parts, self.parts)).transpose(
                ax, ax + 1)
        raise ValueError(self.op)

    def apply(self, state, mesh):
        return tuple(self._one(x) for x in state)


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """A distributed transform as data: stages + the sharding contract.
    ``in_spec`` / ``out_spec`` are the PartitionSpec tails over the
    transform dims (mesh axis name, None, or a tuple of names);
    ``in_arity``/``out_arity`` count the arrays flowing in/out (2 = split
    (re, im) pair)."""
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


def _torch_dtype(name) -> torch.dtype:
    """The torch dtype a wire dtype name (or dtype) names."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"{name!r} names no torch dtype")
    return dt


def wire_entry(w) -> Optional[str]:
    """Normalise ONE wire spec entry: None, a codec name (verbatim; see
    ``wire.py``), or a dtype name in canonical form (``"bfloat16"``)."""
    if w is None:
        return None
    if wire_mod.is_codec(w):
        return w
    return str(_torch_dtype(w)).split(".")[-1]


def _wire_tuple(wire_dtype: WireSpec, n_a2a: int
                ) -> Tuple[Optional[str], ...]:
    """One dtype/codec NAME per AllToAll stage: None (exact everywhere),
    one name (every exchange), or a tuple with one entry per exchange
    (per-stage wire, e.g. only the host-crossing rotation of a pencil)."""
    if isinstance(wire_dtype, (tuple, list)):
        if len(wire_dtype) != n_a2a:
            raise ValueError(
                f"wire_dtype tuple has {len(wire_dtype)} entries for "
                f"{n_a2a} all_to_all stages")
        return tuple(wire_entry(w) for w in wire_dtype)
    return (wire_entry(wire_dtype),) * n_a2a


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def overlap_site(sched: Schedule) -> Tuple[int, int]:
    """Validate + locate the overlap point: (index of the first
    AllToAll, chunk axis = its concat axis). Raises ValueError when the
    schedule is ineligible (no exchange, degenerate concat axis, or a
    pre-exchange stage transforms/reshapes the chunk axis)."""
    for k, st in enumerate(sched.stages):
        if isinstance(st, AllToAll):
            break
    else:
        raise ValueError(f"{sched.name}: no all_to_all stage to overlap")
    t, s = st.concat, st.split
    if t == s:
        raise ValueError(f"{sched.name}: degenerate exchange axes")
    for pre in sched.stages[:k]:
        if isinstance(pre, (LocalFFT, Twiddle)):
            if pre.axis == t:
                raise ValueError(
                    f"{sched.name}: pre-exchange stage transforms the "
                    f"chunk axis {t}")
        elif isinstance(pre, (LocalRFFT, LocalIRFFT)):
            if t == -1:
                raise ValueError(
                    f"{sched.name}: real endcap owns the chunk axis")
        else:
            raise ValueError(
                f"{sched.name}: overlap unsupported across "
                f"{type(pre).__name__} stages")
    return k, t


def _run_overlap(sched: Schedule, mesh: Mesh, state, k: int, t: int,
                 chunks: int):
    """Chunked pipeline: stages[:k] per chunk along axis t, each chunk's
    exchange issued asynchronously before the next chunk's local stages,
    then un-interleave and run the rest. The unchunked exchange orders
    the concat axis (shard, chunk, row); per-chunk exchanges concatenate
    as (chunk, shard, row), so one reshape/swap gives the unchunked
    result bit for bit."""
    a2a = sched.stages[k]
    ext = state[0].shape[t]
    if ext % chunks:
        raise ValueError(
            f"{sched.name}: overlap axis extent {ext} not divisible by "
            f"chunks={chunks}")
    c = ext // chunks
    inflight = []
    for j in range(chunks):
        sub = tuple(x.narrow(t, j * c, c) for x in state)
        for st in sched.stages[:k]:
            sub = st.apply(sub, mesh)
        inflight.append([(a2a.start(x, mesh), x.dim()) for x in sub])
    parts = [tuple(a2a.finish(h, nd) for h, nd in chunk)
             for chunk in inflight]
    pn = a2a.shards

    def fix(x):
        ax = t % x.dim()
        shp = x.shape
        y = x.reshape(shp[:ax] + (chunks, pn, c) + shp[ax + 1:])
        return y.transpose(ax, ax + 1).reshape(shp)

    state = tuple(fix(torch.cat([p[i] for p in parts], dim=t))
                  for i in range(len(parts[0])))
    for st in sched.stages[k + 1:]:
        state = st.apply(state, mesh)
    return state


def execute_schedule(sched: Schedule, mesh: Mesh, *arrays,
                     overlap_chunks: int = 0):
    """Run a schedule on this rank's local blocks (the reference's
    shard_map body). Leading dims beyond ``sched.rank`` are batch. With
    ``overlap_chunks > 1`` the first exchange pipelines against the local
    stages before it."""
    if len(arrays) != sched.in_arity:
        raise ValueError(f"{sched.name}: expected {sched.in_arity} "
                         f"arrays, got {len(arrays)}")
    if arrays[0].dim() < sched.rank:
        raise ValueError(f"rank-{arrays[0].dim()} input for a "
                         f"rank-{sched.rank} transform")
    chunks = int(overlap_chunks or 0)
    state = tuple(arrays)
    if chunks > 1:
        k, t = overlap_site(sched)
        state = _run_overlap(sched, mesh, state, k, t, chunks)
    else:
        for st in sched.stages:
            state = st.apply(state, mesh)
    return state if len(state) > 1 else state[0]


# ---------------------------------------------------------------------------
# Builders — complex (c2c) decompositions
# ---------------------------------------------------------------------------

def slab_2d(mesh: Mesh, axis_name: str = "data", *, inverse: bool = False,
            backend: str = "auto", wire_dtype: WireSpec = None) -> Schedule:
    """FFTW-MPI's slab: local FFT, one exchange, local FFT.
    forward P(ax, None) → P(None, ax); inverse mirrors."""
    pn = mesh.shape[axis_name]
    (w,) = _wire_tuple(wire_dtype, 1)
    if inverse:
        stages = (LocalFFT(-2, True, backend),
                  AllToAll(axis_name, -2, -1, pn, w),
                  LocalFFT(-1, True, backend))
        return Schedule("slab2d_inv", 2, stages,
                        (None, axis_name), (axis_name, None))
    stages = (LocalFFT(-1, False, backend),
              AllToAll(axis_name, -1, -2, pn, w),
              LocalFFT(-2, False, backend))
    return Schedule("slab2d", 2, stages,
                    (axis_name, None), (None, axis_name))


def slab_3d(mesh: Mesh, axis_name: str = "data", *, inverse: bool = False,
            backend: str = "auto", wire_dtype: WireSpec = None) -> Schedule:
    """3-D slab on ONE mesh axis: three local passes, one exchange —
    3-D grids without a 2-axis mesh.
    forward P(ax, None, None) → P(None, ax, None); inverse mirrors."""
    pn = mesh.shape[axis_name]
    (w,) = _wire_tuple(wire_dtype, 1)
    if inverse:
        stages = (LocalFFT(-3, True, backend),
                  AllToAll(axis_name, -3, -2, pn, w),
                  LocalFFT(-2, True, backend),
                  LocalFFT(-1, True, backend))
        return Schedule("slab3d_inv", 3, stages,
                        (None, axis_name, None), (axis_name, None, None))
    stages = (LocalFFT(-1, False, backend),
              LocalFFT(-2, False, backend),
              AllToAll(axis_name, -2, -3, pn, w),
              LocalFFT(-3, False, backend))
    return Schedule("slab3d", 3, stages,
                    (axis_name, None, None), (None, axis_name, None))


def pencil_3d(mesh: Mesh, axes: Tuple[str, str] = ("data", "model"), *,
              inverse: bool = False, backend: str = "auto",
              wire_dtype: WireSpec = None) -> Schedule:
    """Standard pencil: three local passes, two full rotations.
    forward P(a0, a1, None) → P(None, a0, a1); inverse mirrors."""
    a0, a1 = axes
    p0, p1 = mesh.shape[a0], mesh.shape[a1]
    w0, w1 = _wire_tuple(wire_dtype, 2)
    if inverse:
        stages = (LocalFFT(-3, True, backend),
                  AllToAll(a0, -3, -2, p0, w0),
                  LocalFFT(-2, True, backend),
                  AllToAll(a1, -2, -1, p1, w1),
                  LocalFFT(-1, True, backend))
        return Schedule("pencil_inv", 3, stages,
                        (None, a0, a1), (a0, a1, None))
    stages = (LocalFFT(-1, False, backend),
              AllToAll(a1, -1, -2, p1, w0),
              LocalFFT(-2, False, backend),
              AllToAll(a0, -2, -3, p0, w1),
              LocalFFT(-3, False, backend))
    return Schedule("pencil", 3, stages,
                    (a0, a1, None), (None, a0, a1))


def pencil_tf_3d(mesh: Mesh, axes: Tuple[str, str] = ("data", "model"), *,
                 inverse: bool = False, backend: str = "auto",
                 wire_dtype: WireSpec = None) -> Schedule:
    """Transpose-free pencil (Chatterjee-Verma-style): the second full
    rotation is replaced by a four-step exchange along the still-sharded
    first grid axis.

    forward: input x[n0, n1, n2] P(a0, a1, None), **axis 0 in cyclic
    order over a0** (global element g = m·P0 + p on shard p, exactly
    ``fourstep_fft_1d``'s contract; ``distributed.cyclic_order`` builds
    it) → output P(a0, None, a1) where position g' along axis 0 holds
    bin ``fourstep_freq_of_position(n0, P0)[g']`` and axes 1, 2 are in
    natural frequency order. Requires P0 | (n0 / P0). The x-axis
    sharding never moves — that is the "transpose-free" part; only
    M0/P0-deep bricks travel in the second exchange's four-step pattern.
    inverse: exact mirror, back to the cyclic spatial layout."""
    a0, a1 = axes
    p0, p1 = mesh.shape[a0], mesh.shape[a1]
    wa, wb = _wire_tuple(wire_dtype, 2)
    if inverse:
        stages = (Reorder("unfold_T", -3, p0),       # x: (M0)→(P0, M0/P0)
                  LocalFFT(-4, True, backend),       # length-P0 pass
                  AllToAll(a0, -4, -3, p0, wa),      # → (1, M0, ...)
                  Reorder("merge", -4),
                  Twiddle(-3, a0, p0, +1.0),
                  LocalFFT(-3, True, backend),       # x local
                  LocalFFT(-2, True, backend),       # y
                  AllToAll(a1, -2, -1, p1, wb),      # y ↔ z rotation
                  LocalFFT(-1, True, backend))       # z
        return Schedule("pencil_tf_inv", 3, stages,
                        (a0, None, a1), (a0, a1, None))
    stages = (LocalFFT(-1, False, backend),          # z
              AllToAll(a1, -1, -2, p1, wa),          # z ↔ y rotation
              LocalFFT(-2, False, backend),          # y
              LocalFFT(-3, False, backend),          # x local (cyclic)
              Twiddle(-3, a0, p0, -1.0),
              Reorder("expand", -4),
              AllToAll(a0, -3, -4, p0, wb),          # four-step exchange
              LocalFFT(-4, False, backend),          # length-P0 pass
              Reorder("fold_T", -4))                 # column-major flatten
    return Schedule("pencil_tf", 3, stages,
                    (a0, a1, None), (a0, None, a1))


def pencil_2d(mesh: Mesh, axes: Tuple[str, str] = ("data", "model"), *,
              inverse: bool = False, backend: str = "auto",
              wire_dtype: WireSpec = None) -> Schedule:
    """2-axis decomposition of 2-D grids over 2-D meshes — huge 2-D
    grids stop being stuck with the P0-way slab: the input is tiled
    P(a0, a1) (the natural layout of a 2-D domain-decomposed
    simulation) and all P0·P1 devices participate.

    forward: gather axis 1 over a1 (axis 0 picks up a1 as its minor
    sharding factor), FFT it, scatter the frequency axis back over a1,
    then one rotation over a0 gathers axis 0 and scatters k1's minor
    factor — P(a0, a1) → P(None, (a1, a0)), both frequency axes in
    natural order. Three exchanges, but each moves only the 1/(P0·P1)
    local tile, and they split across the two mesh axes: on a DCN×ICI
    mesh only the a0 rotation crosses hosts, which is exactly what the
    per-stage wire sweep keys on. Requires P0·P1 | N0 and P0·P1 | N1.
    inverse mirrors."""
    a0, a1 = axes
    p0, p1 = mesh.shape[a0], mesh.shape[a1]
    w0, w1, w2 = _wire_tuple(wire_dtype, 3)
    if inverse:
        stages = (LocalFFT(-2, True, backend),
                  AllToAll(a0, -2, -1, p0, w0),   # undo the k0 gather
                  AllToAll(a1, -2, -1, p1, w1),   # regroup axis 1
                  LocalFFT(-1, True, backend),
                  AllToAll(a1, -1, -2, p1, w2))   # re-scatter axis 1
        return Schedule("pencil2d_inv", 2, stages,
                        (None, (a1, a0)), (a0, a1))
    stages = (AllToAll(a1, -2, -1, p1, w0),       # gather axis 1 locally
              LocalFFT(-1, False, backend),
              AllToAll(a1, -1, -2, p1, w1),       # scatter k1 over a1
              AllToAll(a0, -1, -2, p0, w2),       # gather axis 0 / split k1
              LocalFFT(-2, False, backend))
    return Schedule("pencil2d", 2, stages,
                    (a0, a1), (None, (a1, a0)))


def fourstep_1d(mesh: Mesh, axis_name: str = "data", *,
                inverse: bool = False, backend: str = "auto",
                wire_dtype: WireSpec = None) -> Schedule:
    """Bailey's four-step across the mesh: cyclic input layout, output
    in transposed digit order (``fourstep_freq_of_position``)."""
    pn = mesh.shape[axis_name]
    (w,) = _wire_tuple(wire_dtype, 1)
    if inverse:
        stages = (Reorder("unfold_T", -1, pn),
                  LocalFFT(-2, True, backend),
                  AllToAll(axis_name, -2, -1, pn, w),
                  Reorder("merge", -2),
                  Twiddle(-1, axis_name, pn, +1.0),
                  LocalFFT(-1, True, backend))
        return Schedule("fourstep1d_inv", 1, stages,
                        (axis_name,), (axis_name,))
    stages = (LocalFFT(-1, False, backend),
              Twiddle(-1, axis_name, pn, -1.0),
              Reorder("expand", -2),
              AllToAll(axis_name, -1, -2, pn, w),
              LocalFFT(-2, False, backend),
              Reorder("fold_T", -2))
    return Schedule("fourstep1d", 1, stages, (axis_name,), (axis_name,))


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
    "pencil": pencil_3d,
    "pencil_tf": pencil_tf_3d,
    "pencil2d": pencil_2d,
    "fourstep1d": fourstep_1d,
}


def annotate_topology(sched: Schedule, mesh: Mesh) -> Schedule:
    """Fill each ``AllToAll``'s ``crosses_hosts`` from the mesh (whether
    the axis's ranks span more than one node). Metadata only: the
    annotated schedule runs identically."""
    stages = tuple(
        dataclasses.replace(
            st, crosses_hosts=axis_crosses_processes(mesh, st.axis_name))
        if isinstance(st, AllToAll) else st
        for st in sched.stages)
    return dataclasses.replace(sched, stages=stages)


def exchange_topology(sched: Schedule) -> Tuple[dict, ...]:
    """One summary dict per ``AllToAll`` stage, in execution order:
    ``{axis_name, shards, wire_dtype, wire_codec, crosses_hosts}`` — the
    schedule's wire profile."""
    return tuple({"axis_name": st.axis_name, "shards": st.shards,
                  "wire_dtype": st.wire_dtype,
                  "wire_codec": st.wire_codec,
                  "crosses_hosts": st.crosses_hosts}
                 for st in sched.stages if isinstance(st, AllToAll))


def build_schedule(decomp: str, shape: Tuple[int, ...], mesh: Mesh,
                   axis_names: Tuple[str, ...], *, inverse: bool = False,
                   backend: str = "auto", wire_dtype: WireSpec = None,
                   real: bool = False) -> Schedule:
    """One entry point from (decomp, knobs) to a runnable Schedule,
    topology-annotated from the mesh; ``real=True`` builds the r2c/c2r
    schedule of ``rfft.RFFT_BUILDERS``."""
    caps = CAPS.get(decomp)
    if caps is None:
        raise ValueError(f"unknown decomposition {decomp!r}; "
                         f"known: {sorted(CAPS)}")
    if len(shape) != caps.rank:
        raise ValueError(f"{decomp} transforms rank-{caps.rank} grids, "
                         f"got shape {shape}")
    if caps.mesh_axes == 2 and len(axis_names) < 2:
        raise ValueError(f"{decomp} needs two mesh axes, got "
                         f"{tuple(axis_names)}")
    if real:
        if not caps.real:
            raise ValueError(
                f"real (r2c/c2r) plans support "
                f"{sorted(k for k, c in CAPS.items() if c.real)}, "
                f"not {decomp!r}")
        from repro_torch.core.fft import rfft as rfft_mod
        build_r, naxes = rfft_mod.RFFT_BUILDERS[decomp]
        axes = tuple(axis_names[:2]) if naxes == 2 else axis_names[0]
        sched = build_r(shape[-1], mesh, axes, inverse=inverse,
                        backend=backend, wire_dtype=wire_dtype)
        return annotate_topology(sched, mesh)
    build = _BUILDERS[decomp]
    if caps.mesh_axes == 2:
        sched = build(mesh, tuple(axis_names[:2]), inverse=inverse,
                      backend=backend, wire_dtype=wire_dtype)
    else:
        sched = build(mesh, axis_names[0], inverse=inverse,
                      backend=backend, wire_dtype=wire_dtype)
    return annotate_topology(sched, mesh)
