"""Distributed multi-dimensional FFTs as thin schedule wrappers
(counterpart of ``repro/core/fft/distributed.py``).

Every decomposition is a schedule builder in ``schedule.py``, run by the
one executor, ``execute_schedule``. This module keeps the reference's
functional API and its layout maps, and adds the per-rank placement
that ``NamedSharding`` does in the reference:

* ``slab_fft_2d`` / ``slab_fft_2d_overlap`` — FFTW-MPI's algorithm on
  one mesh axis; forward P(ax, None) → P(None, ax).
* ``slab_fft_3d`` — 3-D grids on one mesh axis; P(ax, None, None) →
  P(None, ax, None).
* ``pencil_fft_3d`` / ``pencil_ifft_3d`` — two mesh axes, two
  rotations; P(a0, a1, None) → P(None, a0, a1).
* ``pencil2d_fft_2d`` — 2-D grids over 2-D meshes; P(a0, a1) →
  P(None, (a1, a0)), natural frequency order.
* ``pencil_tf_fft_3d`` / ``pencil_tf_ifft_3d`` — transpose-free pencil;
  P(a0, a1, None) → P(a0, None, a1), axis 0 cyclic in and digit-permuted
  out.
* ``fourstep_fft_1d`` / ``fourstep_ifft_1d`` — Bailey's four-step across
  the mesh; cyclic input, transposed-digit output order.

In the port every function takes and returns this rank's LOCAL blocks
as split (re, im) float32 pairs; leading dims are batch.
``shard(x, mesh, spec)`` cuts a global array to this rank's block and
``unshard(block, mesh, spec)`` gathers the blocks back. ``spec`` is the
reference's PartitionSpec tail over the trailing dims: per dim a mesh
axis name, None, or a tuple of names, which shards the dim over all of
them with the FIRST name major (as JAX reads it: under (a1, a0), rank
(c0, c1) holds block c1·P0 + c0).

Layout maps (pure numpy, kept here so the port imports nothing of the
reference): ``cyclic_order`` / ``cyclic_inverse_order`` (natural ↔
cyclic input), ``fourstep_freq_of_position`` (output position → DFT
bin for the four-step digit order, also axis 0 of the transpose-free
pencil output) and ``fourstep_position_of_freq`` (its inverse).

``reshard`` (reference ``:253``, a ``device_put`` to another
``NamedSharding``) moves a field from one mesh's blocks under one spec
to another mesh's blocks under another: the meshes may be the same, or
overlap, or not. No endpoint of either package calls it
(``Endpoint.in_sharding`` is None everywhere); the producers' hop onto a
consumer mesh is ``core/insitu/transit.py``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import Mesh
from repro_torch.core.fft import schedule as S
from repro_torch.core.fft.dft import Pair
from repro_torch.core.fft.schedule import execute_schedule


# ---------------------------------------------------------------------------
# Placement: global array <-> this rank's block
# ---------------------------------------------------------------------------

def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec: Sequence) -> set:
    """The mesh axes a spec shards over; the others hold copies."""
    return {name for entry in spec for name in _names(entry)}


def sum_over_blocks(t: torch.Tensor, mesh: Mesh, spec: Sequence):
    """The sum over the mesh's ranks of each rank's ``t`` (a reduction of
    its block), in float64, each block of ``spec`` counted once: ranks
    along an axis the spec does not name hold copies (collective)."""
    used = spec_axes(spec)
    copies = math.prod(mesh.shape[n] for n in mesh.axis_names
                       if n not in used)
    t = t.to(torch.float64, copy=True)   # the all-reduce writes into it
    dist.all_reduce(t, group=mesh.mesh_group)
    return t / copies


def _block(mesh: Mesh, entry, coordinate) -> Tuple[int, int]:
    """(block index, block count) of one spec entry at ``coordinate``
    (axis name → index), the first name major."""
    idx, count = 0, 1
    for name in _names(entry):
        idx = idx * mesh.shape[name] + coordinate[name]
        count *= mesh.shape[name]
    return idx, count


def shard_count(mesh: Mesh, entry) -> int:
    """How many blocks one spec entry cuts its dim into."""
    return _block(mesh, entry, mesh.coordinate)[1]


def _slices(mesh: Mesh, spec: Sequence, shape, coordinate):
    lead = len(shape) - len(spec)
    if lead < 0:
        raise ValueError(f"spec {tuple(spec)} is longer than the "
                         f"rank-{len(shape)} array")
    out = [slice(None)] * lead
    for entry, n in zip(spec, shape[lead:]):
        idx, count = _block(mesh, entry, coordinate)
        if n % count:
            raise ValueError(f"extent {n} does not split into {count} "
                             f"blocks (spec {tuple(spec)}, mesh "
                             f"{mesh.shape})")
        step = n // count
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard(x, mesh: Mesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of the global array ``x`` (numpy or torch), on
    the mesh's device, contiguous."""
    sl = _slices(mesh, spec, tuple(x.shape), mesh.coordinate)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x[sl])).to(mesh.device)
    return x[sl].to(mesh.device).contiguous()


def unshard(local: torch.Tensor, mesh: Mesh, spec: Sequence, *,
            dst=None, group=None):
    """The global array from every rank's block (collective over the
    mesh's ranks): on every rank, or with ``dst`` (a global rank of the
    mesh, e.g. ``mesh.first_rank``) only on that rank (None elsewhere).
    ``group`` is a process group over the mesh's ranks (default: the
    mesh's own); the pipelined chain's host tail gathers on its own."""
    if mesh.size == 1:
        return local
    local = local.contiguous()
    blocks = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(blocks, local,
                    group=mesh.mesh_group if group is None else group)
    if dst is not None and dist.get_rank() != dst:
        return None
    lead = local.dim() - len(spec)
    shape = list(local.shape)
    for i, entry in enumerate(spec):
        shape[lead + i] *= shard_count(mesh, entry)
    out = local.new_empty(shape)
    extents = tuple(mesh.shape[n] for n in mesh.axis_names)
    # a group's ranks ascend; the mesh's positions need not
    order = sorted(mesh.members)
    for pos, rank in enumerate(mesh.members):
        coord = dict(zip(mesh.axis_names, np.unravel_index(pos, extents)))
        out[_slices(mesh, spec, shape, coord)] = blocks[order.index(rank)]
    return out


def reshard(x, src: Mesh, src_spec: Sequence, dst: Mesh,
            dst_spec: Sequence, *, group=None):
    """Move a field from ``src``'s blocks under ``src_spec`` to ``dst``'s
    blocks under ``dst_spec`` (the reference's ``reshard``, a
    ``device_put`` to the target sharding).

    ``x`` is this rank's block on a rank of ``src``; every other rank
    passes a placeholder of the global shape and dtype (a ``"meta"``
    tensor or a numpy array: only ``shape`` and ``dtype`` are read).
    Returns this rank's block under ``dst_spec``, on ``dst.device``, on a
    rank of ``dst``, and None elsewhere. Collective over ``group``
    (default: the world), which must hold every rank of both meshes and
    carry CPU tensors: each rank's header and block go through one
    ``all_gather_object``, every rank checks that the headers agree on
    the global shape and dtype and that the blocks cover the field, and
    the lowest rank's copy wins where blocks overlap (ranks along an axis
    ``src_spec`` does not name hold copies)."""
    placeholder = not torch.is_tensor(x) or x.device.type == "meta"
    mine = (tuple(x.shape), str(np.dtype(_numpy_dtype(x.dtype))), None,
            None)
    if src.is_member and not placeholder:
        shape = list(x.shape)
        lead = len(shape) - len(src_spec)
        for i, entry in enumerate(src_spec):
            shape[lead + i] *= shard_count(src, entry)
        cut = _slices(src, src_spec, tuple(shape), src.coordinate)
        mine = (tuple(shape), mine[1],
                tuple((sl.start or 0, n if sl.stop is None else sl.stop)
                      for sl, n in zip(cut, shape)),
                x.detach().cpu().numpy())
    heads = [mine]
    if dist.is_available() and dist.is_initialized():
        heads = [None] * dist.get_world_size(group)
        dist.all_gather_object(heads, mine, group=group)
    if any(h[:2] != heads[0][:2] for h in heads):
        raise ValueError("reshard: the ranks disagree on the field's "
                         "global (shape, dtype): "
                         + "; ".join(f"rank {r}: {h[:2]}"
                                     for r, h in enumerate(heads)))
    shape, dtype = heads[0][:2]
    full = np.zeros(shape, dtype) if dst.is_member else None
    filled = np.zeros(shape, bool)
    for _, _, bounds, block in heads:        # lowest rank first
        if bounds is None:
            continue
        idx = tuple(slice(lo, hi) for lo, hi in bounds)
        if full is not None:
            full[idx] = np.where(filled[idx], full[idx], block)
        filled[idx] = True
    if not filled.all():
        raise ValueError(f"reshard: no rank of the source mesh holds "
                         f"{int((~filled).sum())} of {filled.size} elements")
    return None if full is None else shard(full, dst, dst_spec)


def _numpy_dtype(dtype):
    """``dtype`` (torch or numpy) as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


# ---------------------------------------------------------------------------
# 2-D slab (the paper's fftw_mpi_plan_dft_2d equivalent)
# ---------------------------------------------------------------------------

def slab_fft_2d(re, im, mesh: Mesh, axis_name: str = "data", *,
                inverse: bool = False, backend: str = "auto") -> Pair:
    """2-D FFT of (..., N0, N1) blocks (leading dims batch).
    forward: P(..., ax, None) → P(..., None, ax); inverse mirrors."""
    sched = S.slab_2d(mesh, axis_name, inverse=inverse, backend=backend)
    return execute_schedule(sched, mesh, re, im)


def slab_fft_2d_overlap(re, im, mesh: Mesh, axis_name: str = "data", *,
                        inverse: bool = False, backend: str = "auto",
                        chunks: int = 4) -> Pair:
    """``slab_fft_2d`` with the executor's chunked overlap: chunk j+1's
    local FFT is issued before chunk j's exchange is waited for."""
    sched = S.slab_2d(mesh, axis_name, inverse=inverse, backend=backend)
    return execute_schedule(sched, mesh, re, im, overlap_chunks=chunks)


# ---------------------------------------------------------------------------
# 3-D slab and pencils
# ---------------------------------------------------------------------------

def slab_fft_3d(re, im, mesh: Mesh, axis_name: str = "data", *,
                inverse: bool = False, backend: str = "auto") -> Pair:
    """3-D FFT on a 1-axis mesh: three local passes, ONE exchange.
    forward: P(..., ax, None, None) → P(..., None, ax, None)."""
    sched = S.slab_3d(mesh, axis_name, inverse=inverse, backend=backend)
    return execute_schedule(sched, mesh, re, im)


def pencil_fft_3d(re, im, mesh: Mesh,
                  axes: Tuple[str, str] = ("data", "model"), *,
                  backend: str = "auto", wire_dtype=None) -> Pair:
    """3-D FFT: z-pencils P(..., a0, a1, None) → x-pencils
    P(..., None, a0, a1); ``wire_dtype`` one wire for both exchanges or
    one a stage (``schedule._wire_tuple``)."""
    sched = S.pencil_3d(mesh, tuple(axes), backend=backend,
                        wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, re, im)


def pencil_ifft_3d(re, im, mesh: Mesh,
                   axes: Tuple[str, str] = ("data", "model"), *,
                   backend: str = "auto") -> Pair:
    """Inverse of ``pencil_fft_3d``: P(..., None, a0, a1) →
    P(..., a0, a1, None)."""
    sched = S.pencil_3d(mesh, tuple(axes), inverse=True, backend=backend)
    return execute_schedule(sched, mesh, re, im)


def pencil2d_fft_2d(re, im, mesh: Mesh,
                    axes: Tuple[str, str] = ("data", "model"), *,
                    inverse: bool = False, backend: str = "auto") -> Pair:
    """2-D FFT of a grid tiled over both axes of a 2-D mesh: P(..., a0,
    a1) → P(..., None, (a1, a0)), natural frequency order; three
    single-axis exchanges. Requires P0·P1 | N0 and P0·P1 | N1."""
    sched = S.pencil_2d(mesh, tuple(axes), inverse=inverse, backend=backend)
    return execute_schedule(sched, mesh, re, im)


def pencil_tf_fft_3d(re, im, mesh: Mesh,
                     axes: Tuple[str, str] = ("data", "model"), *,
                     backend: str = "auto") -> Pair:
    """Transpose-free pencil: P(..., a0, a1, None) → P(..., a0, None,
    a1). Input axis 0 in CYCLIC order over a0 (``cyclic_order``); output
    position g' along axis 0 holds bin
    ``fourstep_freq_of_position(n0, P0)[g']``. Requires P0 | (n0/P0)."""
    sched = S.pencil_tf_3d(mesh, tuple(axes), backend=backend)
    return execute_schedule(sched, mesh, re, im)


def pencil_tf_ifft_3d(re, im, mesh: Mesh,
                      axes: Tuple[str, str] = ("data", "model"), *,
                      backend: str = "auto") -> Pair:
    """Exact inverse of ``pencil_tf_fft_3d`` (back to the cyclic spatial
    layout)."""
    sched = S.pencil_tf_3d(mesh, tuple(axes), inverse=True, backend=backend)
    return execute_schedule(sched, mesh, re, im)


# ---------------------------------------------------------------------------
# Distributed 1-D four-step
# ---------------------------------------------------------------------------

def fourstep_fft_1d(re, im, mesh: Mesh, axis_name: str = "data", *,
                    backend: str = "auto") -> Pair:
    """1-D FFT of a length-N vector sharded P(ax), N = P·M, P | M. Input
    in cyclic order (global element g = m·P + p at offset m of shard p);
    output position p₀·M + j·P + q holds X[c + q·M], c = p₀·M/P + j."""
    sched = S.fourstep_1d(mesh, axis_name, backend=backend)
    return execute_schedule(sched, mesh, re, im)


def fourstep_ifft_1d(re, im, mesh: Mesh, axis_name: str = "data", *,
                     backend: str = "auto") -> Pair:
    """Exact inverse of ``fourstep_fft_1d``."""
    sched = S.fourstep_1d(mesh, axis_name, inverse=True, backend=backend)
    return execute_schedule(sched, mesh, re, im)


# ---------------------------------------------------------------------------
# Layout index maps (pure numpy)
# ---------------------------------------------------------------------------

# the decompositions whose SPATIAL side is the cyclic layout along the
# first sharded grid axis (their forward input, their backward output)
CYCLIC_DECOMPS = ("pencil_tf", "fourstep1d")


def cyclic_order(n: int, p: int):
    """Index map natural → cyclic: x_cyclic = x[cyclic_order(N, P)].
    Shard s's local offset m then holds global element m·P + s."""
    m_len = n // p
    g = np.arange(n)
    return (g % m_len) * p + g // m_len


def cyclic_inverse_order(n: int, p: int):
    inv = np.empty(n, dtype=int)
    inv[cyclic_order(n, p)] = np.arange(n)
    return inv


def fourstep_freq_of_position(n: int, p: int):
    """freq[g'] = the DFT bin stored at global output position g' (for
    ``fourstep_fft_1d`` and axis 0 of ``pencil_tf_fft_3d``)."""
    m = n // p
    g = np.arange(n)
    p0, rem = g // m, g % m
    j, q = rem // p, rem % p
    return p0 * (m // p) + j + q * m


def fourstep_position_of_freq(n: int, p: int):
    """pos[k] = the output position holding DFT bin k, the inverse
    permutation of ``fourstep_freq_of_position``."""
    pos = np.empty(n, dtype=int)
    pos[fourstep_freq_of_position(n, p)] = np.arange(n)
    return pos
