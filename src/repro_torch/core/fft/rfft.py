"""Real-input (r2c/c2r) distributed transforms — FFTW's real plans
(counterpart of ``repro/core/fft/rfft.py``).

The paper's demonstration field is real, and a complex transform of it
wastes 2× everywhere. These transforms keep only the non-negative half
of the spectrum along the LAST grid dim (Hermitian symmetry): a local
rfft along the unsharded last dim (``LocalRFFT``, ~N/2+1 bins), the
exchanges on half-width planes (about half the wire bytes of the
complex transform), and full complex FFTs along the other dims, through
the same stages and the one executor as the complex schedules, so they
take batching, reduced or encoded wire and overlap chunking alike. The
c2r direction mirrors it and ends in ``LocalIRFFT``.

Every complex decomposition that transforms the last grid dim locally
has an r2c sibling here (``RFFT_BUILDERS``):

* ``rfft2_slab``/``irfft2_slab`` — 2-D slab, one mesh axis;
* ``rfft3_slab3d``/``irfft3_slab3d`` — 3-D slab, one mesh axis, one
  exchange; the half axis never travels, so it is UNPADDED;
* ``rfft3_pencil``/``irfft3_pencil`` — 3-D pencil, two rotations on
  half-width planes;
* ``rfft3_pencil_tf``/``irfft3_pencil_tf`` — the transpose-free pencil,
  cyclic input along axis 0 and digit-permuted output there;
* ``rfft2_pencil2d``/``irfft2_pencil2d`` — 2-D grids over both axes of
  a 2-D mesh; the first gather moves the REAL field.

The half-spectrum is zero-padded to a multiple of the shard count of
every mesh axis that splits it (``spectral_half_extent``) and sliced
back on inversion. ``halfspec_freq_of_position`` /
``halfspec_position_of_freq`` are the layout maps of the padded half
axis. As in ``distributed.py``, the functional wrappers take and return
this rank's LOCAL blocks; leading dims are batch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.compat import Mesh
from repro_torch.core.fft import distributed
from repro_torch.core.fft.dft import Pair
from repro_torch.core.fft.schedule import (AllToAll, LocalFFT, LocalIRFFT,
                                           LocalRFFT, Reorder, Schedule,
                                           Twiddle, WireSpec, _wire_tuple,
                                           execute_schedule)


def half_bins(n1: int) -> int:
    return n1 // 2 + 1


def padded_half(n1: int, p: int) -> int:
    h = half_bins(n1)
    return h + (-h) % p


def spectral_half_extent(decomp: str, n_last: int, mesh: Mesh,
                         axis_names: Tuple[str, ...]) -> int:
    """Global extent of the half-spectrum axis a real plan's forward
    output carries for ``decomp`` — ``half_bins(n_last)`` padded to a
    multiple of the shard count of every mesh axis whose tiled
    all_to_all splits along it. ``slab3d`` never exchanges the half
    axis, so it is the one decomposition with NO padding."""
    if decomp == "slab":
        return padded_half(n_last, mesh.shape[axis_names[0]])
    if decomp == "slab3d":
        return half_bins(n_last)
    if decomp in ("pencil", "pencil_tf"):
        return padded_half(n_last, mesh.shape[axis_names[1]])
    if decomp == "pencil2d":
        return padded_half(n_last, mesh.shape[axis_names[0]]
                           * mesh.shape[axis_names[1]])
    raise ValueError(f"no r2c/c2r schedules for decomp {decomp!r}")


# ---------------------------------------------------------------------------
# Half-spectrum layout maps (pure numpy, like the four-step maps in
# ``distributed.py``)
# ---------------------------------------------------------------------------

def halfspec_freq_of_position(n: int, hp: int = None):
    """freq[g] = the DFT bin stored at position ``g`` of the padded
    half-spectrum axis of a length-``n`` real transform; ``-1`` marks
    the zero-padding positions (``g >= n//2+1``) that exist only to
    tile the all_to_all. The half-axis sibling of
    ``fourstep_freq_of_position``."""
    h = half_bins(n)
    hp = h if hp is None else hp
    out = np.full(hp, -1, dtype=int)
    out[:h] = np.arange(h)
    return out


def halfspec_position_of_freq(n: int, hp: int = None):
    """pos[k] = the half-spectrum position holding bin ``k``, defined
    for EVERY full-spectrum bin ``k`` in ``[0, n)``: bins above the
    Nyquist fold onto their Hermitian partner (``pos[k] = pos[n-k]``,
    whose stored value is the conjugate). The exact inverse of
    ``halfspec_freq_of_position`` on the unfolded bins — scatters a
    natural full-spectrum mask into the half layout."""
    del hp  # positions are independent of padding; kept for symmetry
    k = np.arange(n)
    return np.minimum(k, n - k)


# ---------------------------------------------------------------------------
# Schedule builders (registered with schedule.build_schedule via
# plan.py's ``real=True`` dispatch)
# ---------------------------------------------------------------------------

def rfft_slab_schedule(n1: int, mesh: Mesh, axis_name: str = "data", *,
                       inverse: bool = False, backend: str = "auto",
                       wire_dtype: WireSpec = None) -> Schedule:
    """2-D slab r2c/c2r as a schedule. ``n1`` is the full (real) extent
    of the last grid dim; forward maps real P(ax, None) → half-spectrum
    pair (..., N0, Hp) P(None, ax) with Hp = N1/2+1 padded to a
    multiple of the shard count."""
    pn = mesh.shape[axis_name]
    (w,) = _wire_tuple(wire_dtype, 1)
    hp = padded_half(n1, pn)
    if inverse:
        stages = (LocalFFT(-2, True, backend),
                  AllToAll(axis_name, -2, -1, pn, w),
                  LocalIRFFT(n1, half_bins(n1)))
        return Schedule("rfft_slab_inv", 2, stages,
                        (None, axis_name), (axis_name, None),
                        in_arity=2, out_arity=1)
    stages = (LocalRFFT(hp),
              AllToAll(axis_name, -1, -2, pn, w),
              LocalFFT(-2, False, backend))
    return Schedule("rfft_slab", 2, stages,
                    (axis_name, None), (None, axis_name),
                    in_arity=1, out_arity=2)


def rfft_pencil_schedule(n2: int, mesh: Mesh,
                         axes: Tuple[str, str] = ("data", "model"), *,
                         inverse: bool = False, backend: str = "auto",
                         wire_dtype: WireSpec = None) -> Schedule:
    """3-D pencil r2c/c2r as a schedule: same two-rotation dataflow as
    the complex pencil but every all_to_all moves half-width planes."""
    a0, a1 = axes
    p0, p1 = mesh.shape[a0], mesh.shape[a1]
    wa, wb = _wire_tuple(wire_dtype, 2)
    hp = padded_half(n2, p1)
    if inverse:
        stages = (LocalFFT(-3, True, backend),
                  AllToAll(a0, -3, -2, p0, wa),
                  LocalFFT(-2, True, backend),
                  AllToAll(a1, -2, -1, p1, wb),
                  LocalIRFFT(n2, half_bins(n2)))
        return Schedule("rfft_pencil_inv", 3, stages,
                        (None, a0, a1), (a0, a1, None),
                        in_arity=2, out_arity=1)
    stages = (LocalRFFT(hp),
              AllToAll(a1, -1, -2, p1, wa),
              LocalFFT(-2, False, backend),
              AllToAll(a0, -2, -3, p0, wb),
              LocalFFT(-3, False, backend))
    return Schedule("rfft_pencil", 3, stages,
                    (a0, a1, None), (None, a0, a1),
                    in_arity=1, out_arity=2)


def rfft_slab3d_schedule(n2: int, mesh: Mesh, axis_name: str = "data", *,
                         inverse: bool = False, backend: str = "auto",
                         wire_dtype: WireSpec = None) -> Schedule:
    """3-D slab r2c/c2r on ONE mesh axis: local rfft + y pass, one
    exchange on half-width planes, x pass. The single all_to_all splits
    the y axis, never the half axis, so the half-spectrum is UNPADDED
    (global extent exactly ``half_bins(n2)``).
    forward real P(ax, None, None) → half pair P(None, ax, None)."""
    pn = mesh.shape[axis_name]
    (w,) = _wire_tuple(wire_dtype, 1)
    h = half_bins(n2)
    if inverse:
        stages = (LocalFFT(-3, True, backend),
                  AllToAll(axis_name, -3, -2, pn, w),
                  LocalFFT(-2, True, backend),
                  LocalIRFFT(n2, h))
        return Schedule("rfft_slab3d_inv", 3, stages,
                        (None, axis_name, None), (axis_name, None, None),
                        in_arity=2, out_arity=1)
    stages = (LocalRFFT(h),
              LocalFFT(-2, False, backend),
              AllToAll(axis_name, -2, -3, pn, w),
              LocalFFT(-3, False, backend))
    return Schedule("rfft_slab3d", 3, stages,
                    (axis_name, None, None), (None, axis_name, None),
                    in_arity=1, out_arity=2)


def rfft_pencil_tf_schedule(n2: int, mesh: Mesh,
                            axes: Tuple[str, str] = ("data", "model"), *,
                            inverse: bool = False, backend: str = "auto",
                            wire_dtype: WireSpec = None) -> Schedule:
    """Transpose-free pencil r2c/c2r: the complex ``pencil_tf_3d``
    dataflow with a LocalRFFT/LocalIRFFT endcap, so both exchanges move
    half-width planes and the x-sharding still never moves.

    Same layout contract as the complex schedule (``docs/layouts.md``):
    forward input axis 0 must be CYCLIC over the first mesh axis
    (requires P0 | (n0/P0)); output position g' along axis 0 holds bin
    ``fourstep_freq_of_position(n0, P0)[g']`` and the last axis is the
    padded half-spectrum (``padded_half(n2, P1)`` — the z↔y rotation
    splits it)."""
    a0, a1 = axes
    p0, p1 = mesh.shape[a0], mesh.shape[a1]
    wa, wb = _wire_tuple(wire_dtype, 2)
    hp = padded_half(n2, p1)
    if inverse:
        stages = (Reorder("unfold_T", -3, p0),        # x: (M0)→(P0, M0/P0)
                  LocalFFT(-4, True, backend),        # length-P0 pass
                  AllToAll(a0, -4, -3, p0, wa),       # → (1, M0, ...)
                  Reorder("merge", -4),
                  Twiddle(-3, a0, p0, +1.0),
                  LocalFFT(-3, True, backend),        # x local
                  LocalFFT(-2, True, backend),        # y
                  AllToAll(a1, -2, -1, p1, wb),       # y ↔ z rotation
                  LocalIRFFT(n2, half_bins(n2)))
        return Schedule("rfft_pencil_tf_inv", 3, stages,
                        (a0, None, a1), (a0, a1, None),
                        in_arity=2, out_arity=1)
    stages = (LocalRFFT(hp),                          # z (half-spectrum)
              AllToAll(a1, -1, -2, p1, wa),           # z ↔ y rotation
              LocalFFT(-2, False, backend),           # y
              LocalFFT(-3, False, backend),           # x local (cyclic)
              Twiddle(-3, a0, p0, -1.0),
              Reorder("expand", -4),
              AllToAll(a0, -3, -4, p0, wb),           # four-step exchange
              LocalFFT(-4, False, backend),           # length-P0 pass
              Reorder("fold_T", -4))                  # column-major flatten
    return Schedule("rfft_pencil_tf", 3, stages,
                    (a0, a1, None), (a0, None, a1),
                    in_arity=1, out_arity=2)


def rfft_pencil2d_schedule(n1: int, mesh: Mesh,
                           axes: Tuple[str, str] = ("data", "model"), *,
                           inverse: bool = False, backend: str = "auto",
                           wire_dtype: WireSpec = None) -> Schedule:
    """2-axis pencil2d r2c/c2r (see ``schedule.pencil_2d`` for the
    complex dataflow): the first gather moves the REAL field (half the
    bytes of the complex gather), the rfft endcap runs on the locally
    complete last axis, and the two spectral scatters move half-width
    columns. Half-spectrum padded to a multiple of P0·P1 (both scatters
    split along it). forward real P(a0, a1) → half pair
    P(None, (a1, a0))."""
    a0, a1 = axes
    p0, p1 = mesh.shape[a0], mesh.shape[a1]
    w0, w1, w2 = _wire_tuple(wire_dtype, 3)
    hp = padded_half(n1, p0 * p1)
    if inverse:
        stages = (LocalFFT(-2, True, backend),
                  AllToAll(a0, -2, -1, p0, w0),       # undo k0 scatter
                  AllToAll(a1, -2, -1, p1, w1),       # regroup half axis
                  LocalIRFFT(n1, half_bins(n1)),
                  AllToAll(a1, -1, -2, p1, w2))       # re-scatter real x
        return Schedule("rfft_pencil2d_inv", 2, stages,
                        (None, (a1, a0)), (a0, a1),
                        in_arity=2, out_arity=1)
    stages = (AllToAll(a1, -2, -1, p1, w0),           # gather REAL axis 1
              LocalRFFT(hp),
              AllToAll(a1, -1, -2, p1, w1),           # scatter half axis
              AllToAll(a0, -1, -2, p0, w2),           # gather axis 0
              LocalFFT(-2, False, backend))
    return Schedule("rfft_pencil2d", 2, stages,
                    (a0, a1), (None, (a1, a0)),
                    in_arity=1, out_arity=2)


# r2c/c2r builder registry — ``schedule.build_schedule(real=True)``
# dispatches through this; keys must match ``CAPS`` entries with
# ``real=True``. Values: (builder, number of mesh axes it takes).
RFFT_BUILDERS = {
    "slab": (rfft_slab_schedule, 1),
    "slab3d": (rfft_slab3d_schedule, 1),
    "pencil": (rfft_pencil_schedule, 2),
    "pencil_tf": (rfft_pencil_tf_schedule, 2),
    "pencil2d": (rfft_pencil2d_schedule, 2),
}


# ---------------------------------------------------------------------------
# Functional API: this rank's blocks in, this rank's blocks out
# ---------------------------------------------------------------------------

def rfft2_slab(x, mesh: Mesh, axis_name: str = "data", *,
               backend: str = "auto", wire_dtype=None) -> Pair:
    """Real (..., N0, N1) block of P(..., ax, None) → this rank's block of
    the half-spectrum Y[..., k0, k1≤N1/2] (re, im), global shape
    (..., N0, Hp) under P(..., None, ax); Hp = N1/2+1 padded to a
    multiple of the shard count."""
    sched = rfft_slab_schedule(x.shape[-1], mesh, axis_name,
                               backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, x)


def irfft2_slab(re, im, n1: int, mesh: Mesh, axis_name: str = "data", *,
                backend: str = "auto", wire_dtype=None):
    """Inverse of ``rfft2_slab``: half-spectrum block of P(..., None, ax)
    → real (..., N0, N1) block of P(..., ax, None)."""
    sched = rfft_slab_schedule(n1, mesh, axis_name, inverse=True,
                               backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, re, im)


def rfft3_pencil(x, mesh: Mesh, axes: Tuple[str, str] = ("data", "model"),
                 *, backend: str = "auto", wire_dtype=None) -> Pair:
    """Real (..., n0, n1, n2) block of P(..., a0, a1, None) → the
    half-spectrum's block, global (..., N0, N1, Hp) under
    P(..., None, a0, a1); Hp = N2/2+1 padded to a multiple of P1."""
    sched = rfft_pencil_schedule(x.shape[-1], mesh, tuple(axes),
                                 backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, x)


def irfft3_pencil(re, im, n2: int, mesh: Mesh,
                  axes: Tuple[str, str] = ("data", "model"), *,
                  backend: str = "auto", wire_dtype=None):
    """Inverse of ``rfft3_pencil``: P(..., None, a0, a1) → real
    (..., N0, N1, N2) block of P(..., a0, a1, None)."""
    sched = rfft_pencil_schedule(n2, mesh, tuple(axes), inverse=True,
                                 backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, re, im)


def rfft3_slab3d(x, mesh: Mesh, axis_name: str = "data", *,
                 backend: str = "auto", wire_dtype=None) -> Pair:
    """Real (..., N0, N1, N2) block of P(..., ax, None, None) → the
    half-spectrum's block, global (..., N0, N1, N2/2+1) under
    P(..., None, ax, None). One exchange; the half axis is unpadded."""
    sched = rfft_slab3d_schedule(x.shape[-1], mesh, axis_name,
                                 backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, x)


def irfft3_slab3d(re, im, n2: int, mesh: Mesh, axis_name: str = "data", *,
                  backend: str = "auto", wire_dtype=None):
    """Inverse of ``rfft3_slab3d``: P(..., None, ax, None) → real
    (..., N0, N1, N2) block of P(..., ax, None, None)."""
    sched = rfft_slab3d_schedule(n2, mesh, axis_name, inverse=True,
                                 backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, re, im)


def rfft3_pencil_tf(x, mesh: Mesh,
                    axes: Tuple[str, str] = ("data", "model"), *,
                    backend: str = "auto", wire_dtype=None) -> Pair:
    """Transpose-free pencil r2c: real (..., n0, n1, n2) block of
    P(..., a0, a1, None), axis 0 CYCLIC over a0 → the half-spectrum's
    block, global (..., N0, N1, Hp) under P(..., a0, None, a1), axis 0
    in four-step digit order, Hp = padded_half(n2, P1)."""
    sched = rfft_pencil_tf_schedule(x.shape[-1], mesh, tuple(axes),
                                    backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, x)


def irfft3_pencil_tf(re, im, n2: int, mesh: Mesh,
                     axes: Tuple[str, str] = ("data", "model"), *,
                     backend: str = "auto", wire_dtype=None):
    """Inverse of ``rfft3_pencil_tf`` (back to the cyclic spatial layout
    along axis 0)."""
    sched = rfft_pencil_tf_schedule(n2, mesh, tuple(axes), inverse=True,
                                    backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, re, im)


def rfft2_pencil2d(x, mesh: Mesh,
                   axes: Tuple[str, str] = ("data", "model"), *,
                   backend: str = "auto", wire_dtype=None) -> Pair:
    """2-axis r2c: a real (..., N0, N1) block of P(..., a0, a1) → the
    half-spectrum's block, global (..., N0, Hp) under P(..., None,
    (a1, a0)); Hp = padded_half(N1, P0·P1). The block holds N1/P1 of the
    last axis. Requires P0·P1 | N0 and P1 | N1."""
    n1 = x.shape[-1] * mesh.shape[axes[1]]
    sched = rfft_pencil2d_schedule(n1, mesh, tuple(axes),
                                   backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, x)


def irfft2_pencil2d(re, im, n1: int, mesh: Mesh,
                    axes: Tuple[str, str] = ("data", "model"), *,
                    backend: str = "auto", wire_dtype=None):
    """Inverse of ``rfft2_pencil2d``: P(..., None, (a1, a0)) → real
    (..., N0, N1) block of P(..., a0, a1)."""
    sched = rfft_pencil2d_schedule(n1, mesh, tuple(axes), inverse=True,
                                   backend=backend, wire_dtype=wire_dtype)
    return execute_schedule(sched, mesh, re, im)


# ---------------------------------------------------------------------------
# Spectral-domain helpers
# ---------------------------------------------------------------------------

def half_mask(full_mask) -> torch.Tensor:
    """Slice a full-spectrum mask to the half-spectrum (last dim)."""
    m = torch.as_tensor(full_mask)
    return m[..., : half_bins(m.shape[-1])]


def rfft_chain_2d(x, full_mask, mesh: Mesh, axis_name: str = "data", *,
                  backend: str = "auto"):
    """The paper's fwd → bandpass → inv chain on the half-spectrum, on
    this rank's (..., N0, N1) block of P(..., ax, None); ``full_mask`` is
    the global (N0, N1) mask."""
    from repro_torch.core.fft.filters import halfspec_mask
    n1 = x.shape[-1]
    hp = padded_half(n1, mesh.shape[axis_name])
    hm = distributed.shard(halfspec_mask(full_mask, hp).float(), mesh,
                           (None, axis_name))
    re, im = rfft2_slab(x, mesh, axis_name, backend=backend)
    re, im = re * hm, im * hm
    return irfft2_slab(re, im, n1, mesh, axis_name, backend=backend)
