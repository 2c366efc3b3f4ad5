"""Time steppers over trees of spectral coefficients (counterpart of
``repro/core/solver/stepper.py``).

Two schemes, over any tree of tensors (a bare ``(re, im)`` pair for the
2-D vorticity solver, a dict of pairs for the 3-D Boussinesq system):

* ``rk4_step`` — classic explicit RK4 on the FULL right-hand side.
* ``ifrk4_step`` — integrating-factor RK4: the stiff diagonal linear
  part ``λ`` (viscous/diffusive decay, ``λ = -ν|k|²`` per mode) is
  integrated EXACTLY through ``e^{λh}`` factors and RK4 handles only
  the nonlinear remainder. With the nonlinear term identically zero
  (Taylor–Green, Beltrami) the update is the closed-form decay to
  round-off.

The step runs eagerly. The reference jits one whole step so that the
exchanges of different processes cannot interleave (several
computations in flight at once on its multi-process CPU backend). Here
every rank issues its collectives in program order, each on its mesh's
process group, so a step needs no single computation to stay in order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree_util import tree_map


def _axpy(a, x, y):
    """y + a·x, leafwise."""
    return tree_map(lambda xi, yi: yi + a * xi, x, y)


def rk4_step(rhs, state, dt):
    """One classic RK4 step of ``ds/dt = rhs(s)``."""
    k1 = rhs(state)
    k2 = rhs(_axpy(dt / 2.0, k1, state))
    k3 = rhs(_axpy(dt / 2.0, k2, state))
    k4 = rhs(_axpy(dt, k3, state))
    acc = tree_map(lambda a, b, c, d: a + 2.0 * (b + c) + d, k1, k2, k3, k4)
    return _axpy(dt / 6.0, acc, state)


def place_shared(place, tree):
    """``place`` applied leafwise to a tree of host arrays, once per
    distinct array object: leaves that are one array (the ``(λ, λ)``
    pairs of a decay tree) share one placed tensor."""
    done = {}

    def one(leaf):
        if id(leaf) not in done:
            done[id(leaf)] = place(leaf)
        return done[id(leaf)]
    return tree_map(one, tree)


def _host_f32(arr):
    return torch.from_numpy(np.asarray(arr, np.float32))


def exp_factors(decay, dt, place=None):
    """(e^{λh/2}, e^{λh}) trees for ``ifrk4_step`` from the per-leaf
    host-numpy decay-rate tree ``λ`` (structure-matching ``state``):
    ``exp`` in float64, then ``place`` (default: a float32 CPU tensor;
    a solver passes ``SpectralBasis.spectral_block``, which casts to
    float32 and cuts this rank's block)."""
    place = _host_f32 if place is None else place
    e_half = place_shared(
        lambda lam: place(np.exp(np.asarray(lam, np.float64) * (dt / 2.0))),
        decay)
    e_full = place_shared(
        lambda lam: place(np.exp(np.asarray(lam, np.float64) * dt)), decay)
    return e_half, e_full


def ifrk4_step(nrhs, state, dt, e_half, e_full):
    """One integrating-factor RK4 step of ``ds/dt = λs + N(s)``:
    ``N`` via ``nrhs``, ``λ`` via the precomputed ``exp_factors``."""
    def mul(e, s):
        return tree_map(lambda ei, si: ei * si, e, s)
    k1 = nrhs(state)
    k2 = nrhs(mul(e_half, _axpy(dt / 2.0, k1, state)))
    k3 = nrhs(_axpy(dt / 2.0, k2, mul(e_half, state)))
    k4 = nrhs(_axpy(dt, mul(e_half, k3), mul(e_full, state)))
    acc = tree_map(lambda e2, e1, a, b, c, d: e2 * a + 2.0 * e1 * (b + c) + d,
                   e_full, e_half, k1, k2, k3, k4)
    return _axpy(dt / 6.0, acc, mul(e_full, state))
