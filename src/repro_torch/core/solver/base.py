"""Shared machinery for plan-cache-driven pseudo-spectral solvers
(counterpart of ``repro/core/solver/base.py``): state management,
stepping, Parseval diagnostics, spectrum payloads for the in-situ chain,
and checkpoint/restart via ``ckpt/checkpoint.py``.

Subclasses provide ``_nonlinear(state)`` (the dealiased nonlinear RHS
tree) and a ``_decay_tree`` (per-leaf ``λ = -ν|k|²`` host arrays);
everything else — RK4 vs integrating-factor stepping, energy sums,
restart — lives here once, so the 3-D Boussinesq system reuses the 2-D
vorticity solver's stepper verbatim.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint
from repro_torch.core.fft.spectrum import radial_spectrum_k
from repro_torch.core.solver.spectral import SpectralBasis
from repro_torch.core.solver.stepper import (exp_factors, ifrk4_step,
                                             place_shared, rk4_step)
from repro_torch.tree_util import tree_map

STEPPERS = ("rk4", "if_rk4")


class SpectralSolverBase:
    """A time-stepping loop over a spectral state tree.

    ``state`` leaves are (re, im) float32 tensors, this rank's blocks in
    the basis' spectral layout; subclasses initialize it (and may
    re-initialize freely — plans are cached process-wide, so a fresh
    solver on the same grid and mesh reuses the transforms)."""

    def __init__(self, basis: SpectralBasis, *, dt: float,
                 stepper: str = "if_rk4"):
        if stepper not in STEPPERS:
            raise ValueError(f"stepper must be one of {STEPPERS}, got "
                             f"{stepper!r}")
        self.basis = basis
        self.dt = float(dt)
        self.stepper = stepper
        self.t = 0.0
        self.step_count = 0
        self.state = None
        self._decay_tree = None    # subclass sets, then calls _finalize_setup
        self._e_half = None
        self._e_full = None
        self._decay_dev = None

    def _finalize_setup(self) -> None:
        """Place the stepper constants: ``_decay_tree`` leaves arrive as
        global host numpy, and every leaf the stepper multiplies into the
        state is cut to this rank's block (``SpectralBasis.
        spectral_block``); leaves that are one array share one tensor."""
        block = self.basis.spectral_block
        if self.stepper == "rk4":
            self._decay_dev = place_shared(block, self._decay_tree)
        else:
            self._e_half, self._e_full = exp_factors(self._decay_tree,
                                                     self.dt, place=block)

    # -- subclass hooks ------------------------------------------------------
    def _nonlinear(self, state):
        raise NotImplementedError

    def _rhs_full(self, state):
        n = self._nonlinear(state)
        return tree_map(lambda ni, lam, si: ni + lam * si, n,
                        self._decay_dev, state)

    # -- stepping ------------------------------------------------------------
    def step(self, n: int = 1) -> None:
        if self.state is None:
            raise RuntimeError("initialize the solver state first")
        # the steppers are called here, not kept in a closure over self: a
        # solver must hold no reference cycle, so that dropping it frees
        # its device tensors at once, not at the next garbage collection
        for _ in range(n):
            if self.stepper == "rk4":
                self.state = rk4_step(self._rhs_full, self.state, self.dt)
            else:
                self.state = ifrk4_step(self._nonlinear, self.state, self.dt,
                                        self._e_half, self._e_full)
            self.step_count += 1
            # derived, not accumulated: t must survive a checkpoint
            # round-trip exactly (restore recomputes it from the step)
            self.t = self.step_count * self.dt

    # -- Parseval diagnostics ------------------------------------------------
    # Diagnostics gather the spectral state to host numpy first: every
    # rank of the mesh reaches the same gather in program order, and the
    # float64 arithmetic after it is the same on every rank.
    def _weighted_sum(self, pair, extra=None) -> float:
        """0.5·Σ w·|ŝ|²/N² (+optional extra per-mode factor) — the
        Parseval mean-square of the real field, Hermitian-corrected."""
        b = self.basis
        re = np.asarray(b.gather_spectral(pair[0]), np.float64)
        im = np.asarray(b.gather_spectral(pair[1]), np.float64)
        p = (re * re + im * im) * np.asarray(b.weights_np, np.float64)
        if extra is not None:
            p = p * np.asarray(extra, np.float64)
        return float(np.sum(p)) * 0.5 / (b.norm * b.norm)

    def spectrum_pair(self, pair, nbins: int = 32, *, extra=None):
        """Shell-summed E(k) of one spectral pair through the basis'
        layout-matched wavenumbers (``radial_spectrum_k``), on the host;
        (centers, E) as numpy."""
        b = self.basis
        w = np.asarray(b.weights_np, np.float64) * (0.5 / (b.norm * b.norm))
        if extra is not None:
            w = w * np.asarray(extra, np.float64)
        re = torch.from_numpy(b.gather_spectral(pair[0]))
        im = torch.from_numpy(b.gather_spectral(pair[1]))
        # float32 weights, as the reference's product runs in float32
        centers, e = radial_spectrum_k(
            re, im, b.kmag, nbins,
            weights=torch.from_numpy(w.astype(np.float32)))
        return centers.numpy(), e.numpy()

    # -- checkpoint / restart ------------------------------------------------
    def _ckpt_tree(self) -> Dict:
        gather = self.basis.gather_spectral
        return {"state": tree_map(gather, self.state),
                "t": np.float64(self.t),
                "step": np.int64(self.step_count)}

    def save(self, ckpt_dir, *, keep: int = 3):
        """Checkpoint the spectral state (atomic step dir + manifest);
        collective over the mesh (the state is gathered)."""
        if self.state is None:
            raise RuntimeError("initialize the solver state first")
        return checkpoint.save(ckpt_dir, self.step_count,
                               self._ckpt_tree(), keep=keep)

    def restore(self, ckpt_dir, step: Optional[int] = None) -> int:
        """Restore state from ``ckpt_dir`` (latest step by default) and
        resume; each leaf goes back to this rank's block under the plan's
        output spec, so the continuation is bit-identical to an
        uninterrupted run on the same mesh."""
        if self.state is None:
            raise RuntimeError("build the solver (any init) before "
                               "restoring into it")
        if step is None:
            step = checkpoint.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        # the target's structure and global shapes, without a gather
        shape = self.basis.spectral_shape
        leaf = np.broadcast_to(np.float32(0), shape)
        template = {"state": tree_map(lambda _: leaf, self.state),
                    "t": np.float64(0), "step": np.int64(0)}
        place = {"state": tree_map(lambda _: self.basis.place_spectral,
                                   self.state),
                 "t": None, "step": None}
        tree = checkpoint.restore(ckpt_dir, step, template, place=place)
        self.state = tree["state"]
        self.step_count = int(tree["step"])
        # recomputed, not read back, as the reference does
        self.t = self.step_count * self.dt
        return step
