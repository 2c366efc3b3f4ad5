"""2-D incompressible Navier–Stokes, vorticity form, pseudo-spectral
(counterpart of ``repro/core/solver/ns2d.py``).

    ∂ω/∂t + u·∇ω = ν∇²ω,   u = (∂ψ/∂y, −∂ψ/∂x),   ∇²ψ = −ω

on the periodic box [0,2π)², after spectralDNS' ``NS2D`` solver but
driven entirely through the distributed plan cache: every velocity /
gradient inverse transform and the forward transform of the advection
product go through the cached plans (``plan_rfft`` fwd/bwd — or
``plan_dft`` with ``real=False``). The nonlinear term is 2/3-rule
dealiased through the basis' layout-matched mask; per-RHS cost is ONE
batched 4-field inverse (u, v, ∂ₓω, ∂ᵧω stacked on a ``batch_ndim=1``
plan) + one forward transform.

Taylor–Green, ``ω = 2 sin x sin y``, is an exact solution whose
Jacobian vanishes identically, giving closed-form decay
``ω(t) = ω₀·e^{−2νt}`` — the analytic oracle of the tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.solver.base import SpectralSolverBase
from repro_torch.core.solver.spectral import SpectralBasis


class NS2DSolver(SpectralSolverBase):
    """State: one (re, im) pair holding the vorticity spectrum ω̂."""

    def __init__(self, shape: Tuple[int, int], mesh, *, nu: float = 1e-3,
                 dt: float = 1e-2, decomp: Optional[str] = None,
                 axis_names=None, real: bool = True, backend: str = "auto",
                 wire_dtype=None, stepper: str = "if_rk4"):
        if len(shape) != 2:
            raise ValueError(f"NS2DSolver wants a 2-D grid, got {shape}")
        basis = SpectralBasis(shape, mesh, decomp=decomp,
                              axis_names=axis_names, real=real,
                              backend=backend, wire_dtype=wire_dtype)
        super().__init__(basis, dt=dt, stepper=stepper)
        self.nu = float(nu)
        decay = -self.nu * basis.k2_np      # host numpy; placed in finalize
        self._decay_tree = (decay, decay)
        self._finalize_setup()
        # dealias + zero the k=0 bin: the Jacobian is a divergence, so
        # its mean is zero analytically — pinning it keeps mean(ω)
        # exactly conserved instead of drifting at round-off
        self._nlmask = basis.dealias * (basis.k2 > 0).float()

    # -- RHS pieces ----------------------------------------------------------
    def _spectral_ops(self, re, im):
        """ω̂ → stacked (û, v̂, ∂xω̂, ∂yω̂) batch: ψ̂ = ω̂/k²,
        û = ik₁ψ̂, v̂ = −ik₀ψ̂; i·(re,im)·k = (−k·im, k·re). One (4, …)
        stack → ONE batched c2r execute."""
        b = self.basis
        k0, k1 = b.k
        pre, pim = re * b.inv_k2, im * b.inv_k2
        res = torch.stack((-k1 * pim, k0 * pim, -k0 * im, -k1 * im))
        ims = torch.stack((k1 * pre, -k0 * pre, k0 * re, k1 * re))
        return res, ims

    @staticmethod
    def _advect(w):
        u, v, wx, wy = w
        return -(u * wx + v * wy)

    def _dealias(self, re, im):
        return re * self._nlmask, im * self._nlmask

    def _nonlinear(self, state):
        b = self.basis
        w = b.to_real_batch(*self._spectral_ops(*state))
        return self._dealias(*b.forward(self._advect(w)))

    # -- initialization ------------------------------------------------------
    def init_vorticity(self, w0: np.ndarray) -> None:
        """Set the state from a natural-layout real vorticity field
        (dealiased on entry so step 0 already lives in the resolved
        band)."""
        self.state = self._dealias(*self.basis.to_spectral(w0))
        self.t = 0.0
        self.step_count = 0

    def init_taylor_green(self, amplitude: float = 1.0) -> None:
        """ω₀ = 2A·sin x·sin y (the ψ = A·sin x·sin y vortex array)."""
        n0, n1 = self.basis.shape
        x = 2.0 * np.pi * np.arange(n0) / n0
        y = 2.0 * np.pi * np.arange(n1) / n1
        self.init_vorticity(2.0 * amplitude
                            * np.outer(np.sin(x), np.sin(y)))

    def init_random(self, seed: int = 0, kpeak: int = 4,
                    amplitude: float = 1.0) -> None:
        """Smooth random field: white noise low-passed to |k| ≤ kpeak
        per axis (deterministic in ``seed``; built in numpy so every
        schedule sees the identical initial condition)."""
        n0, n1 = self.basis.shape
        rng = np.random.default_rng(seed)
        spec = np.fft.rfft2(rng.standard_normal((n0, n1)))
        kx = np.minimum(np.arange(n0), n0 - np.arange(n0))
        ky = np.arange(spec.shape[1])
        keep = (kx[:, None] <= kpeak) & (ky[None, :] <= kpeak)
        keep[0, 0] = False
        w = np.fft.irfft2(spec * keep, s=(n0, n1))
        self.init_vorticity(amplitude * w / max(np.abs(w).max(), 1e-12))

    # -- diagnostics ---------------------------------------------------------
    def vorticity(self) -> np.ndarray:
        """Natural-layout real ω (collective)."""
        return self.basis.gather_real(self.basis.to_real(*self.state))

    def energy(self) -> float:
        """Kinetic energy ½⟨|u|²⟩ = ½·Σ w·|ω̂|²/k² /N²."""
        return self._weighted_sum(self.state, extra=self.basis.inv_k2_np)

    def enstrophy(self) -> float:
        """½⟨ω²⟩."""
        return self._weighted_sum(self.state)

    def spectrum(self, nbins: int = 32, kind: str = "energy"):
        """Shell-summed E(k) (``kind="energy"``) or Z(k)
        (``kind="enstrophy"``)."""
        extra = self.basis.inv_k2_np if kind == "energy" else None
        return self.spectrum_pair(self.state, nbins, extra=extra)
