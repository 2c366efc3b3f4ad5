"""3-D Boussinesq convection, rotational-form pseudo-spectral
(counterpart of ``repro/core/solver/bq3d.py``).

    ∂u/∂t = P[u×ω + g·b·ê₀] + ν∇²u
    ∂b/∂t = −u·∇b + κ∇²b,            ∇·u = 0

after spectralDNS' ``Bq2D``/``MHD`` family: velocity nonlinearity in
rotational form (the ∇|u|²/2 part is absorbed by the Leray projection
``P = I − kk/k²``), buoyancy ``b`` accelerating the vertical (axis-0)
velocity with coefficient ``gravity``, scalar advection in convective
form. Reuses the 2-D solver's machinery wholesale: the same
``SpectralSolverBase`` steppers, the same basis-supplied layout-aware
wavenumbers/dealiasing, the same cached plans — with fatter batches per
RHS (one 9-field batched inverse + one 4-field batched forward).

Beltrami (ABC) fields satisfy ∇×u = u, so u×ω ≡ 0 and viscous decay
``u(t) = u₀·e^{−νt}`` is exact — the 3-D analytic oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.solver.base import SpectralSolverBase
from repro_torch.core.solver.spectral import SpectralBasis

_U = ("u0", "u1", "u2")


class Boussinesq3DSolver(SpectralSolverBase):
    """State: ``{"u0","u1","u2","b"}`` → (re, im) spectral pairs."""

    def __init__(self, shape: Tuple[int, int, int], mesh, *,
                 nu: float = 1e-3, kappa: float = 1e-3,
                 gravity: float = 0.0, dt: float = 1e-2,
                 decomp: Optional[str] = None, axis_names=None,
                 real: bool = True, backend: str = "auto",
                 wire_dtype=None, stepper: str = "if_rk4"):
        if len(shape) != 3:
            raise ValueError(f"Boussinesq3DSolver wants a 3-D grid, got "
                             f"{shape}")
        basis = SpectralBasis(shape, mesh, decomp=decomp,
                              axis_names=axis_names, real=real,
                              backend=backend, wire_dtype=wire_dtype)
        super().__init__(basis, dt=dt, stepper=stepper)
        self.nu = float(nu)
        self.kappa = float(kappa)
        self.gravity = float(gravity)
        # host numpy decay rates; cut to this rank's block in finalize
        d_nu, d_kap = -self.nu * basis.k2_np, -self.kappa * basis.k2_np
        self._decay_tree = {"u0": (d_nu, d_nu), "u1": (d_nu, d_nu),
                            "u2": (d_nu, d_nu), "b": (d_kap, d_kap)}
        self._finalize_setup()
        self._nlmask = basis.dealias * (basis.k2 > 0).float()

    # -- RHS pieces ----------------------------------------------------------
    def _spectral_ops(self, u0r, u0i, u1r, u1i, u2r, u2i, br, bi):
        """State → stacked (u₀,u₁,u₂, ω₀,ω₁,ω₂, ∂₀b,∂₁b,∂₂b) batch:
        ω̂ = ik×û, ∇̂b = ikb̂ (i·(re,im) = (−im, re)). One (9, …) stack →
        ONE batched c2r execute."""
        k0, k1, k2 = self.basis.k
        c0r, c0i = k1 * u2r - k2 * u1r, k1 * u2i - k2 * u1i
        c1r, c1i = k2 * u0r - k0 * u2r, k2 * u0i - k0 * u2i
        c2r_, c2i = k0 * u1r - k1 * u0r, k0 * u1i - k1 * u0i
        res = torch.stack((u0r, u1r, u2r, -c0i, -c1i, -c2i,
                           -k0 * bi, -k1 * bi, -k2 * bi))
        ims = torch.stack((u0i, u1i, u2i, c0r, c1r, c2r_,
                           k0 * br, k1 * br, k2 * br))
        return res, ims

    @staticmethod
    def _products(w):
        """(9, …) real batch → stacked (u×ω, −u·∇b) → ONE batched r2c
        execute."""
        u0, u1, u2, w0, w1, w2, g0, g1, g2 = w
        return torch.stack((u1 * w2 - u2 * w1, u2 * w0 - u0 * w2,
                            u0 * w1 - u1 * w0,
                            -(u0 * g0 + u1 * g1 + u2 * g2)))

    def _assemble(self, nre, nim, br, bi):
        """Dealias, add buoyancy along axis 0, Leray-project the momentum
        force; mask the scalar RHS."""
        k0, k1, k2 = self.basis.k
        inv_k2, nlmask, grav = self.basis.inv_k2, self._nlmask, self.gravity
        n0r, n1r, n2r, tr = nre
        n0i, n1i, n2i, ti = nim
        m0r, m0i = (n0r + grav * br) * nlmask, (n0i + grav * bi) * nlmask
        m1r, m1i = n1r * nlmask, n1i * nlmask
        m2r, m2i = n2r * nlmask, n2i * nlmask
        dr = (k0 * m0r + k1 * m1r + k2 * m2r) * inv_k2
        di = (k0 * m0i + k1 * m1i + k2 * m2i) * inv_k2
        return {"u0": (m0r - k0 * dr, m0i - k0 * di),
                "u1": (m1r - k1 * dr, m1i - k1 * di),
                "u2": (m2r - k2 * dr, m2i - k2 * di),
                "b": (tr * nlmask, ti * nlmask)}

    def _project_init(self, n0r, n0i, n1r, n1i, n2r, n2i):
        """Leray projection alone (divergence-free initial data)."""
        k0, k1, k2 = self.basis.k
        inv_k2 = self.basis.inv_k2
        dr = (k0 * n0r + k1 * n1r + k2 * n2r) * inv_k2
        di = (k0 * n0i + k1 * n1i + k2 * n2i) * inv_k2
        return ((n0r - k0 * dr, n0i - k0 * di),
                (n1r - k1 * dr, n1i - k1 * di),
                (n2r - k2 * dr, n2i - k2 * di))

    def _mask_pair(self, re, im):
        return re * self._nlmask, im * self._nlmask

    def _nonlinear(self, state):
        b = self.basis
        flat = [c for k in _U for c in state[k]] + list(state["b"])
        w = b.to_real_batch(*self._spectral_ops(*flat))
        nre, nim = b.forward_batch(self._products(w))
        return self._assemble(nre, nim, *state["b"])

    # -- initialization ------------------------------------------------------
    def init_fields(self, u: Tuple[np.ndarray, np.ndarray, np.ndarray],
                    b: Optional[np.ndarray] = None, *,
                    project: bool = True) -> None:
        """Set the state from natural-layout real fields; velocity is
        dealiased and (by default) Leray-projected so the run starts
        divergence-free."""
        basis = self.basis
        pairs = [self._mask_pair(*basis.to_spectral(ui)) for ui in u]
        if project:
            pairs = list(self._project_init(
                *[c for p in pairs for c in p]))
        bf = (np.zeros(basis.shape, np.float32) if b is None else b)
        self.state = {"u0": pairs[0], "u1": pairs[1], "u2": pairs[2],
                      "b": self._mask_pair(*basis.to_spectral(bf))}
        self.t = 0.0
        self.step_count = 0

    def init_beltrami(self, A: float = 1.0, B: float = 1.0,
                      C: float = 1.0) -> None:
        """ABC flow — an eigenfield of curl (∇×u = u), hence an exact
        decaying NS solution."""
        n0, n1, n2 = self.basis.shape
        x = (2.0 * np.pi * np.arange(n0) / n0)[:, None, None]
        y = (2.0 * np.pi * np.arange(n1) / n1)[None, :, None]
        z = (2.0 * np.pi * np.arange(n2) / n2)[None, None, :]
        shape = self.basis.shape
        u0 = np.broadcast_to(A * np.sin(z) + C * np.cos(y), shape)
        u1 = np.broadcast_to(B * np.sin(x) + A * np.cos(z), shape)
        u2 = np.broadcast_to(C * np.sin(y) + B * np.cos(x), shape)
        self.init_fields((u0, u1, u2), project=False)

    def init_random(self, seed: int = 0, kpeak: int = 2,
                    amplitude: float = 1.0, b_amplitude: float = 1.0
                    ) -> None:
        """Smooth random solenoidal velocity + random buoyancy
        (deterministic in ``seed``, identical across schedules)."""
        rng = np.random.default_rng(seed)
        shape = self.basis.shape
        fields = []
        for _ in range(4):
            spec = np.fft.rfftn(rng.standard_normal(shape))
            ks = [np.minimum(np.arange(n), n - np.arange(n))
                  for n in shape[:-1]] + [np.arange(spec.shape[-1])]
            keep = ((ks[0][:, None, None] <= kpeak)
                    & (ks[1][None, :, None] <= kpeak)
                    & (ks[2][None, None, :] <= kpeak))
            keep[0, 0, 0] = False
            f = np.fft.irfftn(spec * keep, s=shape, axes=(0, 1, 2))
            fields.append(f / max(np.abs(f).max(), 1e-12))
        self.init_fields(tuple(amplitude * f for f in fields[:3]),
                         b_amplitude * fields[3])

    # -- diagnostics ---------------------------------------------------------
    def field(self, name: str) -> np.ndarray:
        """Natural-layout real field: ``u0``/``u1``/``u2``/``b``
        (collective)."""
        return self.basis.gather_real(self.basis.to_real(*self.state[name]))

    def energy(self) -> float:
        """Kinetic energy ½⟨|u|²⟩."""
        return sum(self._weighted_sum(self.state[k]) for k in _U)

    def scalar_variance(self) -> float:
        """½⟨b²⟩."""
        return self._weighted_sum(self.state["b"])

    def spectrum(self, nbins: int = 32):
        """Shell-summed kinetic-energy spectrum E(k)."""
        centers, e = self.spectrum_pair(self.state["u0"], nbins)
        for k in _U[1:]:
            e = e + self.spectrum_pair(self.state[k], nbins)[1]
        return centers, e
