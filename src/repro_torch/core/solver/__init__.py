"""Pseudo-spectral solver suite (counterpart of ``repro/core/solver/``):
the simulation that produces the fields the in-situ chain analyses, every
stage of it on the cached FFT plans.

* ``spectral.SpectralBasis`` — plans + layout-matched wavenumbers,
  2/3-rule dealiasing, Hermitian weights for every decomposition, each
  cut to this rank's block.
* ``stepper`` — RK4 and integrating-factor RK4 over state trees.
* ``ns2d.NS2DSolver`` — 2-D incompressible Navier–Stokes (vorticity).
* ``bq3d.Boussinesq3DSolver`` — 3-D Boussinesq convection, same
  stepper/base machinery.

``launch/solver.py`` is their entry point.
"""
from repro_torch.core.solver.base import SpectralSolverBase
from repro_torch.core.solver.bq3d import Boussinesq3DSolver
from repro_torch.core.solver.ns2d import NS2DSolver
from repro_torch.core.solver.spectral import SpectralBasis

__all__ = ["SpectralBasis", "SpectralSolverBase", "NS2DSolver",
           "Boussinesq3DSolver"]
