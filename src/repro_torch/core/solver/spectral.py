"""Layout-aware spectral basis — the glue between a PDE solver and the
distributed FFT plan cache (counterpart of
``repro/core/solver/spectral.py``).

A pseudo-spectral solver needs four things besides the transforms
themselves: per-axis wavenumber grids, the inverse Laplacian, a
dealiasing mask, and Hermitian multiplicity weights for energy sums.
All four depend on the *layout* the chosen schedule leaves its spectrum
in — natural order for slab/slab3d/pencil/pencil2d, four-step
digit-permuted on axis 0 for ``pencil_tf``/``fourstep1d``, and a
truncated and padded half axis for every r2c plan. ``SpectralBasis``
builds them all from the resolved plan, so solver code is written once
against ``(k, k2, dealias, weights)`` and runs unchanged under every
decomposition.

**Per-rank tables.** The reference keeps these tables as global arrays
and lets GSPMD cut them to each shard. Here a rank multiplies its own
block, so every device table is this rank's block of the global table
under the forward plan's OUTPUT spec (``plan.schedule().out_spec``):
a per-axis ``k`` view is cut along its own axis only, and the full-size
tables (``k2``, ``inv_k2``, ``dealias``) along every axis. The global
layout is the reference's: the digit permutation of axis 0 and the
padded half extent ``hp`` of the last axis are applied before the cut,
and a c2c plan's last axis is cut where its out spec splits it. A wrong
cut is invisible on one rank, which holds the whole table; the
four-rank tests (``tests/torch_ranks.py`` job ``solver``) guard it.
``k2_np``, ``inv_k2_np``, ``weights_np`` and ``kmag`` stay global on
the host: diagnostics gather the spectrum first, then use them.

The basis also owns placement and gathers. ``pencil_tf`` (and
``fourstep1d``) plans take their INPUT in cyclic order along axis 0, so
natural-layout initial conditions are permuted on the way in and
un-permuted on the way out. Pointwise products in real space — the only
thing a pseudo-spectral solver does there — are permutation-invariant,
so the solver never sees the cyclic layout. Gathers (``gather_real``,
``gather_spectral``) are collective over the mesh: every member rank
calls them and gets the global numpy array.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fft import distributed
from repro_torch.core.fft import plan as plan_mod
from repro_torch.core.fft.distributed import (CYCLIC_DECOMPS,
                                              cyclic_inverse_order,
                                              cyclic_order,
                                              fourstep_freq_of_position)
from repro_torch.core.fft.filters import (mask_fourstep_1d, mask_pencil_tf_3d,
                                          mask_pencil_tf_3d_r2c, mask_r2c,
                                          twothirds_mask)
from repro_torch.core.fft.plan import BACKWARD, FORWARD, plan_dft, plan_rfft
from repro_torch.core.fft.rfft import half_bins, spectral_half_extent


def _signed_freq(n: int) -> np.ndarray:
    """Integer wavenumbers in unshifted FFT order: 0,1,…,-n/2,…,-1."""
    return np.fft.fftfreq(n, d=1.0 / n)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU tensor the solver holds)."""
    t = t.detach()
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


class SpectralBasis:
    """Forward/backward plans plus the layout-matched spectral operators
    for one grid on one mesh (this rank's blocks of them).

    ``real=True`` (the default) plans r2c/c2r half-spectrum transforms;
    ``real=False`` runs the same physics through full c2c plans.
    ``decomp``/``backend`` accept the planner's ``"measure"`` sweeps —
    the backward plan is always built against the decomposition the
    forward plan RESOLVED to, so a tuned pair never disagrees about
    layout.
    """

    def __init__(self, shape: Sequence[int], mesh, *,
                 decomp: Optional[str] = None,
                 axis_names: Optional[Tuple[str, ...]] = None,
                 real: bool = True, backend: str = "auto",
                 overlap_chunks: int = 0, wire_dtype=None):
        self.shape = tuple(int(s) for s in shape)
        self.mesh = mesh
        self.real = bool(real)
        plan_fn = plan_rfft if self.real else plan_dft
        kw = dict(decomp=decomp, axis_names=axis_names, backend=backend,
                  overlap_chunks=overlap_chunks, wire_dtype=wire_dtype)
        self.fwd = plan_fn(self.shape, FORWARD, mesh, **kw)
        kw.update(decomp=self.fwd.decomp, axis_names=self.fwd.axis_names)
        self.bwd = plan_fn(self.shape, BACKWARD, mesh, **kw)
        self.decomp = self.fwd.decomp
        self.axis_names = self.fwd.axis_names
        # batched plans reuse the RESOLVED backend/wire of the tuned
        # forward plan — no second sweep for the batch_ndim variant
        self._backend = self.fwd.backend
        self._wire_dtype = self.fwd.wire_dtype
        self._fwd_b = None
        self._bwd_b = None
        self.cyclic = self.decomp in CYCLIC_DECOMPS
        self._p0 = mesh.shape[self.axis_names[0]]
        if self.real:
            self.hp = spectral_half_extent(self.decomp, self.shape[-1],
                                           mesh, self.axis_names)
            self.spectral_shape = self.shape[:-1] + (self.hp,)
        else:
            self.hp = None
            self.spectral_shape = self.shape
        # this rank's block of the spectral grid, per axis
        self._out_spec = tuple(self.fwd.schedule().out_spec)
        self._cut = distributed._slices(mesh, self._out_spec,
                                        self.spectral_shape, mesh.coordinate)
        self._build_wavenumbers()
        self._build_dealias()

    # -- this rank's blocks --------------------------------------------------
    def spectral_block(self, arr) -> torch.Tensor:
        """This rank's block of a global host table under the forward
        plan's output spec, as float32 on the mesh's device. Axes of
        extent 1 in ``arr`` (broadcast views such as a per-axis ``k``)
        are kept whole. The counterpart of the reference's
        ``replicated``: every stepper constant (decay rates, integrating
        factors) passes through it."""
        arr = np.asarray(arr)
        sl = tuple(cut if n == full else slice(None)
                   for cut, n, full in zip(self._cut, arr.shape,
                                           self.spectral_shape))
        block = np.ascontiguousarray(arr[sl], np.float32)
        return torch.from_numpy(block).to(self.mesh.device)

    # -- spectral operator tables -------------------------------------------
    def _axis_wavenumbers(self, ax: int) -> np.ndarray:
        n = self.shape[ax]
        if self.real and ax == len(self.shape) - 1:
            k = np.zeros(self.hp)
            k[: half_bins(n)] = np.arange(half_bins(n))
        else:
            k = _signed_freq(n)
            if ax == 0 and self.cyclic:
                k = k[fourstep_freq_of_position(n, self._p0)]
        return k

    def _build_wavenumbers(self) -> None:
        nd = len(self.shape)
        self.k = []
        k2 = np.zeros(self.spectral_shape)
        for ax in range(nd):
            view = [1] * nd
            view[ax] = self.spectral_shape[ax]
            k = self._axis_wavenumbers(ax).astype(np.float32).reshape(view)
            self.k.append(self.spectral_block(k))
            k2 = k2 + k.astype(np.float64) ** 2
        self.k2_np = k2
        self.k2 = self.spectral_block(k2)
        self.inv_k2_np = np.where(k2 > 0, 1.0 / np.maximum(k2, 1e-30),
                                  0.0).astype(np.float32)
        self.inv_k2 = self.spectral_block(self.inv_k2_np)
        self.kmag = np.sqrt(k2)
        # Hermitian multiplicity of each stored bin under Parseval: the
        # half layout keeps only k_last >= 0, so interior bins stand in
        # for their conjugate partners (x2), the k_last=0 plane and (even
        # n) Nyquist plane are self-conjugate (x1), pad columns hold
        # nothing (x0). c2c spectra store every bin once.
        if self.real:
            n = self.shape[-1]
            w = np.zeros(self.hp)
            h = half_bins(n)
            w[:h] = 2.0
            w[0] = 1.0
            if n % 2 == 0:
                w[h - 1] = 1.0
            view = [1] * nd
            view[-1] = self.hp
            self.weights_np = w.astype(np.float32).reshape(view)
        else:
            self.weights_np = np.ones((1,) * nd, np.float32)
        self.weights = self.spectral_block(self.weights_np)
        self.norm = float(np.prod(self.shape))

    def _build_dealias(self) -> None:
        if self.real:
            if self.decomp == "pencil_tf":
                m = mask_pencil_tf_3d_r2c(self.shape, self._p0, self.hp,
                                          build=twothirds_mask)
            else:
                m = mask_r2c(self.shape, self.hp, build=twothirds_mask)
        elif self.decomp == "pencil_tf":
            m = mask_pencil_tf_3d(self.shape, self._p0,
                                  build=twothirds_mask)
        elif self.decomp == "fourstep1d":
            m = mask_fourstep_1d(self.shape[0], self._p0,
                                 build=twothirds_mask)
        else:
            m = twothirds_mask(self.shape)
        self.dealias = self.spectral_block(m.numpy())

    # -- batched plans -------------------------------------------------------
    # A pseudo-spectral RHS needs several independent transforms per
    # stage (velocities, gradients, flux components). Solvers stack the
    # fields on a leading batch axis and run ONE ``batch_ndim=1`` plan
    # per direction per stage: one exchange of one large message instead
    # of one small one per field.
    @property
    def fwd_batch(self):
        if self._fwd_b is None:
            self._fwd_b = self._plan_batched(FORWARD)
        return self._fwd_b

    @property
    def bwd_batch(self):
        if self._bwd_b is None:
            self._bwd_b = self._plan_batched(BACKWARD)
        return self._bwd_b

    def _plan_batched(self, direction):
        plan_fn = plan_rfft if self.real else plan_dft
        return plan_fn(self.shape, direction, self.mesh,
                       decomp=self.decomp, axis_names=self.axis_names,
                       backend=self._backend, wire_dtype=self._wire_dtype,
                       batch_ndim=1)

    def forward_batch(self, x):
        """(B, *block) real stack → batched spectral pair."""
        if self.real:
            return self.fwd_batch.execute(x)
        return self.fwd_batch.execute(x, torch.zeros_like(x))

    def to_real_batch(self, re, im):
        """Batched spectral pair → (B, *block) real stack."""
        out = self.bwd_batch.execute(re, im)
        return out[0] if isinstance(out, tuple) else out

    # -- placement / transforms ---------------------------------------------
    def forward(self, x):
        """This rank's real block (plan spatial layout) → spectral
        pair."""
        if self.real:
            return self.fwd.execute(x)
        return self.fwd.execute(x, torch.zeros_like(x))

    def to_real(self, re, im):
        """Spectral pair → this rank's real block (plan spatial
        layout)."""
        out = self.bwd.execute(re, im)
        return out[0] if isinstance(out, tuple) else out

    def to_spectral(self, x: np.ndarray):
        """Natural-layout numpy real field → this rank's spectral
        pair."""
        x = np.asarray(x, np.float32)
        if x.shape != self.shape:
            raise ValueError(f"field of shape {x.shape} for the grid "
                             f"{self.shape}")
        if self.cyclic:
            x = x[cyclic_order(self.shape[0], self._p0)]
        return self.fwd.execute(*self.fwd.place(x))

    def gather_real(self, x) -> np.ndarray:
        """This rank's real block (plan spatial layout) → the natural
        global numpy field (collective)."""
        x = _to_numpy(self.bwd.unplace(x))
        if self.cyclic:
            x = x[cyclic_inverse_order(self.shape[0], self._p0)]
        return x

    def gather_spectral(self, x) -> np.ndarray:
        """This rank's spectral leaf → the global numpy leaf in the plan's
        own layout (collective; no un-permutation: checkpoints restore
        into the same basis)."""
        return _to_numpy(self.fwd.unplace(x))

    def place_spectral(self, arr: np.ndarray) -> torch.Tensor:
        """Global numpy spectral leaf (plan layout) → this rank's block
        under the forward plan's output spec, on the mesh's device."""
        return distributed.shard(np.asarray(arr, np.float32), self.mesh,
                                 self._out_spec)

    def plan_stats(self) -> dict:
        """Subset of ``plan_cache_stats`` a solver run reports."""
        st = plan_mod.plan_cache_stats()
        return {k: st.get(k, 0) for k in
                ("hits", "misses", "wisdom_hits", "sweep_candidates_timed")}
