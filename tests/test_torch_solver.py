"""The port's pseudo-spectral solvers (``repro_torch/core/solver``) and
``launch/solver.py`` on one device, in process, against the reference's
(``repro/core/solver``) on a one-device mesh: the same numpy initial
conditions from a seed, 5 steps, the real fields within 1e-4 of max
|ref| (the reference's cross-schedule bar, ``tests/test_solver.py``);
the basis tables equal to the reference's; the analytic oracles of
``tests/test_solver.py`` on the port alone (1e-5); restart bit-identical;
a warm-wisdom bring-up with no timed sweep; a checkpoint the reference's
solver wrote, continued in the port; and the launcher's summary, restore
and refusals. The four-rank checks are in
``tests/test_torch_solver_ranks.py``."""
import gc
import json
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.compat import make_mesh as jax_make_mesh
from repro.core.solver import Boussinesq3DSolver as JBq3d
from repro.core.solver import NS2DSolver as JNS2D
from repro.core.solver import SpectralBasis as JBasis
from repro.launch import solver as jax_launch
from repro_torch.compat import make_mesh
from repro_torch.core.fft import plan as plan_mod
from repro_torch.core.solver import (Boussinesq3DSolver, NS2DSolver,
                                     SpectralBasis)
from repro_torch.launch import solver as launch
from repro_torch.tree_util import tree_leaves

FIELD_TOL = 1e-4      # tests/test_solver.py:274, relative to max |ref|
ORACLE_TOL = 1e-5     # tests/test_solver.py:202
STEPS = 5

AXES = {1: ("data",), 2: ("data", "model")}


def _meshes(ndim):
    names = AXES[ndim]
    return (jax_make_mesh((1,) * ndim, names, devices=jax.devices()[:1]),
            make_mesh((1,) * ndim, names, device="cpu"))


def _relerr(want, got):
    return float(np.max(np.abs(want - got)) / np.max(np.abs(want)))


# (init, stepper, real) for NS2D 32^2; the Boussinesq 16^3 cases
NS2D_CASES = [(init, stepper, real) for init in ("taylor-green", "random")
              for stepper in ("if_rk4", "rk4") for real in (True, False)]
BQ3D_CASES = [("beltrami", "if_rk4", True), ("random", "if_rk4", True),
              ("random", "rk4", False)]


@pytest.mark.parametrize("init,stepper,real", NS2D_CASES)
def test_ns2d_matches_the_reference(init, stepper, real):
    jmesh, tmesh = _meshes(1)
    kw = dict(nu=5e-3, dt=5e-3, decomp="slab", stepper=stepper, real=real)
    ref = JNS2D((32, 32), jmesh, axis_names=("data",), **kw)
    port = NS2DSolver((32, 32), tmesh, **kw)
    for s in (ref, port):
        if init == "taylor-green":
            s.init_taylor_green()
        else:
            s.init_random(seed=3)
        s.step(STEPS)
    want, got = np.asarray(ref.vorticity()), port.vorticity()
    assert got.shape == want.shape == (32, 32)
    assert _relerr(want, got) < FIELD_TOL
    assert abs(port.energy() - ref.energy()) / ref.energy() < FIELD_TOL
    assert abs(port.enstrophy() - ref.enstrophy()) / ref.enstrophy() \
        < FIELD_TOL
    _, e_ref = ref.spectrum(8)
    _, e_port = port.spectrum(8)
    assert _relerr(np.asarray(e_ref), e_port) < FIELD_TOL


@pytest.mark.parametrize("init,stepper,real", BQ3D_CASES)
def test_bq3d_matches_the_reference(init, stepper, real):
    jmesh, tmesh = _meshes(1)
    kw = dict(nu=0.02, kappa=0.02, gravity=1.0, dt=5e-3, decomp="slab3d",
              stepper=stepper, real=real)
    ref = JBq3d((16, 16, 16), jmesh, axis_names=("data",), **kw)
    port = Boussinesq3DSolver((16, 16, 16), tmesh, **kw)
    for s in (ref, port):
        if init == "beltrami":
            s.init_beltrami()
        else:
            s.init_random(seed=5)
        s.step(STEPS)
    for name in ("u0", "u1", "u2", "b"):
        want = np.asarray(ref.field(name))
        if np.max(np.abs(want)) > 0:
            assert _relerr(want, port.field(name)) < FIELD_TOL, name
    assert abs(port.energy() - ref.energy()) / ref.energy() < FIELD_TOL
    _, e_ref = ref.spectrum(8)
    _, e_port = port.spectrum(8)
    assert _relerr(np.asarray(e_ref), e_port) < FIELD_TOL


# (decomp, grid) for the basis tables; both r2c and c2c
BASES = [("slab", (16, 24)), ("slab3d", (8, 12, 16)),
         ("pencil", (8, 12, 16)), ("pencil_tf", (8, 12, 16))]


@pytest.mark.parametrize("real", [True, False], ids=["r2c", "c2c"])
@pytest.mark.parametrize("decomp,grid", BASES, ids=[d for d, _ in BASES])
def test_basis_tables_match_the_reference(decomp, grid, real):
    ndim = 2 if decomp in ("pencil", "pencil_tf") else 1
    jmesh, tmesh = _meshes(ndim)
    ref = JBasis(grid, jmesh, decomp=decomp, real=real)
    port = SpectralBasis(grid, tmesh, decomp=decomp, real=real)
    assert (port.hp, port.spectral_shape, port.cyclic) == \
        (ref.hp, ref.spectral_shape, ref.cyclic)
    for k_ref, k_port in zip(ref.k, port.k):
        np.testing.assert_array_equal(np.asarray(k_ref), k_port.numpy())
    for name in ("k2", "inv_k2", "dealias", "weights"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name).numpy(), name)
    np.testing.assert_array_equal(ref.k2_np, port.k2_np)
    np.testing.assert_array_equal(ref.kmag, port.kmag)
    assert ref.norm == port.norm


ORACLES = ("tg_if_rk4", "tg_rk4", "inviscid", "beltrami", "buoyancy")


@pytest.mark.parametrize("case", ORACLES)
def test_analytic_oracles(case):
    """``tests/test_solver.py``'s closed forms on the port alone:
    Taylor–Green decays as E0·e^{-4νt} under both steppers; inviscid RK4
    conserves energy and enstrophy, and Σ E(k) is the energy; Beltrami
    decays as E0·e^{-2νt}; gravity turns scalar variance into kinetic
    energy from rest."""
    _, mesh = _meshes(1)
    if case.startswith("tg"):
        nu, dt, steps = 0.1, 0.01, 25
        s = NS2DSolver((32, 32), mesh, nu=nu, dt=dt, decomp="slab",
                       stepper=case[3:])
        s.init_taylor_green()
        e0 = s.energy()
        s.step(steps)
        want = e0 * float(np.exp(-4.0 * nu * steps * dt))
        assert abs(s.energy() - want) / want < ORACLE_TOL
    elif case == "inviscid":
        s = NS2DSolver((32, 32), mesh, nu=0.0, dt=2e-3, decomp="slab",
                       stepper="rk4")
        s.init_random(seed=3)
        e0, z0 = s.energy(), s.enstrophy()
        s.step(20)
        assert abs(s.energy() - e0) / e0 < ORACLE_TOL
        assert abs(s.enstrophy() - z0) / z0 < ORACLE_TOL
        _, ek = s.spectrum(12)
        assert abs(float(np.sum(ek)) - s.energy()) / s.energy() < ORACLE_TOL
    elif case == "beltrami":
        nu, dt, steps = 0.05, 0.01, 15
        b = Boussinesq3DSolver((16, 16, 16), mesh, nu=nu, dt=dt,
                               decomp="slab3d")
        b.init_beltrami()
        e0 = b.energy()
        b.step(steps)
        want = e0 * float(np.exp(-2.0 * nu * steps * dt))
        assert abs(b.energy() - want) / want < ORACLE_TOL
    else:
        g = Boussinesq3DSolver((16, 16, 16), mesh, gravity=1.0, dt=0.01,
                               decomp="slab3d")
        g.init_random(seed=1, amplitude=0.0, b_amplitude=1.0)
        assert g.energy() == 0.0
        g.step(5)
        assert g.energy() > 0.0


def _gathered(s):
    return [s.basis.gather_spectral(x) for x in tree_leaves(s.state)]


@pytest.mark.parametrize("solver", ["ns2d", "bq3d"])
def test_restart_bit_identical(solver, tmp_path):
    """8 uninterrupted steps against 4, save, restore into a fresh
    solver started from another state, 4 more: the same bytes, the same
    step and t (the Boussinesq state is the dict tree)."""
    _, mesh = _meshes(1)
    if solver == "ns2d":
        def make():
            return NS2DSolver((32, 32), mesh, nu=5e-3, dt=5e-3)

        def init(s, seed):
            s.init_random(seed=seed)
    else:
        def make():
            return Boussinesq3DSolver((16, 16, 16), mesh, nu=0.02,
                                      kappa=0.02, gravity=1.0, dt=5e-3,
                                      decomp="slab3d")

        def init(s, seed):
            s.init_random(seed=seed)
    a, b, c = make(), make(), make()
    init(a, 7)
    a.step(8)
    init(b, 7)
    b.step(4)
    b.save(tmp_path)
    init(c, 0)                       # deliberately another state
    assert c.restore(tmp_path) == 4
    c.step(4)
    assert all(np.array_equal(x, y) for x, y in zip(_gathered(a),
                                                    _gathered(c)))
    assert c.step_count == a.step_count == 8 and c.t == a.t


@pytest.mark.parametrize("solver,stepper", [("ns2d", "if_rk4"),
                                            ("bq3d", "rk4")])
def test_dropped_solver_frees_its_tensors_without_gc(solver, stepper):
    """A solver holds no reference cycle: dropping it frees its state
    and tables at once (on the card, gigabytes), not at the next garbage
    collection."""
    _, mesh = _meshes(1)
    if solver == "ns2d":
        s = NS2DSolver((32, 32), mesh, stepper=stepper)
    else:
        s = Boussinesq3DSolver((16, 16, 16), mesh, decomp="slab3d",
                               stepper=stepper)
    s.init_random(seed=1)
    s.step(1)
    refs = [weakref.ref(s), weakref.ref(tree_leaves(s.state)[0]),
            weakref.ref(s.basis.k2)]
    gc.disable()
    try:
        del s
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_warm_wisdom_bring_up_times_no_sweep(tmp_path):
    """A measured solver bring-up against a warm wisdom file plans its
    whole plan set (both directions and the batched RHS plans) with zero
    timed sweep candidates."""
    _, mesh = _meshes(1)
    plan_mod.set_wisdom(tmp_path / "wisdom.json", "readwrite")
    try:
        seen = []
        for _ in range(2):
            plan_mod.plan_cache_clear()
            s = NS2DSolver((32, 32), mesh, decomp="slab", backend="measure")
            s.init_taylor_green()
            s.step(1)
            seen.append(plan_mod.plan_cache_stats())
    finally:
        plan_mod.set_wisdom(None)
        plan_mod.plan_cache_clear()
    cold, warm = seen
    assert cold["sweep_candidates_timed"] > 0
    assert warm["wisdom_hits"] > 0 and warm["sweep_candidates_timed"] == 0


@pytest.mark.parametrize("solver", ["ns2d", "bq3d"])
def test_reference_checkpoint_continues_in_the_port(solver, tmp_path):
    """The reference's solver steps 4, saves; the port's solver restores
    that directory (the dict state's leaves in sorted-key order) and
    steps 4 more, beside the reference's own continuation."""
    jmesh, tmesh = _meshes(1)
    if solver == "ns2d":
        kw = dict(nu=5e-3, dt=5e-3, decomp="slab")
        ref = JNS2D((32, 32), jmesh, axis_names=("data",), **kw)
        port = NS2DSolver((32, 32), tmesh, **kw)
    else:
        kw = dict(nu=0.02, kappa=0.02, gravity=1.0, dt=5e-3,
                  decomp="slab3d")
        ref = JBq3d((16, 16, 16), jmesh, axis_names=("data",), **kw)
        port = Boussinesq3DSolver((16, 16, 16), tmesh, **kw)
    ref.init_random(seed=9)
    ref.step(4)
    ref.save(tmp_path)
    ref.step(4)
    port.init_random(seed=0)
    assert port.restore(tmp_path) == 4 and port.step_count == 4
    port.step(4)
    if solver == "ns2d":
        pairs = [(np.asarray(ref.vorticity()), port.vorticity())]
    else:
        pairs = [(np.asarray(ref.field(k)), port.field(k))
                 for k in ("u0", "u1", "u2", "b")]
    for want, got in pairs:
        assert _relerr(want, got) < FIELD_TOL
    assert port.t == ref.t


CPU = ["--device", "cpu", "--grid", "32", "32", "--steps", "10",
       "--monitor-every", "5", "--init", "random", "--seed", "2"]


def test_launch_summary_has_the_reference_keys(tmp_path, capsys):
    """``launch/solver.main`` on the CPU: the reference's summary keys
    and report lines, the same final energy as the reference's main, two
    spectrum files."""
    got = launch.main(CPU + ["--spectra-dir", str(tmp_path / "port")])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    want = jax_launch.main(CPU[2:] + ["--spectra-dir",
                                      str(tmp_path / "ref")])
    assert sorted(got) == sorted(want)
    assert sorted(got["plan_stats"]) == sorted(want["plan_stats"])
    assert [r["step"] for r in lines[:2]] == [5, 10]
    assert lines[-1]["final"] == got["final"]
    assert sorted(got["final"]) == sorted(want["final"])
    assert abs(got["final"]["energy"] - want["final"]["energy"]) \
        / want["final"]["energy"] < ORACLE_TOL
    assert got["spectra_files"] == 2
    for step in (5, 10):
        name = f"ns2d_spectrum_{step:06d}.npy"
        np.testing.assert_allclose(np.load(tmp_path / "port" / name),
                                   np.load(tmp_path / "ref" / name),
                                   rtol=FIELD_TOL, atol=1e-12)


def test_launch_restore_continues(tmp_path):
    """``--ckpt-every 5`` then ``--restore``: the second run starts at
    step 10 and ends where 20 uninterrupted steps end, bit for bit."""
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5"]
    launch.main(CPU + ck)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000005", "step_00000010"]
    resumed = launch.main(CPU + ck + ["--restore"])
    straight = launch.main([a if a != "10" else "20" for a in CPU])
    assert resumed["final"]["step"] == 20
    assert resumed["final"] == straight["final"]


def test_launch_refusals():
    # --elastic runs (tests/test_torch_solver_ranks.py); alone it has no
    # consumer mesh to rescale, as in the reference
    with pytest.raises(SystemExit, match="--elastic requires "
                                         "--transit-consumers"):
        launch.main(CPU + ["--elastic"])
    with pytest.raises(SystemExit, match="--transit-consumers"):
        launch.main(CPU + ["--transit-async"])
    with pytest.raises(SystemExit, match="ns2d wants"):
        launch.main(CPU[:2] + ["--grid", "8", "8", "8"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch.main(CPU[2:])
