"""The port's stage IR across ranks against the reference and numpy
models: the tiled ``AllToAll`` for every (split, concat) pair the
builders use, on each axis of a (4,) and a (2, 2) mesh; the axis
groups' rank order; ``Twiddle``; ``Reorder``; the layout maps and the
digit-permuted masks; the exchange topology.

The reference runs its own executor on the same one-stage schedules
once, in a subprocess with four host devices; the port runs once, over
four spawned gloo CPU processes (``torch_ranks.py``)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as T
from repro.core.fft import distributed as JD
from repro.core.fft import filters as jfilters
from repro.core.fft import schedule as JS
from repro_torch.compat import Mesh, axis_crosses_processes
from repro_torch.core.fft import distributed as D
from repro_torch.core.fft import filters
from repro_torch.core.fft import schedule as S

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-4
GLOBAL_A2A = (8, 8, 8, 8)
GLOBAL_TW = (8, 8, 16)
# one-twiddle schedules: (mesh, axis name, axis, sign)
TWIDDLES = [("1d", "data", -1, -1.0), ("1d", "data", -3, 1.0),
            ("2d", "model", -2, -1.0), ("2d", "data", -3, 1.0)]
MINI = ([f"sched_{m}_a2a_{n}_{s}_{c}" for m, (_, names) in T.MESHES.items()
         for n in names for s, c in T.A2A_PAIRS]
        + [f"sched_{m}_tw_{n}_{a}_{g}" for m, n, a, g in TWIDDLES])

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, sys.argv[3])
    import torch_ranks as T
    from repro.compat import make_mesh
    from repro.core.fft import schedule as S

    inputs = dict(np.load(sys.argv[1]))
    meshes = {k: make_mesh(s, n) for k, (s, n) in T.MESHES.items()}
    out = {}
    for key, x in inputs.items():
        parts = key.split("_")
        mesh, kind, name = meshes[parts[1]], parts[2], parts[3]
        if kind == "a2a":
            s, c = int(parts[4]), int(parts[5])
            si, so = [None] * 4, [None] * 4
            si[c], so[s] = name, name
            stage = S.AllToAll(name, s, c, mesh.shape[name])
            sched = S.Schedule(key, 4, (stage,), tuple(si), tuple(so))
        else:
            axis, sign = int(parts[4]), float(parts[5])
            sp = [None] * 3
            sp[axis] = name
            stage = S.Twiddle(axis, name, mesh.shape[name], sign)
            sched = S.Schedule(key, 3, (stage,), tuple(sp), tuple(sp))
        sh = NamedSharding(mesh, P(*sched.in_spec))
        r, i = S.execute_schedule(sched, mesh, jax.device_put(x[0], sh),
                                  jax.device_put(x[1], sh))
        out["out_" + key] = np.stack([np.asarray(r), np.asarray(i)])
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(6)
    return {k: rng.standard_normal(
        (2,) + (GLOBAL_A2A if "_a2a_" in k else GLOBAL_TW)).astype(
            np.float32) for k in MINI}


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    work = tmp_path_factory.mktemp("jax")
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, str(work / "inputs.npz"),
         str(work / "out.npz"), str(Path(__file__).parent)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(work / "out.npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    return T.run_ranks("schedule", tmp_path_factory.mktemp("ranks"), inputs)


def _groups(mkey, name):
    """Per rank: the ranks of its group along ``name``, in coordinate
    order (row-major mesh)."""
    shape, names = T.MESHES[mkey]
    ranks = np.arange(T.WORLD).reshape(shape)
    ax = names.index(name)
    out = {}
    for r in range(T.WORLD):
        idx = list(np.unravel_index(r, shape))
        idx[ax] = slice(None)
        out[r] = list(ranks[tuple(idx)])
    return out


def _tiled_all_to_all(blocks, groups, split, concat):
    """numpy model of ``jax.lax.all_to_all(tiled=True)``: rank j of a
    group receives chunk j (along split) of every member, concatenated
    along concat in member order."""
    out = {}
    for r, members in groups.items():
        j = members.index(r)
        out[r] = np.concatenate(
            [np.split(blocks[m], len(members), axis=split)[j]
             for m in members], axis=concat)
    return out


@pytest.mark.parametrize("mkey,name", [("1d", "data"), ("2d", "data"),
                                       ("2d", "model")])
@pytest.mark.parametrize("split,concat", T.A2A_PAIRS)
def test_all_to_all_matches_tiled_model(mkey, name, split, concat, port):
    groups = _groups(mkey, name)
    blocks = {r: T.a2a_input(r) for r in range(T.WORLD)}
    want = _tiled_all_to_all(blocks, groups, split, concat)
    got = port[f"a2a_{mkey}_{name}_{split}_{concat}"]
    for r in range(T.WORLD):
        np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("mkey,name", [("1d", "data"), ("2d", "data"),
                                       ("2d", "model")])
def test_axis_group_rank_is_the_mesh_coordinate(mkey, name, port):
    groups = _groups(mkey, name)
    for r, (order, group_rank, coord) in enumerate(
            port[f"group_{mkey}_{name}"]):
        assert list(order) == groups[r]
        assert group_rank == coord == groups[r].index(r)


@pytest.mark.parametrize("key", MINI)
def test_one_stage_schedules_match_reference(key, reference, port):
    got, want = port["out_" + key], reference["out_" + key]
    assert got.shape == want.shape
    if "_a2a_" in key:              # an exchange moves values, exactly
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < TOL


@pytest.mark.parametrize("op,axis,parts,shape", [
    ("expand", -4, 0, (3, 4, 5)), ("expand", -2, 0, (12,)),
    ("merge", -4, 0, (2, 3, 4, 5)), ("merge", -2, 0, (3, 8)),
    ("fold_T", -4, 0, (2, 3, 4, 5)), ("fold_T", -2, 0, (4, 6)),
    ("unfold_T", -3, 2, (8, 3, 5)), ("unfold_T", -1, 4, (2, 12))])
def test_reorder_matches_reference(op, axis, parts, shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = S.Reorder(op, axis, parts)._one(torch.from_numpy(x))
    want = np.asarray(JS.Reorder(op, axis, parts)._one(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,p", [(16, 2), (16, 4), (64, 4), (64, 8),
                                 (256, 4), (1024, 8), (8, 1)])
def test_layout_maps_match_reference_and_invert(n, p):
    for name in ("cyclic_order", "cyclic_inverse_order",
                 "fourstep_freq_of_position", "fourstep_position_of_freq"):
        np.testing.assert_array_equal(getattr(D, name)(n, p),
                                      getattr(JD, name)(n, p))
    freq = D.fourstep_freq_of_position(n, p)
    pos = D.fourstep_position_of_freq(n, p)
    np.testing.assert_array_equal(freq[pos], np.arange(n))
    np.testing.assert_array_equal(pos[freq], np.arange(n))
    cyc, inv = D.cyclic_order(n, p), D.cyclic_inverse_order(n, p)
    np.testing.assert_array_equal(cyc[inv], np.arange(n))


@pytest.mark.parametrize("build", ["permute", "fourstep_1d", "pencil_tf_3d"])
def test_digit_permuted_masks_match_reference(build):
    if build == "permute":
        for shape, p in (((16, 6), 2), ((64,), 4), ((8, 4, 4), 2)):
            mask = filters.lowpass_mask(shape, 0.3)
            got = filters.permute_mask_first_axis(mask, p)
            want = jfilters.permute_mask_first_axis(
                jfilters.lowpass_mask(shape, 0.3), p)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif build == "fourstep_1d":
        for n, p in ((64, 4), (1024, 8)):
            np.testing.assert_array_equal(
                filters.mask_fourstep_1d(n, p, keep_frac=0.1).numpy(),
                np.asarray(jfilters.mask_fourstep_1d(n, p, keep_frac=0.1)))
    else:
        for shape, p in (((8, 12, 16), 2), ((16, 8, 8), 4)):
            got = filters.mask_pencil_tf_3d(shape, p, keep_frac=0.2)
            want = jfilters.mask_pencil_tf_3d(shape, p, keep_frac=0.2)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert got.dtype == torch.bool


def test_topology_and_meshes(port):
    # four ranks on one host: no exchange crosses hosts
    assert [tuple(t) for t in port["topology_1d"]] == [("data", 4, False)]
    assert [tuple(t) for t in port["topology_2d"]] == [
        ("model", 2, False), ("model", 2, False), ("data", 2, False)]
    # plans are shared by meshes over the same groups and device only:
    # two (4,) meshes (both on the default group), not two (2, 2) meshes
    assert port["plans_shared_per_mesh"].tolist() == [True, False]
    assert bool(port["wrong_size_refused"])


def test_axis_crosses_hosts_from_the_ranks_hostnames():
    # (2, 2) mesh, ranks 0, 1 on node a and 2, 3 on node b: the rows
    # ("model") stay on a node, the columns ("data") cross
    mesh = Mesh(("data", "model"), {"data": 2, "model": 2},
                torch.device("cpu"), {"data": 0, "model": 0},
                hosts=("a", "a", "b", "b"))
    assert axis_crosses_processes(mesh, "data")
    assert not axis_crosses_processes(mesh, "model")
    one = Mesh(("data",), {"data": 1}, torch.device("cpu"), {"data": 0})
    assert not axis_crosses_processes(one, "data")


def test_stage_ir_refusals():
    # a wire dtype, once refused, is a stage knob; a codec name given
    # in its place moves to the codec slot, as in the reference
    assert S.AllToAll("data", -1, -2, 4, "bfloat16").wire_dtype == "bfloat16"
    st = S.AllToAll("data", -1, -2, 4, "int8_block64")
    assert (st.wire_dtype, st.wire_codec) == (None, "int8_block64")
    jst = JS.AllToAll("data", -1, -2, 4, "int8_block64")
    assert (jst.wire_dtype, jst.wire_codec) == (st.wire_dtype, st.wire_codec)
    with pytest.raises(TypeError):
        S.AllToAll("data", -1, -2, 4, "float8_e9")._encode(
            torch.zeros(4, 4), 1, 0)
    one = Mesh(("data",), {"data": 1}, torch.device("cpu"), {"data": 0})
    with pytest.raises(ValueError, match="two mesh axes"):
        S.build_schedule("pencil", (8, 8, 8), one, ("data",))
    with pytest.raises(ValueError, match="overlap"):
        S.overlap_site(S.fourstep_1d(one))
