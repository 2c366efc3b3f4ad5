"""``repro_torch.core.fft.plan`` on a one-device mesh against the
reference's ``plan_dft`` on a one-device mesh and ``np.fft.fftn``."""
import numpy as np
import pytest
import torch

from repro.compat import make_mesh as jax_make_mesh
from repro.core.fft import plan as jplan
from repro_torch.compat import make_mesh
from repro_torch.core.fft import plan, schedule

RNG = np.random.default_rng(5)


def _mesh():
    return make_mesh((1,), ("data",), device="cpu")


@pytest.mark.parametrize("shape", [(32, 48), (8, 16, 12)])
@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_plan_dft_matches_reference_and_numpy(shape, backend):
    x = (RNG.standard_normal(shape)
         + 1j * RNG.standard_normal(shape)).astype(np.complex64)
    jmesh = jax_make_mesh((1,), ("data",))
    fwd = plan.plan_dft(shape, plan.FORWARD, _mesh(), backend=backend)
    bwd = plan.plan_dft(shape, plan.BACKWARD, _mesh(), backend=backend)
    assert fwd.decomp == ("slab" if len(shape) == 2 else "slab3d")
    y = fwd.execute_complex(x).numpy()
    jy = np.asarray(jplan.plan_dft(shape, jplan.FORWARD, jmesh,
                                   backend=backend).execute_complex(x))
    scale = np.abs(jy).max()
    assert np.abs(y - jy).max() / scale < 5e-5
    assert np.abs(y - np.fft.fftn(x)).max() / scale < 5e-5
    back = bwd.execute_complex(y).numpy()
    jback = np.asarray(jplan.plan_dft(shape, jplan.BACKWARD, jmesh,
                                      backend=backend).execute_complex(jy))
    np.testing.assert_allclose(back, jback, atol=1e-5)
    np.testing.assert_allclose(back, x, atol=1e-4)


def test_plan_batched_leading_dims():
    x = (RNG.standard_normal((3, 16, 20))
         + 1j * RNG.standard_normal((3, 16, 20))).astype(np.complex64)
    p = plan.plan_dft((16, 20), plan.FORWARD, _mesh(), backend="pallas",
                      batch_ndim=1)
    y = p.execute_complex(x).numpy()
    want = np.fft.fftn(x, axes=(-2, -1))
    assert np.abs(y - want).max() / np.abs(want).max() < 5e-5


def test_plan_cache_returns_the_same_object():
    plan.plan_cache_clear()
    a = plan.plan_dft((16, 16), plan.FORWARD, _mesh(), backend="pallas")
    b = plan.plan_dft([16, 16], "forward", _mesh(), backend="pallas")
    c = plan.plan_dft((16, 16), plan.BACKWARD, _mesh(), backend="pallas")
    assert a is b and a is not c
    stats = plan.plan_cache_stats()
    assert (stats["hits"], stats["misses"], stats["size"]) == (1, 2, 2)
    plan.plan_cache_clear()
    # the reference's counters, every one zeroed by the clear
    after = plan.plan_cache_stats()
    assert set(after) == set(jplan.plan_cache_stats())
    assert after == dict.fromkeys(after, 0)


def test_mesh_defaults_and_limits(monkeypatch):
    # the default device is cuda:{LOCAL_RANK}, and must exist
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh((1,), ("data",)).device == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert make_mesh((1,), ("data",)).device == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="cuda:1"):
        make_mesh((1,), ("data",))
    # more than one device needs a default process group of that size
    with pytest.raises(ValueError, match="process group"):
        make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="process group"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    assert schedule.AllToAll("data", -1, -2, 4).shards == 4


def test_plan_refuses_a_block_of_another_shape():
    # rank 1 of a (4,) mesh takes a (4, 16) block of a 16 x 16 slab; the
    # whole grid (a field every rank holds whole) raises before any
    # exchange
    from repro_torch.compat import Mesh
    mesh = Mesh(("data",), {"data": 4}, torch.device("cpu"), {"data": 1},
                hosts=("h",) * 4)
    p = plan.plan_dft((16, 16), plan.FORWARD, mesh, backend="pallas")
    assert p.block_shape() == (4, 16)
    x = torch.zeros(16, 16)
    with pytest.raises(ValueError, match=r"block \(4, 16\)"):
        p.execute(x, x)
    one = plan.plan_dft((16, 16), plan.FORWARD, _mesh(), backend="pallas",
                        batch_ndim=1)
    assert one.block_shape() == (16, 16)
    with pytest.raises(ValueError, match="place"):
        one.execute(torch.zeros(2, 8, 16), torch.zeros(2, 8, 16))


@pytest.mark.parametrize("kw, item", [
    ({"backend": "measure"}, "item 10"),
    ({"decomp": "measure"}, "item 10"),
    ({"real": True}, "item 9"),
    ({"wire_dtype": "bfloat16"}, "item 12"),
])
def test_unported_planning_raises(kw, item):
    """The planning options that raised while their ROADMAP item was
    unported (the name is kept from then) now plan on a one-device mesh
    and transform as the reference's plan with the same options does."""
    x = RNG.standard_normal((16, 16)).astype(np.float32)
    p = plan.plan_dft((16, 16), plan.FORWARD, _mesh(),
                      allow_reduced_wire=False, **kw)
    jp = jplan.plan_dft((16, 16), jplan.FORWARD,
                        jax_make_mesh((1,), ("data",)),
                        allow_reduced_wire=False, **kw)
    y = p.execute_complex(x).numpy()
    want = np.asarray(jp.execute_complex(x))
    assert y.shape == want.shape == ((16, 9) if kw.get("real")
                                     else (16, 16))
    # bfloat16 on the wire rounds each exchanged value to 8 bits
    tol = 1e-2 if "wire_dtype" in kw else 5e-5
    assert np.abs(y - want).max() / np.abs(want).max() < tol
    if "wire_dtype" in kw:
        assert p.topology()[0]["wire_dtype"] == "bfloat16"
    if kw.get("backend") == "measure":
        assert p.backend in ("fourstep", "jnp", "stockham")
    if kw.get("decomp") == "measure":
        assert p.decomp == "slab"         # one mesh axis: no pencil2d


@pytest.mark.parametrize("kw", [{"overlap_chunks": 2},
                                {"decomp": "pencil2d"}])
def test_one_device_plans_of_the_distributed_path(kw):
    # overlap chunking and the 2-axis decomposition, once refused, on a
    # one-device mesh: bit-identical to the plain slab where they chunk,
    # and against numpy
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    x = (RNG.standard_normal((16, 24))
         + 1j * RNG.standard_normal((16, 24))).astype(np.complex64)
    p = plan.plan_dft((16, 24), plan.FORWARD, mesh, backend="pallas", **kw)
    y = p.execute_complex(x)
    want = np.fft.fft2(x)
    assert np.abs(y.numpy() - want).max() / np.abs(want).max() < 5e-5
    if "overlap_chunks" in kw:
        plain = plan.plan_dft((16, 24), plan.FORWARD, mesh, backend="pallas")
        assert p is not plain and torch.equal(y, plain.execute_complex(x))
    else:
        assert p.schedule().out_spec == (None, ("model", "data"))


def test_planner_input_errors():
    # wisdom and real plans, once refused, are set up; a bad mode raises
    store = plan.set_wisdom("wisdom.json", "read")
    assert store.mode == "read" and plan.wisdom_store() is store
    assert plan.set_wisdom(None) is None and plan.wisdom_store() is None
    with pytest.raises(ValueError, match="wisdom mode"):
        plan.set_wisdom("wisdom.json", "sometimes")
    assert plan.plan_rfft((16, 16), plan.FORWARD, _mesh()).real
    with pytest.raises(ValueError, match="r2c"):
        plan.plan_rfft((64,), plan.FORWARD, _mesh())
    with pytest.raises(ValueError):
        plan.plan_dft((16, 16), plan.FORWARD, _mesh(), backend="cufft")
    with pytest.raises(ValueError):
        plan.plan_dft((16, 16), plan.FORWARD, _mesh(), decomp="nope")
    with pytest.raises(ValueError):
        schedule.execute_schedule(
            schedule.slab_2d(_mesh()), _mesh(), torch.zeros(4, 4))
