"""The port's wire codecs (``core/fft/wire.py``) against the reference:
encodings bit for bit, decoding within each codec's documented bound,
the packed single-collective wire; then, on four ranks, the tiled
exchange with every codec and wire dtype against the reference's, a
complex slab with each wire against the exact wire, and measured
planning (the same winner on every rank, codec candidates only where an
exchange crosses hosts, the error-budget gate).

The four-rank reference runs once, in a subprocess with four host
devices; the port once, over four spawned gloo CPU processes
(``torch_ranks.py``)."""
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
from repro.core.fft import wire as jwire
from repro_torch.core.fft import wire

SRC = str(Path(__file__).resolve().parents[1] / "src")
CODECS = ["bf16", "int8", "int8_block64", "int8_block8"]


def _rand(shape, seed, spread=3.0):
    """Values over several decades, zeros in one row's head, one
    outlier: what the block scales are for."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(spread * rng.standard_normal(
        shape))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[0, :3] = 0.0
    x.reshape(-1)[-1] = 1e4
    return x


def _bits(t):
    """Raw bytes of a torch or jax array (bf16 compares by its bits)."""
    if torch.is_tensor(t):
        return t.contiguous().view(torch.uint8).numpy().tobytes()
    a = np.asarray(t)
    return a.view(np.uint8).tobytes() if a.dtype.itemsize else a.tobytes()


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("shape", [(4, 128), (3, 5, 100), (2, 64), (7, 1)])
@pytest.mark.parametrize("complex_", [False, True])
def test_encoding_is_bit_identical_to_reference(name, shape, complex_):
    x = _rand(shape, seed=sum(shape))
    if complex_:
        x = (x + 1j * _rand(shape, seed=7)).astype(np.complex64)
    got = wire.get_codec(name).encode(torch.from_numpy(x))
    want = jwire.get_codec(name).encode(jnp.asarray(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert _bits(g) == _bits(w)


@pytest.mark.parametrize("name", CODECS)
def test_decode_within_max_error_and_bytes(name):
    codec = wire.get_codec(name)
    for shape in ((4, 128), (3, 5, 96), (6, 1000)):
        x = torch.from_numpy(_rand(shape, seed=shape[-1]))
        y = codec.decode(codec.encode(x))
        bound = codec.max_error(x)
        assert y.dtype == torch.float32 and y.shape == x.shape
        assert bool(((y - x).abs() <= bound * (1 + 1e-6)).all())
        # atol: bf16's 1e-38 guard is a float32 subnormal, which XLA's
        # CPU code flushes to zero
        np.testing.assert_allclose(
            bound.numpy(), np.asarray(jwire.get_codec(name).max_error(
                jnp.asarray(x.numpy()))), rtol=1e-6,
            atol=2 * wire.BF16_ABS_GUARD)
        assert codec.wire_bytes(shape) == jwire.get_codec(name).wire_bytes(
            shape)
    # complex payloads travel interleaved, and come back complex
    z = torch.complex(torch.randn(3, 32), torch.randn(3, 32))
    back = codec.decode(codec.encode(z), torch.complex64)
    assert back.dtype == torch.complex64
    bound = codec.max_error(wire.interleave_complex(z))
    assert bool(((wire.interleave_complex(back)
                  - wire.interleave_complex(z)).abs() <= bound * 1.000001)
                .all())
    assert wire.exact_bytes((4, 8), torch.complex64) == \
        jwire.exact_bytes((4, 8), jnp.complex64) == 256


def test_registry_and_alignment():
    assert wire.codec_names() == jwire.codec_names()
    for name in ("bf16", "int8", "int8_block64", "int8_block3"):
        assert wire.is_codec(name) and jwire.is_codec(name)
    for name in ("bfloat16", "float16", None, 3):
        assert not wire.is_codec(name)
    with pytest.raises(ValueError):
        wire.get_codec("float8")
    # blocks must stay whole through an exchange
    with pytest.raises(ValueError, match="multiple of the block"):
        wire.get_codec("int8_block64").encode_wire(torch.zeros(2, 96))
    z = wire.get_codec("int8").decode(wire.get_codec("int8").encode(
        torch.zeros(3, 16)))
    assert bool((z == 0).all())


def _a2a_sim(arr, split_last, concat_last, shards):
    """Rank 0's view of a tiled exchange on the last axis."""
    chunks = (np.split(arr, shards, axis=-1) if split_last
              else [arr] * shards)
    return np.concatenate(chunks, axis=-1) if concat_last else chunks[0]


@pytest.mark.parametrize("name", ["int8_block8", "int8_block4", "bf16"])
@pytest.mark.parametrize("geom", ["plain", "split_last", "concat_last"])
def test_pack_wire_round_trips(name, geom):
    """One packed buffer delivers the parts per-part exchanges would, and
    packs what the reference packs, byte for byte."""
    shards = 4
    x = _rand((6, 4, 32), seed=3)
    parts = wire.get_codec(name).encode_wire(torch.from_numpy(x))
    split_last, concat_last = geom == "split_last", geom == "concat_last"
    packed, meta = wire.pack_wire(parts, shards, split_last=split_last,
                                  concat_last=concat_last)
    jpacked, _ = jwire.pack_wire(
        jwire.get_codec(name).encode_wire(jnp.asarray(x)), shards,
        split_last=split_last, concat_last=concat_last)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    moved = wire.unpack_wire(torch.from_numpy(_a2a_sim(
        packed.numpy(), split_last, concat_last, shards)), meta)
    for part, got in zip(parts, moved):
        ref = _a2a_sim(part.contiguous().view(torch.uint8).numpy(),
                       split_last, concat_last, shards)
        assert got.dtype == part.dtype
        np.testing.assert_array_equal(
            got.contiguous().view(torch.uint8).numpy(), ref)
    with pytest.raises(ValueError, match="not a multiple"):
        wire.pack_wire(wire.get_codec("int8").encode_wire(
            torch.from_numpy(x)), 3, split_last=True, concat_last=False)


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, sys.argv[3])
    import torch_ranks as T
    from repro.compat import make_mesh
    from repro.core.fft import schedule as S
    from repro.core.fft.plan import plan_dft

    inputs = dict(np.load(sys.argv[1]))
    mesh = make_mesh(*T.MESHES["1d"])
    out = {}
    for wire, s, c in T.WIRE_CASES + [(None, s, c) for s, c in T.WIRE_PAIRS]:
        key = "wire_" + T.wire_id(wire, s, c)
        x = inputs["wire_" + T.wire_id(T.WIRES[0], s, c)] if wire is None \\
            else inputs[key]
        si, so = [None] * 3, [None] * 3
        si[c] = so[s] = "data"
        sched = S.Schedule("wire", 3, (S.AllToAll("data", s, c, 4, wire),),
                           tuple(si), tuple(so), 1, 1)
        y = S.execute_schedule(sched, mesh, jax.device_put(
            x, NamedSharding(mesh, P(*si))))
        out["out_" + key] = np.asarray(y)
    for wire in (None,) + T.SLAB_WIRES:
        plan = plan_dft(T.WIRE_SLAB, "forward", mesh, decomp="slab",
                        backend="pallas", wire_dtype=wire)
        out[f"slab_{wire}"] = np.asarray(plan.execute_complex(
            inputs["wire_slab"]))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def inputs():
    # the wires of one exchange geometry share their input
    geoms = {pair: _rand(T.WIRE_GLOBAL, seed=i)
             for i, pair in enumerate(T.WIRE_PAIRS)}
    out = {"wire_" + T.wire_id(w, s, c): geoms[(s, c)]
           for w, s, c in T.WIRE_CASES}
    rng = np.random.default_rng(12)
    out["wire_slab"] = (rng.standard_normal(T.WIRE_SLAB) + 1j
                        * rng.standard_normal(T.WIRE_SLAB)).astype(
                            np.complex64)
    out["measure_cube"] = (rng.standard_normal(T.MEASURE_3D) + 1j
                           * rng.standard_normal(T.MEASURE_3D)).astype(
                               np.complex64)
    return out


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
    return T.run_ranks("wire", tmp_path_factory.mktemp("ranks"), inputs)


def _bound(wire_name, exact):
    """A wire's documented elementwise bound around the exact values:
    2^-8·|x| for a bfloat16 cast; absmax/254 over the scaling span for
    int8, at most the whole array's."""
    if wire_name in ("bf16", "bfloat16"):
        return wire.BF16_REL_BOUND * np.abs(exact) + wire.BF16_ABS_GUARD
    return np.full(exact.shape, np.abs(exact).max() * wire.INT8_REL_BOUND)


@pytest.mark.parametrize("wire_name,split,concat", T.WIRE_CASES,
                         ids=[T.wire_id(*c) for c in T.WIRE_CASES])
def test_exchange_with_each_wire_matches_reference(wire_name, split, concat,
                                                   reference, port):
    key = "out_wire_" + T.wire_id(wire_name, split, concat)
    got, want = port[key], reference[key]
    exact = reference["out_wire_" + T.wire_id(None, split, concat)]
    assert got.shape == want.shape == exact.shape
    bound = _bound(wire_name, exact)
    assert bool((np.abs(got - want) <= bound).all())
    assert bool((np.abs(got - exact) <= bound * (1 + 1e-6)).all())


@pytest.mark.parametrize("wire_name", T.SLAB_WIRES + ("int8",))
def test_slab_with_each_wire_matches_reference(wire_name, reference, port):
    """A complex slab with the wire on its exchange: within the wire's
    error of the exact wire, and as the reference's slab with it. The
    uniform int8 codec cannot split the exchange's last axis (one scale
    a row): refused before any exchange, as the reference refuses it."""
    if wire_name == "int8":
        assert "not a multiple" in str(port["slab_int8_refused"])
        return
    got, want = port[f"slab_{wire_name}"], reference[f"slab_{wire_name}"]
    exact = reference["slab_None"]
    scale = np.abs(exact).max()
    assert np.abs(port["slab_None"] - exact).max() / scale < 1e-4
    # the wire's error, carried through the second pass of 16 points
    tol = 1e-2 if wire_name in ("bf16", "bfloat16") else 2e-2
    assert np.abs(got - exact).max() / scale < tol
    assert np.abs(got - want).max() / scale < 1e-4


def test_measured_winners_agree_on_every_rank(inputs, port):
    winners = port["measure_winners"]
    assert len(winners) == T.WORLD
    for w in winners[1:]:
        assert list(w) == list(winners[0])
    slab, decomp, both = winners[0][:3]
    assert slab[1] in ("fourstep", "jnp", "stockham")
    assert decomp[1] in ("pencil", "slab3d")
    assert both[1] in ("pencil", "slab3d")
    want = np.fft.fftn(inputs["measure_cube"])
    got = port["measure_cube_out"]
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_codec_candidates_only_where_an_exchange_crosses_hosts(port):
    # one host: none; a pencil2d whose "data" exchange crosses two named
    # hosts: int8 and int8_block64 on it, in each of its two sweeps
    assert list(port["measure_topology"]) == [False, False, True]
    one_host, total = port["measure_codec_candidates"]
    assert one_host == 0 and total == 4
    assert int(port["measure_profile_candidates"]) == 2
    skips = port["measure_hosted_skips"]
    codec_skips = [s for s in skips if s[0] is not None
                   and "int8" in str(s[0])]
    # the uniform int8 codec cannot split the last axis (one scale a row)
    assert any("not a multiple" in s[1] for s in codec_skips
               if "block" not in str(s[0]))


def test_error_budget_gate_names_its_reason(port):
    skips = [s for s in port["measure_hosted_skips"]
             if s[1] == "wire-error-budget"]
    # at wire_tol=1e-9 the block-scaled codec is over budget, skipped
    # with its measured error; the winner there is never a codec
    assert skips and all(s[2] > 1e-9 for s in skips)
    hosted = [w for w in port["measure_winners"][0] if w[0] == "hosted"]
    tight = [w for w in hosted if w[1] == 1e-9][0]
    assert not any("int8" in str(x) for x in np.atleast_1d(tight[4])
                   if x is not None)
