"""The port's optimizer, gradient compression and data pipeline
(``repro_torch/optim``, ``repro_torch/data``) against the reference's.

Each case feeds one numpy seed to both packages. Bars: the schedule and
the global norm within 1e-6 relative (float32, the norm's sums in
another order); AdamW's parameters and moments after each of five steps
within 1e-6 of the largest magnitude (float32 elementwise arithmetic,
the only difference being fused multiply-adds); int8 quantization and
the synthetic batches equal to the bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsynthetic
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.data import synthetic
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw, compress
from repro_torch.sharding.policy import make_policy
from repro_torch.tree_util import tree_leaves

TOL = 1e-6


def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((8, 16)).astype(dtype),
            "blocks": [{"w": rng.standard_normal((4, 32)).astype(dtype)}
                       for _ in range(2)],
            "z": rng.standard_normal((64,)).astype(dtype)}


def _jtree(tree):
    return {"a": tree["a"], "blocks": {"w": np.stack(
        [b["w"] for b in tree["blocks"]])}, "z": tree["z"]}


def _ttree(tree):
    return {"a": torch.from_numpy(tree["a"].copy()),
            "blocks": [{"w": torch.from_numpy(b["w"].copy())}
                       for b in tree["blocks"]],
            "z": torch.from_numpy(tree["z"].copy())}


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.mark.parametrize("warmup,total", [(1, 10), (5, 50), (20, 300)])
def test_warmup_cosine_matches_reference(warmup, total):
    j = jadamw.warmup_cosine(3e-3, warmup, total)
    t = adamw.warmup_cosine(3e-3, warmup, total)
    for s in range(total + 3):
        assert t(s).dtype == torch.float32
        assert abs(float(t(s)) - float(j(s))) <= TOL * 3e-3, s


def test_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, _jtree(tree))))
    got = float(adamw.global_norm(_ttree(tree)))
    assert abs(got - want) <= TOL * want
    assert float(adamw.global_norm({"a": torch.tensor([3.0]),
                                    "b": torch.tensor([4.0])})) == 5.0


@pytest.mark.parametrize("clip", [None, 1.0, 100.0])
def test_adamw_steps_match_reference(clip):
    """Five updates from one state: parameters, moments, count, and the
    metrics (the pre-clip norm and the learning rate)."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jopt = jadamw.AdamW(jadamw.warmup_cosine(1e-2, 2, 10), grad_clip=clip)
    topt = adamw.AdamW(adamw.warmup_cosine(1e-2, 2, 10), grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, _jtree(params))
    tp = _ttree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        grads = _tree(rng)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, _jtree(grads)),
                                 js, jp)
        tp, ts, tm = topt.update(_ttree(grads), ts, tp)
        assert int(ts["count"]) == int(js["count"]) == step + 1
        assert ts["count"].dtype == torch.int32
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
        _close(float(tm["lr"]), float(jm["lr"]))
        for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            for g, w in zip(tree_leaves(got),
                            jax.tree.leaves(_jtree_back(want))):
                _close(g.numpy(), w)


def _jtree_back(jtree):
    """The reference's stacked tree in the port's leaf order."""
    w = np.asarray(jtree["blocks"]["w"])
    return {"a": np.asarray(jtree["a"]),
            "blocks": [{"w": w[i]} for i in range(w.shape[0])],
            "z": np.asarray(jtree["z"])}


def test_adamw_bf16_params_round_back_to_their_dtype():
    """A bfloat16 leaf updates in float32 and is cast back, as the
    reference's ``.astype(p.dtype)``."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    g = rng.standard_normal((4, 64)).astype(np.float32)
    jopt = jadamw.AdamW(lambda s: jnp.float32(1e-2))
    topt = adamw.AdamW(lambda s: torch.tensor(1e-2))
    jp = {"w": jnp.asarray(x, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(x).to(torch.bfloat16)}
    jp, _, _ = jopt.update({"w": jnp.asarray(g, jnp.bfloat16)},
                           jopt.init(jp), jp)
    tp, _, _ = topt.update({"w": torch.from_numpy(g).to(torch.bfloat16)},
                           topt.init(tp), tp)
    assert tp["w"].dtype == torch.bfloat16
    _close(tp["w"].float().numpy(), np.asarray(jp["w"], np.float32),
           tol=2 ** -8)


def test_adamw_reports_the_pre_clip_norm():
    opt = adamw.AdamW(lambda s: torch.tensor(0.0), grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    _, _, metrics = opt.update({"w": torch.full((4,), 100.0)},
                               opt.init(params), params)
    assert float(metrics["grad_norm"]) == 200.0


@pytest.mark.parametrize("block", [None, 64, 16])
@pytest.mark.parametrize("shape", [(256,), (3, 100), (2, 4, 64)])
def test_int8_quantization_is_the_reference_bit_for_bit(block, shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[5] = 1e4                        # an outlier
    jq, js = jcompress.quantize_int8(jnp.asarray(x), block)
    tq, ts = compress.quantize_int8(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compress.dequantize_int8(tq, ts, block).numpy(),
        np.asarray(jcompress.dequantize_int8(jq, js, block)))
    # the legacy scalar scale
    np.testing.assert_array_equal(
        compress.dequantize_int8(tq, torch.tensor(0.5)).numpy(),
        np.asarray(jcompress.dequantize_int8(jq, jnp.float32(0.5))))


def test_compressed_psum_on_one_rank_is_error_feedback():
    """One rank (no process group): the mean is the dequantized gradient
    and the error buffer its residual, as the reference's psum over a
    one-device axis."""
    from repro import compat
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    err = jax.tree.map(lambda a: (1e-3 * np.ones_like(a)), _jtree(tree))
    jmesh = compat.make_mesh((1,), ("data",))
    from jax.sharding import PartitionSpec as P

    def body(g, e):
        return jcompress.compressed_psum_tree(g, e, ("data",))
    fn = compat.shard_map(body, mesh=jmesh, in_specs=(P(), P()),
                          out_specs=(P(), P()))
    jmean, jerr = fn(jax.tree.map(jnp.asarray, _jtree(tree)),
                     jax.tree.map(jnp.asarray, err))
    tmean, terr = compress.compressed_psum_tree(
        _ttree(tree), _ttree(_jtree_back(err)), None)
    for got, want in ((tmean, jmean), (terr, jerr)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(_jtree_back(want))):
            np.testing.assert_array_equal(g.numpy(), w)
    zeros = compress.init_error(_ttree(tree))
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32
               for z in tree_leaves(zeros))


@pytest.mark.parametrize("family,extra", [
    ("dense", {}),
    ("vlm", dict(num_patches=6, patch_dim=32)),
    ("encdec", dict(frame_dim=24)),
])
def test_synthetic_batches_are_the_reference_bit_for_bit(family, extra):
    kw = dict(global_batch=3, seq_len=20, vocab=997, seed=5, family=family,
              **extra)
    for step in (0, 1, 17, 123456):
        want = jsynthetic.batch_at(step, **kw)
        got = synthetic.batch_at(step, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for (a, b) in zip(zip(range(4), synthetic.stream(start_step=3, **kw)),
                      zip(range(4), jsynthetic.stream(start_step=3, **kw))):
        for k in b[1]:
            np.testing.assert_array_equal(a[1][k], b[1][k])


def test_sharded_loader_places_batches_in_step_order():
    pol = make_policy(make_host_mesh(device="cpu"), global_batch=2)
    kw = dict(global_batch=2, seq_len=8, vocab=101, seed=0)
    loader = ShardedLoader(lambda s: synthetic.batch_at(s, **kw), pol,
                           start_step=4, prefetch=2)
    try:
        for want_step in range(4, 9):
            step, batch = next(loader)
            assert step == want_step == loader.step
            ref = synthetic.batch_at(step, **kw)
            for k, v in ref.items():
                assert isinstance(batch[k], torch.Tensor)
                np.testing.assert_array_equal(batch[k].numpy(), v)
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_sharded_loader_surfaces_a_failed_batch():
    pol = make_policy(make_host_mesh(device="cpu"), global_batch=2)

    def batch_fn(step):
        if step == 1:
            raise ValueError("bad batch")
        return {"tokens": np.zeros((2, 4), np.int32)}
    loader = ShardedLoader(batch_fn, pol)
    try:
        assert next(loader)[0] == 0
        with pytest.raises(RuntimeError, match="batch 1") as info:
            next(loader)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        loader.close()


def test_sharded_loader_refuses_a_mesh_of_many_ranks():
    """A mesh of several positions but no ranks (shapes only) is refused
    before the worker starts; a mesh over the world's ranks places each
    rank's rows (``test_torch_lm_ranks.py``)."""
    import types
    pol = make_policy(types.SimpleNamespace(shape={"data": 2, "model": 1}),
                      global_batch=2)
    with pytest.raises(ValueError, match="names no ranks"):
        ShardedLoader(lambda s: {}, pol)
