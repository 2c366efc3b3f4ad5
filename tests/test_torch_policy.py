"""The port's sharding policy (``repro_torch/sharding/policy.py``) against
the reference's ``repro/sharding/policy.py``.

The rules are pure functions of a mesh's shape, so both packages take
the same fake meshes — the production shapes (16, 16) and (2, 16, 16),
which no host here can build — and must give the same spec for every
parameter leaf of all ten configs, under both ``parallelism`` modes and
EP mode. Specs compare exactly, the reference's ``PartitionSpec`` as a
tuple. The port's own layout (a list of per-period dicts where the
reference stacks a depth axis) gets the stacked spec without its
leading entry. Execution is one rank's: ``constrain`` is the identity
on a one-rank mesh and raises on a larger one."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.sharding import policy as jpolicy
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.sharding import policy
from repro_torch.train import step as train_step
from repro_torch.tree_util import tree_leaves_with_path

ARCHS = sorted(jregistry.ARCH_MODULES)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MODES = [dict(parallelism="tp"), dict(parallelism="fsdp"),
         dict(parallelism="tp", ep_mode=True),
         dict(parallelism="tp", fsdp=False, kv_seq_shard=True)]


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _ref_shapes(arch):
    cfg = jregistry.get_config(arch)
    if cfg.family == "encdec":
        return jax.eval_shape(lambda: jencdec.init_params(
            cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    return jax.eval_shape(lambda: jlm.init_params(
        cfg, jax.random.PRNGKey(0), jnp.bfloat16))


def _as_port_tree(tree):
    """The reference's shape tree as nested dicts of shape holders."""
    if isinstance(tree, dict):
        return {k: _as_port_tree(v) for k, v in tree.items()}
    return types.SimpleNamespace(shape=tuple(tree.shape))


def _ref_specs(pol, shapes):
    specs = pol.tree_specs(shapes)
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                specs,
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flatten(tree[key], f"{path}[{key!r}]").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flatten(sub, f"{path}[{i}]").items()}
    return {path: tree}


@pytest.fixture(scope="module")
def ref_shapes():
    return {arch: _ref_shapes(arch) for arch in ARCHS}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", range(len(MODES)))
def test_param_specs_match_reference_leaf_for_leaf(ref_shapes, mesh, mode):
    kw = MODES[mode]
    for arch in ARCHS:
        jp = jpolicy.make_policy(_mesh(MESHES[mesh]), global_batch=256, **kw)
        tp = policy.make_policy(_mesh(MESHES[mesh]), global_batch=256, **kw)
        want = _ref_specs(jp, ref_shapes[arch])
        got = _flatten(tp.tree_specs(_as_port_tree(ref_shapes[arch])))
        assert got == want, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_port_layout_specs_are_the_stacked_specs_per_period(ref_shapes,
                                                             arch):
    """The port's own parameter tree (periods as a list, made on the
    ``meta`` device by ``train_state_shapes``): every leaf's spec is
    the reference's, a stacked leaf's without the depth entry."""
    jp = jpolicy.make_policy(_mesh(MESHES["16x16"]), global_batch=256)
    tp = policy.make_policy(_mesh(MESHES["16x16"]), global_batch=256)
    want = _ref_specs(jp, ref_shapes[arch])
    cfg = registry.get_config(arch)
    opt = AdamW(warmup_cosine(1e-3, 1, 10))
    shapes = train_step.train_state_shapes(cfg, opt)["params"]
    assert all(t.device.type == "meta" for t in
               (leaf for _, leaf in tree_leaves_with_path(shapes)))
    got = _flatten(tp.tree_specs(shapes))
    stacks = {"blocks", "enc_layers", "dec_layers"}
    unstacked = {}
    for path, spec in want.items():
        head = path.split("]")[0][2:-1]
        if head in stacks:
            rest = path[len(f"['{head}']"):]
            for i, sub in enumerate(shapes[head]):
                unstacked[f"['{head}'][{i}]{rest}"] = spec[1:]
        else:
            unstacked[path] = spec
    assert got == unstacked
    # every spec has one entry per dim of its leaf
    for path, leaf in tree_leaves_with_path(shapes):
        assert len(got[path]) == leaf.dim(), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 16, 32, 48, 256])
@pytest.mark.parametrize("mode", range(len(MODES)))
def test_make_policy_matches_reference(mesh, batch, mode):
    """Batch degradation (pod dropped first until the batch divides), the
    fsdp/tp/ep axes, the kv sequence axes, and every activation spec."""
    kw = MODES[mode]
    jp = jpolicy.make_policy(_mesh(MESHES[mesh]), global_batch=batch, **kw)
    tp = policy.make_policy(_mesh(MESHES[mesh]), global_batch=batch, **kw)
    for f in ("batch_axes", "fsdp_axes", "tp_axis", "ep_axis",
              "kv_seq_axes"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.dp_size == jp.dp_size
    for name in ("act_tokens", "act_hidden", "act_heads", "act_mlp",
                 "act_moe_dispatch"):
        assert getattr(tp, name)() == tuple(getattr(jp, name)()), name
    # the fallbacks: a vocab / kv-head count that does not divide the TP
    # axis moves the shard
    for v in (None, 151936, 151937, 256000, 51865):
        assert tp.act_logits(v) == tuple(jp.act_logits(v)), v
    for kv in (None, 1, 2, 8, 16, 32, 48):
        assert tp.act_kv_cache(kv) == tuple(jp.act_kv_cache(kv)), kv


def test_degradation_cases():
    mesh = _mesh(MESHES["2x16x16"])
    assert policy.make_policy(mesh, global_batch=64).batch_axes == \
        ("pod", "data")
    assert policy.make_policy(mesh, global_batch=16).batch_axes == ("data",)
    assert policy.make_policy(mesh, global_batch=1).batch_axes == ()
    kv = policy.make_policy(mesh, global_batch=1, kv_seq_shard=True)
    assert kv.act_kv_cache(8) == (None, ("model", "data"), None, None)
    assert kv.act_kv_cache(16) == (None, "data", "model", None)
    assert kv.act_logits(151937) == (None, None, None)


def test_one_rank_mesh_constrains_to_identity_and_places_leaves():
    pol = policy.make_policy(make_host_mesh(device="cpu"), global_batch=4)
    x = torch.randn(4, 8, 16)
    assert pol.constrain(x, pol.act_hidden()) is x
    place = pol.named(pol.act_hidden())
    t = place(np.ones((2, 3), np.float32))
    assert t.device.type == "cpu" and t.dtype == torch.float32
    assert torch.equal(t, torch.ones(2, 3))


def test_larger_mesh_raises_naming_part_5():
    """A larger mesh runs across ranks now (``test_torch_lm_ranks.py``);
    one of shapes only, with no ranks behind it, serves the specs and
    refuses to execute with ``ValueError``."""
    pol = policy.make_policy(_mesh(MESHES["16x16"]), global_batch=16)
    assert pol.param_spec(("blocks", "w_up"), (2, 64, 128)) == \
        (None, "data", "model")
    with pytest.raises(ValueError, match="names no ranks"):
        pol.constrain(torch.zeros(16, 4, 8), pol.act_hidden())
    with pytest.raises(ValueError, match="names no ranks"):
        pol.named(pol.act_hidden())


def test_state_shardings_place_the_whole_state():
    cfg = registry.get_reduced("qwen3-4b")
    opt = AdamW(warmup_cosine(1e-3, 1, 10))
    pol = policy.make_policy(make_host_mesh(device="cpu"), global_batch=2)
    shapes = train_step.train_state_shapes(cfg, opt)
    place = train_step.state_shardings(pol, shapes)
    leaves = dict(tree_leaves_with_path(shapes))
    fns = dict(tree_leaves_with_path(place))
    assert set(leaves) == set(fns)
    for path, leaf in leaves.items():
        got = fns[path](np.zeros(tuple(leaf.shape), np.float32
                                 if leaf.is_floating_point() else np.int32))
        assert got.shape == leaf.shape and got.device.type == "cpu", path
