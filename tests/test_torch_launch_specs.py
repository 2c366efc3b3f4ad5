"""The port's ``launch/specs.py`` cells against the reference's on CPU, on
one-device meshes, for six reduced configs (dense, MoE, SSM, hybrid,
enc-dec, VLM) crossed with train, prefill and decode at a tiny
``ShapeConfig``.

Shapes: every leaf of the port's ``args`` has the shape and dtype of the
reference's ``build_cell`` ``ShapeDtypeStruct`` at its place (the
reference's parameter and train-state trees carried into the port's
layout by ``models/convert.py``; a python int is a () int32 leaf).

Values: both cells' ``fn`` on the same seeded inputs, the weights made
by the reference and carried across, both cells built with float32
float inputs (``batch_specs``' frames and patch embeddings; the
reference's whisper encoder takes no bfloat16 frames beside float32
weights). Prefill
and decode run with float32 parameters and cache (``param_dtype``
override) at ``tests/test_torch_models.py``'s bars (1e-5 / 1e-4, the SSM
stacks 2e-4); the train step at float32 compute (both packages'
``make_train_step`` given ``compute_dtype=float32``) at
``tests/test_torch_train.py``'s bars: the loss within 1e-5 relative, the
gradient norm within 1e-4 relative, every updated parameter leaf within
1e-4 of its max |reference|. On the SSM stacks (mamba2, zamba2) each
absolute bar is the larger of the fixed one and 4x the reference's own
movement under a last-bit change of its embedding, the rule of
``tests/test_torch_lm_ranks_families.py``: their gated norms amplify
float32 rounding by orders of magnitude on some inputs."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import specs as jspecs
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import encdec, lm
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.serve.kvcache import KVCache, QuantKVCache
from repro_torch.train import step as tstep
from repro_torch.tree_util import tree_leaves

ARCHS = ["qwen3-4b", "dbrx-132b", "mamba2-1.3b", "zamba2-2.7b",
         "whisper-medium", "internvl2-2b"]
KINDS = {"train": ("train_4k", 16, 2), "prefill": ("prefill_32k", 16, 2),
         "decode": ("decode_32k", 16, 2)}
TOL = dict(atol=1e-5, rtol=1e-4)
SSM_TOL = dict(atol=2e-4, rtol=2e-4)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ULP = 2.0 ** -23
SPREAD = 4


def _shapes(kind):
    name, seq, batch = KINDS[kind]
    return (JShapeConfig(name, seq, batch, kind),
            ShapeConfig(name, seq, batch, kind))


def _meshes():
    return jmake_host_mesh((1, 1)), make_host_mesh(device="cpu")


def _port_leaves(tree):
    """(shape, dtype name) of every leaf in jax's order: dict keys
    sorted, sequences and the caches' dataclass fields in order, a
    python int a () int32 leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _port_leaves(v)]
    if isinstance(tree, (KVCache, QuantKVCache)):
        return [x for f in dataclasses.fields(tree)
                if torch.is_tensor(getattr(tree, f.name))
                for x in _port_leaves(getattr(tree, f.name))]
    if isinstance(tree, int):
        return [((), "int32")]
    return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


def _ref_leaves(tree):
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree.leaves(tree)]


def _zeros(tree):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)


def _ref_args_in_port_layout(cfg, kind, jargs):
    """The reference's args with its parameter trees unstacked into the
    port's per-period lists (zeros of their shapes)."""
    if kind == "train":
        state, batch = jargs
        return (train_state_from_jax(cfg, _zeros(state), device="cpu"),
                batch)
    return (params_from_jax(cfg, _zeros(jargs[0]), device="cpu"),
            *jargs[1:])


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_args_and_fn_match_reference(arch, kind, monkeypatch):
    jcfg, cfg = jregistry.get_reduced(arch), registry.get_reduced(arch)
    jshape, shape = _shapes(kind)
    jmesh, mesh = _meshes()

    def same_args(jbuilt, built):
        got = _port_leaves(built["args"])
        want = (_port_leaves(_ref_args_in_port_layout(cfg, kind,
                                                      jbuilt["args"])[:1])
                + _ref_leaves(jbuilt["args"][1:]))
        assert got == want
        assert _port_leaves(built["local_args"]) == got   # one rank
        assert built["donate_argnums"] == jbuilt["donate_argnums"]
        assert built["meta"] == jbuilt["meta"]

    # shapes at the cells' own dtypes (a train cell's below: its state
    # and integer inputs are the same under the value cells' float32)
    if kind != "train":
        same_args(jspecs.build_cell(jcfg, jshape, jmesh)[0],
                  specs.build_cell(cfg, shape, mesh)[0])

    # values: float32 (see the module docstring), float inputs too
    rng = np.random.default_rng(0)

    def f32(batch_specs, sds, floating):
        def wrapped(*a, **k):
            batch, spec = batch_specs(*a, **k)
            return {n: sds(v) if floating(v) else v
                    for n, v in batch.items()}, spec
        return wrapped
    monkeypatch.setattr(jspecs, "batch_specs", f32(
        jspecs.batch_specs, lambda v: jax.ShapeDtypeStruct(v.shape,
                                                           jnp.float32),
        lambda v: jnp.issubdtype(v.dtype, jnp.floating)))
    monkeypatch.setattr(specs, "batch_specs", f32(
        specs.batch_specs, lambda v: torch.empty(v.shape, device="meta"),
        lambda v: v.is_floating_point()))
    if kind == "train":
        for mod, dt in ((jstep, jnp.float32), (tstep, torch.float32)):
            monkeypatch.setattr(mod, "make_train_step", functools.partial(
                mod.make_train_step, compute_dtype=dt))
        jbuilt, _ = jspecs.build_cell(jcfg, jshape, jmesh)
        built, _ = specs.build_cell(cfg, shape, mesh)
        same_args(jbuilt, built)
    else:
        jbuilt, _ = jspecs.build_cell(jcfg, jshape, jmesh,
                                      param_dtype=jnp.float32)
        built, _ = specs.build_cell(cfg, shape, mesh,
                                    param_dtype=torch.float32)
    ssm = cfg.ssm is not None
    init = jencdec.init_params if cfg.family == "encdec" else jlm.init_params
    jargs = jbuilt["args"]
    ptree = jargs[0]["params"] if kind == "train" else jargs[0]
    kw = ({"max_target": ptree["pos_embedding"].shape[0]}
          if cfg.family == "encdec" else {})
    params = jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0),
                                           jnp.float32, **kw))
    noise = 0.02 if ssm else 0.1
    params = jax.tree.map(
        lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
        params)
    # the SSM stacks' gated norms amplify float32 rounding (PERF.md §6):
    # their bar is the larger of the fixed one and 4x the reference's own
    # movement under a last-bit change of its embedding
    moved = dict(params, embedding=(params["embedding"] * (
        1 + ULP * rng.standard_normal(params["embedding"].shape))).astype(
            np.float32))

    def data(sds, hi=None):
        if np.issubdtype(sds.dtype, np.integer):
            return rng.integers(0, hi, sds.shape).astype(sds.dtype)
        return rng.standard_normal(sds.shape).astype(np.float32)

    def batch_of(jbatch):
        nb = {k: data(v, cfg.vocab_size) for k, v in jbatch.items()}
        return ({k: jnp.asarray(v) for k, v in nb.items()},
                {k: torch.from_numpy(v) for k, v in nb.items()})

    def bar(want, again, fixed):
        spread = np.max(np.abs(np.asarray(again) - np.asarray(want)))
        return max(fixed, SPREAD * float(spread)) if ssm else fixed

    if kind == "train":
        # init_train_state's tree around these parameters
        jstate = {"opt": jax.tree.map(np.asarray, jstep_opt().init(params)),
                  "step": np.zeros((), np.int32)}
        jb, tb = batch_of(jargs[1])
        jfn = jax.jit(jbuilt["fn"])
        jnew, jm = jfn(jax.tree.map(jnp.asarray, dict(jstate,
                                                       params=params)), jb)
        _, jm2 = jfn(jax.tree.map(jnp.asarray, dict(jstate, params=moved)),
                     jb)
        new, m = built["fn"](train_state_from_jax(
            cfg, dict(jstate, params=params), device="cpu"), tb)
        for key, fixed in (("loss", LOSS_TOL), ("grad_norm", GRAD_TOL)):
            want = float(jm[key])
            fixed *= abs(want)
            assert abs(float(m[key]) - want) <= \
                bar(want, float(jm2[key]), fixed), key
        for g, w in zip(tree_leaves(new["params"]),
                        tree_leaves(params_from_jax(
                            cfg, jax.tree.map(np.asarray, jnew["params"]),
                            device="cpu"))):
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= 1e-4 * scale
        return
    tp = params_from_jax(cfg, params, device="cpu")
    if kind == "prefill":
        jb, tb = batch_of(jargs[1])
        jl, _ = jbuilt["fn"](jax.tree.map(jnp.asarray, params), jb)
        jl2, _ = jbuilt["fn"](jax.tree.map(jnp.asarray, moved), jb)
        tl, _ = built["fn"](tp, tb)
    else:
        toks = data(jargs[1], cfg.vocab_size)
        B, S = shape.global_batch, shape.seq_len
        state = (encdec.init_decode_state(cfg, B, S,
                                          specs.WHISPER_CROSS_LEN,
                                          torch.float32, device="cpu")
                 if cfg.family == "encdec" else
                 lm.init_decode_state(cfg, B, S, torch.float32,
                                      device="cpu"))

        def jstate():
            return (jencdec.init_decode_state(jcfg, B, S,
                                              specs.WHISPER_CROSS_LEN,
                                              jnp.float32)
                    if cfg.family == "encdec" else
                    jlm.init_decode_state(jcfg, B, S, jnp.float32))
        jl, _ = jbuilt["fn"](jax.tree.map(jnp.asarray, params),
                             jnp.asarray(toks), jstate())
        jl2, _ = jbuilt["fn"](jax.tree.map(jnp.asarray, moved),
                              jnp.asarray(toks), jstate())
        tl, st = built["fn"](tp, torch.from_numpy(toks), state)
        assert st["pos"] == 1
    tol = SSM_TOL if ssm else TOL
    want = np.asarray(jl)
    np.testing.assert_allclose(
        tl.numpy(), want, rtol=tol["rtol"],
        atol=bar(want, jl2, tol["atol"]))


def jstep_opt():
    from repro.optim.adamw import AdamW, warmup_cosine
    return AdamW(warmup_cosine(3e-4, 2000, 100_000))


def test_registry_cells_are_the_reference_cells():
    assert registry.all_cells() == jregistry.all_cells()
    for arch in registry.list_archs():
        assert ([dataclasses.asdict(s) for s in registry.cells(arch)]
                == [dataclasses.asdict(s) for s in jregistry.cells(arch)])


def test_in_specs_follow_the_policy():
    """On the production mesh (shapes only) the cell's parameter specs
    are the policy's, the tokens' rows over the batch axes."""
    from types import SimpleNamespace
    cfg = registry.get_reduced("qwen3-4b")
    mesh = SimpleNamespace(shape={"data": 16, "model": 16})
    policy = specs.cell_policy(cfg, ShapeConfig("prefill_32k", 16, 32,
                                                "prefill"), mesh, False)
    assert policy.batch() == ("data",)
    dec = specs.cell_policy(cfg, ShapeConfig("decode_32k", 16, 1,
                                             "decode"), mesh, False)
    assert dec.kv_seq_axes == ("data",)


def test_train_cell_with_the_insitu_monitor():
    """``insitu=True`` (a hillclimb variant) hooks the spectral monitor
    into the cell's step: its spectra come out in the step's metrics."""
    cfg = registry.get_reduced("qwen3-4b")
    shape = ShapeConfig("train_4k", 16, 2, "train")
    built, _ = specs.build_cell(cfg, shape, make_host_mesh(device="cpu"),
                                insitu=True)
    state = tstep.init_train_state(
        cfg, jstep_opt_port(), torch.Generator().manual_seed(0),
        max_target=16)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    _, m = built["fn"](state, {"tokens": toks, "labels": toks})
    assert m["insitu"] and all(bool(torch.isfinite(v).all())
                               for v in m["insitu"].values())


def jstep_opt_port():
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    return AdamW(warmup_cosine(3e-4, 2000, 100_000))
