"""The port's LM substrate across ranks on the CPU (TP, FSDP and DP under
the sharding policy), against the reference under GSPMD.

The reference runs once, in two subprocesses on four host devices each
((2, 2), and the other two meshes); the port once, over four spawned
gloo ranks (``torch_ranks.py`` job ``lm``), both from one set of seeded
normal weights of the reference's shapes drawn here (the
zero-initialised norms and biases too, so they take part).

On the (2, 2), (1, 4) and (4, 1) ``("data", "model")`` meshes: the
prefill logits, the train steps (AdamW with the clip binding; two
microbatches on (2, 2)). On (2, 2) also eight greedy decode steps on
the float32 cache, eight teacher-forced steps on the int8 cache (the KV
head of reduced qwen3-4b does not divide the model axis, so the caches
shard their sequence), ``loss_fn`` and every gradient leaf, and the
in-step monitor's spectra. Bars: ``test_torch_train.py``'s (loss 1e-5,
gradients and parameters 1e-4 of each leaf's max), logits 1e-4 of their
max.

Besides: ``ShardedLoader``'s rows against the reference's addressable
shards bit for bit; gemma2, h2o-danube and qwen2.5 on (2, 2) (tied
embeddings with their gradient, softcaps, sliding windows over a
rolling cache sharded on its slots, padded heads); MoE with G = 2
dispatch groups on reduced grok-1 (TP experts) and dbrx (EP) at a
capacity where the reference's G = 2 and G = 1 differ; a (2, 2)
checkpoint's manifest against a one-rank save, its restore onto (2, 2)
and (1, 1), and the reference's checkpoint restored onto (2, 2);
``serve.main`` and ``train.main`` on four ranks against one, and with
``--transit-consumers 1`` on three ranks (a two-rank producer mesh); the
families this slice does not shard raise before any collective.
"""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as T
from repro.ckpt import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import encdec, lm, moe
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.sharding.policy import make_policy
from repro_torch.train import step as tstep
from repro_torch.tree_util import tree_leaves

SRC = str(Path(__file__).resolve().parents[1] / "src")
LOSS_TOL = 1e-5
TOL = 1e-4

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, sys.argv[3])
    import torch_ranks as T
    from repro.compat import make_mesh
    from repro.configs import registry
    from repro.core.insitu.chain import InSituChain
    from repro.core.insitu.endpoints.spectral_monitor import (
        SpectralMonitorEndpoint)
    from repro.data.pipeline import ShardedLoader
    from repro.models import lm, moe
    from repro.optim.adamw import AdamW, warmup_cosine
    from repro.sharding.policy import make_policy
    from repro.train import step as jstep

    with np.load(sys.argv[2]) as f:
        inputs = dict(f)
    cfg = registry.get_reduced(T.LM_ARCH)
    tree = jax.tree.map(jnp.asarray, T.unflatten(inputs, "params/"))
    prompts = jnp.asarray(inputs["prompts"])
    out = {}

    def put(prefix, t):
        out.update(T.flatten(jax.tree.map(np.asarray, t), prefix))

    for mkey in sys.argv[4].split(","):
        mesh = make_mesh(T.LM_MESHES[mkey], ("data", "model"))
        pol = make_policy(mesh, global_batch=T.LM_B)
        params = jax.device_put(tree, pol.tree_shardings(tree))
        logits, state = jax.jit(lambda p, b: lm.prefill(
            cfg, p, b, pol, cache_len=T.LM_CACHE))(params, {"tokens": prompts})
        out[f"{mkey}_prefill"] = np.asarray(logits)
        if mkey == "2x2":
            decode = jax.jit(lambda p, t, s: lm.decode_step(cfg, p, t, s, pol))
            steps, toks = [], []
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            for _ in range(T.LM_DECODE):
                toks.append(np.asarray(tok))
                logits, state = decode(params, tok, state)
                steps.append(np.asarray(logits))
                tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            out["2x2_decode"] = np.stack(steps)
            out["2x2_tokens"] = np.concatenate(toks, axis=1)
            st = lm.init_decode_state(cfg, T.LM_B, T.LM_CACHE, jnp.float32,
                                      pol, cache_impl="int8")
            steps = []
            for t in range(T.LM_DECODE):
                logits, st = decode(params, prompts[:, t:t + 1], st)
                steps.append(np.asarray(logits))
            out["2x2_int8"] = np.stack(steps)
            batch = {k: jnp.asarray(v) for k, v in
                     T.lm_batch(cfg.vocab_size, 0).items()}
            loss, grads = jax.jit(jax.value_and_grad(lambda p: lm.loss_fn(
                cfg, p, batch, pol, loss_chunk=T.LM_CHUNK)[0]))(params)
            out["2x2_loss"] = np.asarray(loss)
            put("2x2_grad/", grads)
        opt = AdamW(warmup_cosine(T.LM_LR, 1, 10), grad_clip=T.LM_CLIP)
        hook = None
        if mkey == "2x2":
            hook = InSituChain([SpectralMonitorEndpoint(
                source="grads", nbins=8, max_tensors=4)],
                mesh=mesh).initialize().as_step_hook()
        fn = jax.jit(jstep.make_train_step(
            cfg, pol, opt, microbatches=T.LM_MICRO[mkey],
            loss_chunk=T.LM_CHUNK, compute_dtype=jnp.float32,
            insitu_chain=hook, insitu_every=T.LM_MONITOR_EVERY))
        jstate = {"params": params, "opt": opt.init(params),
                  "step": jnp.zeros((), jnp.int32)}
        for step in range(T.LM_STEPS[mkey]):
            jstate, m = fn(jstate, {k: jnp.asarray(v) for k, v in
                                    T.lm_batch(cfg.vocab_size, step).items()})
            out[f"{mkey}_train_loss_{step}"] = np.asarray(m["loss"])
            out[f"{mkey}_train_gnorm_{step}"] = np.asarray(m["grad_norm"])
            if hook is not None:
                out[f"{mkey}_train_spectra_{step}"] = np.asarray(
                    m["insitu"]["insitu_grad_spectra"])
        put(f"{mkey}_train_param/", jstate["params"])
        loader = ShardedLoader(lambda s: T.lm_batch(cfg.vocab_size, s), pol)
        _, b = next(loader)
        loader.close()
        devices = list(mesh.devices.flat)
        for k, v in b.items():
            for sh in v.addressable_shards:
                out[f"{mkey}_loader_{k}_{devices.index(sh.device)}"] = \\
                    np.asarray(sh.data)
        if mkey == "2x2":
            for arch in T.MOE_ARCHS:
                mcfg = T.moe_config(registry, arch)
                mpol = make_policy(mesh, global_batch=T.MOE_B,
                                   ep_mode=mcfg.moe.mode == "ep")
                p = jax.tree.map(jnp.asarray,
                                 T.unflatten(inputs, f"moe_{arch}/"))
                x = jnp.asarray(inputs[f"moe_{arch}_x"])
                w = jnp.asarray(inputs[f"moe_{arch}_w"])

                def loss(p, pol):
                    y, aux = moe.moe_mlp(mcfg, p, x, pol)
                    return jnp.sum(y * w) + aux, (y, aux)
                (_, (y, aux)), g = jax.jit(jax.value_and_grad(
                    lambda p: loss(p, mpol), has_aux=True))(p)
                out[f"moe_{arch}_y"] = np.asarray(y)
                out[f"moe_{arch}_aux"] = np.asarray(aux)
                put(f"moe_{arch}_grad/", g)
                out[f"moe_{arch}_y_g1"] = np.asarray(jax.jit(
                    lambda p: moe.moe_mlp(mcfg, p, x, None)[0])(p))
            for arch in T.DENSE_ARCHS:
                dcfg = registry.get_reduced(arch)
                dp = jax.tree.map(jnp.asarray,
                                  T.unflatten(inputs, f"dense_{arch}/"))
                dp = jax.device_put(dp, pol.tree_shardings(dp))
                logits, st = jax.jit(lambda p, b: lm.prefill(
                    dcfg, p, b, pol, cache_len=T.DENSE_S + T.DENSE_DECODE))(
                    dp, {"tokens": jnp.asarray(
                        inputs[f"dense_{arch}_prompts"])})
                step = jax.jit(lambda p, t, s: lm.decode_step(
                    dcfg, p, t, s, pol))
                steps = [np.asarray(logits)]
                for _ in range(T.DENSE_DECODE):
                    tok = jnp.argmax(logits[:, -1], -1)[:, None] \
                        .astype(jnp.int32)
                    logits, st = step(dp, tok, st)
                    steps.append(np.asarray(logits))
                out[f"dense_{arch}_logits"] = np.stack(steps)
                if arch == "gemma2-27b":
                    batch = {k: jnp.asarray(v) for k, v in
                             T.lm_batch(dcfg.vocab_size, 0).items()}
                    loss, g = jax.jit(jax.value_and_grad(
                        lambda p: lm.loss_fn(dcfg, p, batch, pol,
                                             loss_chunk=T.LM_CHUNK)[0]))(dp)
                    out[f"dense_{arch}_loss"] = np.asarray(loss)
                    put(f"dense_{arch}_grad/", g)
    np.savez(sys.argv[1], **out)
""")


def _weights(init, seed, scale=0.1):
    """Seeded normal weights of the shapes ``init`` makes (every leaf,
    the zero-initialised norms and biases too, so they take part)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(a.dtype),
        jax.eval_shape(init, jax.random.PRNGKey(seed)))


def _inputs():
    cfg = jregistry.get_reduced(T.LM_ARCH)
    rng = np.random.default_rng(1)
    inputs = T.flatten(_weights(
        lambda k: jlm.init_params(cfg, k, jnp.float32), 0), "params/")
    inputs["prompts"] = rng.integers(0, cfg.vocab_size,
                                     (T.LM_B, T.LM_S)).astype(np.int32)
    for i, arch in enumerate(T.DENSE_ARCHS):
        dcfg = jregistry.get_reduced(arch)
        inputs.update(T.flatten(_weights(
            lambda k: jlm.init_params(dcfg, k, jnp.float32), 20 + i),
            f"dense_{arch}/"))
        inputs[f"dense_{arch}_prompts"] = rng.integers(
            0, dcfg.vocab_size, (T.LM_B, T.DENSE_S)).astype(np.int32)
    for i, arch in enumerate(T.MOE_ARCHS):
        mcfg = T.moe_config(jregistry, arch)
        inputs.update(T.flatten(_weights(
            lambda k: jmoe.init_moe_params(mcfg, k, jnp.float32), 10 + i),
            f"moe_{arch}/"))
        shape = (T.MOE_B, T.MOE_S, mcfg.d_model)
        inputs[f"moe_{arch}_x"] = rng.standard_normal(shape).astype(
            np.float32)
        inputs[f"moe_{arch}_w"] = rng.standard_normal(shape).astype(
            np.float32)
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port, inputs, workdir): the reference's subprocess and
    the port's four ranks run side by side."""
    inputs = _inputs()
    work = tmp_path_factory.mktemp("lm_ranks")
    jwork = tmp_path_factory.mktemp("lm_jax")
    np.savez(jwork / "inputs.npz", **inputs)
    jckpt.save(work / "jax_ckpt", 0, T.lm_state(T.unflatten(inputs,
                                                            "params/")))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    # one subprocess for (2, 2), one for the other two meshes
    refs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(jwork / f"out{i}.npz"),
         str(jwork / "inputs.npz"), str(Path(__file__).parent), meshes],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, meshes in enumerate(("2x2", "1x4,4x1"))]
    try:
        port = T.run_ranks("lm", work, inputs)
        logs = [ref.communicate(timeout=T.TIMEOUT_S)[0] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    reference = {}
    for i, (ref, log) in enumerate(zip(refs, logs)):
        assert ref.returncode == 0, log[-3000:]
        with np.load(jwork / f"out{i}.npz", allow_pickle=True) as f:
            reference.update(f)
    return reference, port, inputs, work


def _rel(got, want, tol):
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    assert err <= tol * scale, (err, scale)


def _port_order(cfg, reference, prefix):
    """The reference's leaves under ``prefix`` in the port's layout and
    leaf order."""
    tree = T.unflatten(reference, prefix)
    return [t.numpy() for t in
            tree_leaves(params_from_jax(cfg, tree, device="cpu"))]


@pytest.mark.parametrize("mkey", list(T.LM_MESHES))
def test_prefill_logits_match_the_reference(runs, mkey):
    reference, port, _, _ = runs
    want, got = reference[f"{mkey}_prefill"], port[f"{mkey}_prefill"]
    assert got.shape == want.shape == (T.LM_B, 1, 512)
    _rel(got, want, TOL)


def test_decode_on_both_caches_matches_the_reference(runs):
    """Greedy decode on the float32 cache (the tokens equal) and
    teacher-forced decode on the int8 cache, on (2, 2)."""
    reference, port, _, _ = runs
    np.testing.assert_array_equal(port["2x2_tokens"], reference["2x2_tokens"])
    for key in ("2x2_decode", "2x2_int8"):
        assert port[key].shape == reference[key].shape
        for got, want in zip(port[key], reference[key]):
            _rel(got, want, TOL)


def test_loss_and_every_gradient_leaf_match_the_reference(runs):
    reference, port, _, _ = runs
    cfg = registry.get_reduced(T.LM_ARCH)
    jl, tl = float(reference["2x2_loss"]), float(port["2x2_loss"])
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    want = _port_order(cfg, reference, "2x2_grad/")
    got = [port[f"2x2_grad_{i:03d}"] for i in range(len(want))]
    assert f"2x2_grad_{len(want):03d}" not in port
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _rel(g, w, TOL)


@pytest.mark.parametrize("mkey", list(T.LM_MESHES))
def test_train_steps_match_the_reference(runs, mkey):
    """AdamW steps with the clip binding (the gradient norm above it on
    every step), two microbatches on (2, 2): losses, norms, and every
    parameter leaf after the last step."""
    reference, port, _, _ = runs
    cfg = registry.get_reduced(T.LM_ARCH)
    for step in range(T.LM_STEPS[mkey]):
        jl = float(reference[f"{mkey}_train_loss_{step}"])
        assert abs(float(port[f"{mkey}_train_loss_{step}"]) - jl) \
            <= LOSS_TOL * abs(jl)
        jn = float(reference[f"{mkey}_train_gnorm_{step}"])
        assert jn > T.LM_CLIP
        _rel(float(port[f"{mkey}_train_gnorm_{step}"]), jn, LOSS_TOL)
        key = f"{mkey}_train_spectra_{step}"
        if key in reference:
            _rel(port[key], reference[key], TOL)
    want = _port_order(cfg, reference, f"{mkey}_train_param/")
    for i, w in enumerate(want):
        _rel(port[f"{mkey}_train_param_{i:03d}"], w, TOL)


@pytest.mark.parametrize("mkey", list(T.LM_MESHES))
def test_sharded_loader_rows_are_the_reference_shards(runs, mkey):
    reference, port, _, _ = runs
    keys = [k for k in reference if k.startswith(f"{mkey}_loader_")]
    assert len(keys) == 2 * T.WORLD
    for key in keys:
        np.testing.assert_array_equal(port[key], reference[key], err_msg=key)


@pytest.mark.parametrize("arch", T.DENSE_ARCHS)
def test_other_dense_decoders_match_the_reference(runs, arch):
    """Prefill past the sliding window and greedy decode on (2, 2) (the
    tokens each step picks agree, every step's logits within the bar);
    gemma2's loss and every gradient leaf, its tied embedding's among
    them."""
    reference, port, _, _ = runs
    want, got = (r[f"dense_{arch}_logits"] for r in (reference, port))
    assert got.shape == want.shape
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:, -1].argmax(-1),
                                      w[:, -1].argmax(-1))
        _rel(g, w, TOL)
    if f"dense_{arch}_loss" in reference:
        cfg = registry.get_reduced(arch)
        jl = float(reference[f"dense_{arch}_loss"])
        assert abs(float(port[f"dense_{arch}_loss"]) - jl) <= \
            LOSS_TOL * abs(jl)
        want = _port_order(cfg, reference, f"dense_{arch}_grad/")
        for i, w in enumerate(want):
            _rel(port[f"dense_{arch}_grad_{i:03d}"], w, TOL)


@pytest.mark.parametrize("arch", T.MOE_ARCHS)
def test_moe_dispatch_groups_match_the_reference(runs, arch):
    """G = 2 on (2, 2), where the reference's G = 2 and G = 1 outputs
    differ by far more than the bar: the output, the aux loss and the
    gradient of every expert leaf."""
    reference, port, inputs, _ = runs
    y = reference[f"moe_{arch}_y"]
    scale = float(np.max(np.abs(y)))
    assert float(np.max(np.abs(reference[f"moe_{arch}_y_g1"] - y))) \
        > 100 * TOL * scale
    _rel(port[f"moe_{arch}_y"], y, TOL)
    _rel(float(port[f"moe_{arch}_aux"]), float(reference[f"moe_{arch}_aux"]),
         LOSS_TOL)
    grads = T.unflatten(reference, f"moe_{arch}_grad/")
    assert sorted(grads) == ["moe_down", "moe_gate", "moe_up", "router"]
    for name, want in grads.items():
        _rel(port[f"moe_{arch}_grad_{name}"], want, TOL)


@pytest.mark.parametrize("arch", T.MOE_ARCHS)
def test_moe_groups_on_one_rank_match_the_reference(runs, arch):
    """``moe_mlp(groups=2)`` on one rank: the reference's grouping, the
    bar a card run holds its ranks against."""
    reference, _, inputs, _ = runs
    cfg = T.moe_config(registry, arch)
    p = {k: torch.from_numpy(np.array(v)) for k, v in
         T.unflatten(inputs, f"moe_{arch}/").items()}
    with torch.no_grad():
        y, _ = moe.moe_mlp(cfg, p, torch.from_numpy(inputs[f"moe_{arch}_x"]),
                           groups=2)
        y1, _ = moe.moe_mlp(cfg, p, torch.from_numpy(inputs[f"moe_{arch}_x"]))
    _rel(y.numpy(), reference[f"moe_{arch}_y"], TOL)
    _rel(y1.numpy(), reference[f"moe_{arch}_y_g1"], TOL)


def test_checkpoints_across_meshes(runs, tmp_path):
    """The (2, 2) save's manifest is a one-rank save's; it restores onto
    (2, 2) and (1, 1); the reference's checkpoint restores onto (2, 2)."""
    _, port, inputs, work = runs
    cfg = registry.get_reduced(T.LM_ARCH)
    tree = T.unflatten(inputs, "params/")
    state = train_state_from_jax(cfg, T.lm_state(tree), device="cpu")
    ckpt.save(tmp_path / "one", 0, state)

    def manifest(d):
        return json.loads((d / "step_00000000" / "manifest.json")
                          .read_text())
    assert manifest(work / "ckpt22") == manifest(tmp_path / "one")
    want = [t.numpy() for t in tree_leaves(state["params"])]
    for i, w in enumerate(want):
        np.testing.assert_array_equal(port[f"ckpt_restored_{i:03d}"], w)
        np.testing.assert_array_equal(port[f"ckpt_jax_{i:03d}"], w)
    pol = make_policy(make_host_mesh(device="cpu"), global_batch=T.LM_B)
    shapes = tstep.train_state_shapes(cfg, AdamW(warmup_cosine(1e-3, 1, 10)))
    back = ckpt.restore(work / "ckpt22", 0, shapes,
                        place=tstep.state_shardings(pol, shapes))
    for g, w in zip(tree_leaves(back["params"]), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_serve_and_train_entry_points_on_four_ranks(runs, tmp_path):
    """``serve.main`` on the (2, 2) world mesh decodes the one-rank run's
    tokens; ``train.main`` (bfloat16 compute, an injected failure at step
    3 restored from the gathered checkpoint) ends at the one-rank run's
    loss, to bfloat16's rounding."""
    _, port, _, _ = runs
    one = serve.main(T.LM_SERVE)
    assert dict(port["serve_mesh"].tolist()) == {"data": 2, "model": 2}
    assert port["serve_sample"].tolist() == one["sample"]
    summ = train.main(T.LM_TRAIN + ["--ckpt-dir", str(tmp_path / "c")])
    assert int(port["train_restarts"]) == 1
    assert abs(float(port["train_final_loss"]) - summ["final_loss"]) \
        <= 2e-2 * abs(summ["final_loss"])


def test_transit_consumers_with_a_two_rank_producer_mesh(tmp_path):
    """``--transit-consumers 1`` on three ranks: two ranks decode and
    train on a (2, 1) mesh; the consumer writes the monitor's and the
    spectra's files, the producers none."""
    out = T.run_ranks("lm_transit", tmp_path, {}, world=3)
    p0, p1, cons = (out[f"rank{r}"].tolist() for r in range(3))
    one = serve.main(T.LM_SERVE)
    assert p0[0] == p1[0] == one["sample"]
    assert cons[1] == 1 and p0[1] == p1[1] == 0      # 2 snapshots, 1 batch
    assert p0[2] == p1[2] and cons[3] == 2 and p0[3] == p1[3] == 0


def _multi_rank_policy():
    """A (2, 2) policy over a mesh whose positions are ranks (the checks
    that refuse run before any collective)."""
    from repro_torch.compat import Mesh
    mesh = Mesh(("data", "model"), {"data": 2, "model": 2},
                torch.device("cpu"), {"data": 0, "model": 0},
                ranks=(0, 1, 2, 3))
    return make_policy(mesh, global_batch=4)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-medium", "internvl2-2b"])
def test_unsharded_families_raise_naming_part_7(arch):
    cfg = registry.get_reduced(arch)
    pol = _multi_rank_policy()
    tokens = torch.zeros((4, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="item 18 part 7"):
        if cfg.family == "encdec":
            encdec.loss_fn(cfg, {}, {"tokens": tokens}, pol)
        else:
            lm.prefill(cfg, {"embedding": torch.zeros(1)},
                       {"tokens": tokens}, pol)
    with pytest.raises(NotImplementedError, match="item 18 part 7"):
        tstep.make_train_step(cfg, pol, AdamW(warmup_cosine(1e-3, 1, 10)))


def test_constrain_off_the_world_raises_value_error():
    """A mesh whose ranks are not this world's (here: no process group,
    four ranks) refuses to execute; a mesh of shapes only too."""
    pol = _multi_rank_policy()
    with pytest.raises(ValueError, match="not ranks of this world"):
        pol.constrain(torch.zeros(4, 2, 8), pol.act_hidden())
    with pytest.raises(ValueError, match="not ranks of this world"):
        pol.named(pol.act_hidden())
    fake = make_policy(types.SimpleNamespace(shape={"data": 2, "model": 2}),
                       global_batch=4)
    with pytest.raises(ValueError, match="names no ranks"):
        fake.gather(torch.zeros(2), (None,))
