"""The SSM, hybrid, enc-dec and VLM models across ranks on the CPU, against
the reference under GSPMD: mamba2, zamba2, whisper and internvl2 served
and trained under the sharding policy.

The reference runs once, split over five subprocesses on four host
devices each;
the port once, over four spawned gloo ranks (``torch_ranks.py`` job
``lm_families``), both from one set of seeded numpy weights of the
reference's shapes per case (``torch_ranks.FAM_CASES``): the four
families on (2, 2); mamba2 and internvl2 on (1, 4) (4 SSD heads a rank;
2 KV heads not dividing the model axis, so the cache shards its slots);
whisper and internvl2 with a vocab of 515, which does not divide the
model axis (the replicated ``act_logits`` branch, ``lookup`` and
``project`` on ``P(None, fsdp)`` and ``P(fsdp, None)``, the tied head);
mamba2 with two B/C groups on both meshes; whisper with 2 KV heads on
(1, 4); mamba2 with 4 SSD heads, whose per-head vectors the policy
replicates.

Per case: the prefill logits and eight greedy decode steps (the tokens
equal; each step's logits within 1e-4 of their max), ``loss_fn`` (1e-5)
and every gradient leaf (1e-4 of its max); on (2, 2) two AdamW steps
(losses 1e-5, every parameter 1e-4, and each leaf's update within 1e-2
of the reference's: AdamW's eps is 1e-2 here, ``torch_ranks.
FAM_TRAIN_EPS``); whisper's encoder output. The SSM stacks' bars, and
the trained parameters', are raised leaf by leaf (step by step for the
logits) to 4x how far float32 rounding alone moves that leaf (``_bars``).
Besides:
a reduced zamba2 train state saved from (2, 2) (its manifest and
sha256s a one-rank save's; restored onto (1, 1)), and ``serve.main
--arch zamba2-2.7b`` and ``train.main --arch whisper-medium`` on four
ranks against one.

The SSM stacks take the reference's init plus 0.02 of seeded noise, as
``test_torch_models.py`` does (larger weights make their float32
recurrence ill-conditioned); the other families seeded normal weights
of scale 0.1 in every leaf, the zero-initialised norms and biases too.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as T
from repro.configs import registry as jregistry
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import encdec, lm
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.sharding.policy import make_policy
from repro_torch.train import step as tstep
from repro_torch.tree_util import tree_leaves

SRC = str(Path(__file__).resolve().parents[1] / "src")
# the reference's cases over five subprocesses, balanced by their jit
# compiles, which set the file's time (the port's four ranks take ~20 s):
# zamba2's period on its mesh and on one device, each alone
REF_GROUPS = (("zamba2_2x2@mesh",), ("zamba2_2x2@one",),
              ("mamba2_2x2", "mamba2_1x4", "whisper_odd", "mamba2h4_2x2"),
              ("whisper_2x2", "mamba2g2_2x2", "internvl2_1x4"),
              ("internvl2_2x2", "mamba2g2_1x4", "internvl2_odd",
               "whisperkv2_1x4"))
LOSS_TOL = 1e-5
TOL = 1e-4
# the SSM and hybrid stacks' logits: ``test_torch_models.py``'s SSM bar
# (their float32 recurrence amplifies rounding: reduced zamba2's
# one-device logits lie 8.9e-5 from the reference's, and both ~3e-4 from
# a run with float64 weights)
SSM_TOL = 2e-4
# the SSM stacks' logits steps and gradient leaves, and every family's
# trained parameters: float32 resolves them no better than rounding alone
# moves them (reduced zamba2's gradient leaves move by up to 4.5e-3 in
# the reference itself when only its mesh changes; Adam divides each
# element's gradient by its size, so an element whose gradient is
# rounding-sized steps by up to its learning rate either way). So there
# each step's or leaf's bar is the larger of the fixed one and SPREAD
# times that step's or leaf's own movement (``_bars``): the reference's
# one-device run against its mesh run, and for the gradients and the
# steps also the port's one-rank run against the reference's one-device
# run
SPREAD = 4
# each trained leaf's update (after less before) within UPDATE_TOL of the
# reference's, or SPREAD times its own movement where larger; that bar
# stays below 1 / UPDATE_MARGIN, so an update skipped or gone wrong shows
UPDATE_TOL = 1e-2
UPDATE_MARGIN = 4
# a gradient leaf that is zero in exact arithmetic (a key bias: adding a
# constant to every key logit of a query leaves its softmax unchanged)
# holds rounding, ~1e-9 of the largest leaf's max in both packages; each
# leaf's scale is at least ZERO_FLOOR of that largest max
ZERO_FLOOR = 1e-4

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, sys.argv[3])
    import torch_ranks as T
    from repro.compat import make_mesh
    from repro.configs import registry
    from repro.data.pipeline import ShardedLoader
    from repro.models import encdec, lm
    from repro.optim.adamw import AdamW, warmup_cosine
    from repro.sharding.policy import make_policy
    from repro.train import step as jstep

    with np.load(sys.argv[2]) as f:
        inputs = dict(f)
    out = {}

    def put(prefix, t):
        out.update(T.flatten(jax.tree.map(np.asarray, t), prefix))

    meshes = {}

    # a case's prefill and greedy decode, loss and gradients, and (the
    # trained cases) AdamW steps, under pol (None: one device)
    def run(key, pol, params, tag):
        cfg = T.fam_config(registry, key)
        model = encdec if cfg.family == "encdec" else lm
        prompt = {k: jnp.asarray(v) for k, v in
                  T.fam_prompt(inputs, key, cfg).items()}
        if cfg.family == "encdec" and pol is not None:
            out[key + "_encode"] = np.asarray(jax.jit(
                lambda p, f: encdec.encode(cfg, p, f, pol))(
                params, prompt["frames"]))
        if pol is not None or cfg.ssm is not None:
            logits, state = jax.jit(lambda p, b: model.prefill(
                cfg, p, b, pol, cache_len=T.FAM_S + T.FAM_DECODE))(
                params, prompt)
            decode = jax.jit(lambda p, t, s: model.decode_step(
                cfg, p, t, s, pol))
            steps = [np.asarray(logits)]
            for _ in range(T.FAM_DECODE):
                tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(
                    jnp.int32)
                logits, state = decode(params, tok, state)
                steps.append(np.asarray(logits))
            out[key + tag + "_logits"] = np.stack(steps)
        if pol is None and cfg.ssm is None:
            if key not in T.FAM_TRAIN_CASES:
                return
        else:
            batch = {k: jnp.asarray(v)
                     for k, v in T.fam_batch(cfg, 0).items()}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: model.loss_fn(cfg, p, batch, pol,
                                        loss_chunk=T.FAM_CHUNK)[0]))(params)
            out[key + tag + "_loss"] = np.asarray(loss)
            put(key + tag + "_grad/", grads)
        if key not in T.FAM_TRAIN_CASES:
            return
        opt = T.fam_opt(AdamW, warmup_cosine)
        fn = jax.jit(jstep.make_train_step(
            cfg, pol, opt, loss_chunk=T.FAM_CHUNK,
            compute_dtype=jnp.float32))
        jstate = {"params": params, "opt": opt.init(params),
                  "step": jnp.zeros((), jnp.int32)}
        for step in range(T.FAM_STEPS):
            jstate, m = fn(jstate, {k: jnp.asarray(v) for k, v in
                                    T.fam_batch(cfg, step).items()})
            out[f"{key}{tag}_train_loss_{step}"] = np.asarray(m["loss"])
        put(key + tag + "_train_param/", jstate["params"])

    # "case" runs it on its mesh and (the SSM stacks, the trained cases)
    # on one device: how far the reference itself moves when only its
    # mesh changes; "case@mesh" and "case@one" one part each
    for item in sys.argv[4].split(","):
        key, _, part = item.partition("@")
        cfg = T.fam_config(registry, key)
        tree = jax.tree.map(jnp.asarray,
                            T.unflatten(inputs, key + "/params/"))
        if part != "one":
            shape = T.FAM_CASES[key][1]
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"))
            pol = make_policy(meshes[shape], global_batch=T.FAM_B)
            if key in T.FAM_LOADER_CASES:
                loader = ShardedLoader(lambda s: T.fam_batch(cfg, s), pol)
                _, b = next(loader)
                loader.close()
                devices = list(meshes[shape].devices.flat)
                for k, v in b.items():
                    for sh in v.addressable_shards:
                        out[f"{key}_loader_{k}_"
                            f"{devices.index(sh.device)}"] = \\
                            np.asarray(sh.data)
            run(key, pol, jax.device_put(tree, pol.tree_shardings(tree)), "")
        if part != "mesh" and (cfg.ssm is not None
                               or key in T.FAM_TRAIN_CASES):
            run(key, None, tree, "_one")
    np.savez(sys.argv[1], **out)
""")


def _init(cfg):
    """The reference's init for ``cfg`` (a function of a PRNG key)."""
    if cfg.family == "encdec":
        return lambda k: jencdec.init_params(cfg, k, jnp.float32)
    return lambda k: jlm.init_params(cfg, k, jnp.float32)


def _weights(cfg, seed):
    """Seeded weights of the reference's shapes: the SSM stacks its init
    plus 0.02 of noise, the others normal of scale 0.1 in every leaf."""
    rng = np.random.default_rng(seed)
    if cfg.ssm is not None:
        tree = jax.tree.map(np.asarray, _init(cfg)(jax.random.PRNGKey(seed)))
        return jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(
            a.shape)).astype(a.dtype), tree)
    return jax.tree.map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        jax.eval_shape(_init(cfg), jax.random.PRNGKey(seed)))


def _inputs():
    inputs = {}
    rng = np.random.default_rng(1)
    for i, key in enumerate(T.FAM_CASES):
        cfg = T.fam_config(jregistry, key)
        inputs.update(T.flatten(_weights(cfg, 30 + i), f"{key}/params/"))
        inputs[f"{key}/prompts"] = rng.integers(
            0, cfg.vocab_size, (T.FAM_B, T.FAM_S)).astype(np.int32)
        if cfg.frontend == "vit_stub":
            inputs[f"{key}/patch_embeds"] = (0.1 * rng.standard_normal(
                (T.FAM_B, cfg.num_patches, jlm.VIT_STUB_DIM))).astype(
                np.float32)
        if cfg.family == "encdec":
            inputs[f"{key}/frames"] = rng.standard_normal(
                (T.FAM_B, T.FAM_FRAMES, cfg.d_model)).astype(np.float32)
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference, port, inputs, workdir): the reference's subprocesses
    and the port's four ranks run side by side."""
    inputs = _inputs()
    work = tmp_path_factory.mktemp("fam_ranks")
    jwork = tmp_path_factory.mktemp("fam_jax")
    np.savez(jwork / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    assert sorted({k.partition("@")[0] for g in REF_GROUPS for k in g}) \
        == sorted(T.FAM_CASES)
    parts = [",".join(g) for g in REF_GROUPS]
    refs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(jwork / f"out{i}.npz"),
         str(jwork / "inputs.npz"), str(Path(__file__).parent), cases],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, cases in enumerate(parts)]
    try:
        port = T.run_ranks("lm_families", work, inputs)
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


def _err(got, want, floor=0.0):
    """max |got - want| over max(max |want|, floor)."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), floor, 1e-30)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) / scale


def _rel(got, want, tol, floor=0.0):
    err = _err(got, want, floor)
    assert err <= tol, (err, tol)


def _port_order(cfg, reference, prefix):
    """The reference's leaves under ``prefix`` in the port's layout and
    leaf order."""
    tree = T.unflatten(reference, prefix)
    return [t.numpy() for t in
            tree_leaves(params_from_jax(cfg, tree, device="cpu"))]


def _bars(cfg, reference, key, what, tol, floor=0.0, port=None):
    """A case's bar for each of its logits steps or leaves (``what``:
    ``"logits"``, ``"grad"``, ``"train_param"``), in the port's order:
    ``tol``; on an SSM stack, and for every family's trained parameters,
    SPREAD times how far float32 rounding alone moves that step or leaf,
    where that is larger: how far the reference moves when only its mesh
    changes (its run on the case's mesh against its one-device run, to
    the same ``floor``), and for an SSM stack's gradients also how far
    the port's one-rank run lies from the reference's one-device run
    (``port``: the same sums in another order). Each step or leaf is held
    to its own movement, not to the case's worst."""
    if what == "logits":
        mesh = reference[f"{key}_logits"]
        if cfg.ssm is None:
            return [tol] * len(mesh)
        one = reference[f"{key}_one_logits"]
        for a, b in zip(one, mesh):  # both greedy: the same tokens
            np.testing.assert_array_equal(a[:, -1].argmax(-1),
                                          b[:, -1].argmax(-1))
    else:
        mesh = _port_order(cfg, reference, f"{key}_{what}/")
        if cfg.ssm is None and what != "train_param":
            return [tol] * len(mesh)
        one = _port_order(cfg, reference, f"{key}_one_{what}/")
    moved = [_err(a, b, floor) for a, b in zip(one, mesh, strict=True)]
    if port is not None:
        moved = [max(m, _err(port[f"{key}_one_{what}_{i:03d}"], a, floor))
                 for i, (m, a) in enumerate(zip(moved, one))]
    return [max(tol, SPREAD * m) for m in moved]


@pytest.mark.parametrize("key", list(T.FAM_CASES))
def test_prefill_and_greedy_decode_match_the_reference(runs, key):
    """The prefill logits and eight greedy decode steps: each step picks
    the reference's tokens, and its logits lie within its bar."""
    reference, port, _, _ = runs
    cfg = T.fam_config(registry, key)
    want, got = reference[f"{key}_logits"], port[f"{key}_logits"]
    assert got.shape == want.shape == (T.FAM_DECODE + 1, T.FAM_B, 1,
                                       cfg.vocab_size)
    bars = _bars(cfg, reference, key, "logits",
                 SSM_TOL if cfg.ssm is not None else TOL)
    print(key, "logits bars", bars)
    for g, w, tol in zip(got, want, bars, strict=True):
        np.testing.assert_array_equal(g[:, -1].argmax(-1),
                                      w[:, -1].argmax(-1))
        _rel(g, w, tol)


@pytest.mark.parametrize("key", list(T.FAM_CASES))
def test_loss_and_every_gradient_leaf_match_the_reference(runs, key):
    """``loss_fn`` and every gradient leaf, each leaf within its own bar;
    on an SSM stack the port's one-rank gradients also lie within the
    case's bar of the reference's one-device ones."""
    reference, port, _, _ = runs
    cfg = T.fam_config(registry, key)
    jl, tl = float(reference[f"{key}_loss"]), float(port[f"{key}_loss"])
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    want = _port_order(cfg, reference, f"{key}_grad/")
    assert f"{key}_grad_{len(want):03d}" not in port
    floor = ZERO_FLOOR * max(float(np.max(np.abs(w))) for w in want)
    if cfg.ssm is not None:
        case = max(_bars(cfg, reference, key, "grad", TOL, floor))
        for i, w in enumerate(_port_order(cfg, reference,
                                          f"{key}_one_grad/")):
            _rel(port[f"{key}_one_grad_{i:03d}"], w, case, floor)
    bars = _bars(cfg, reference, key, "grad", TOL, floor, port)
    print(key, "gradient bars", bars)
    for i, (w, tol) in enumerate(zip(want, bars, strict=True)):
        g = port[f"{key}_grad_{i:03d}"]
        assert g.shape == w.shape
        _rel(g, w, tol, floor)


@pytest.mark.parametrize("key", T.FAM_TRAIN_CASES)
def test_train_steps_match_the_reference(runs, key):
    """Two AdamW steps on (2, 2): the losses; every parameter leaf after
    the last step; and each leaf's update (after less before) within
    UPDATE_TOL of the reference's, or SPREAD times its own movement where
    larger, a bar that stays below 1 / UPDATE_MARGIN: so an update skipped
    or gone wrong shows on every leaf."""
    reference, port, inputs, _ = runs
    cfg = T.fam_config(registry, key)
    for step in range(T.FAM_STEPS):
        jl = float(reference[f"{key}_train_loss_{step}"])
        one = float(reference[f"{key}_one_train_loss_{step}"])
        spread = max(abs(one - jl), abs(float(
            port[f"{key}_one_train_loss_{step}"]) - one))
        assert abs(float(port[f"{key}_train_loss_{step}"]) - jl) \
            <= max(LOSS_TOL * abs(jl), SPREAD * spread)
    want = _port_order(cfg, reference, f"{key}_train_param/")
    one = _port_order(cfg, reference, f"{key}_one_train_param/")
    before = _port_order(cfg, inputs, f"{key}/params/")
    bars = _bars(cfg, reference, key, "train_param", TOL, port=port)
    upd = []
    for i, (w, o, b, tol) in enumerate(zip(want, one, before, bars,
                                           strict=True)):
        got = port[f"{key}_train_param_{i:03d}"]
        _rel(got, w, tol)
        moved = max(_err(o - b, w - b), _err(
            port[f"{key}_one_train_param_{i:03d}"] - b, o - b))
        upd.append(max(UPDATE_TOL, SPREAD * moved))
        assert upd[-1] <= 1 / UPDATE_MARGIN, (i, upd[-1])
        _rel(got - b, w - b, upd[-1])
    print(key, "parameter bars", bars, "update bars", upd)


@pytest.mark.parametrize("key", T.FAM_LOADER_CASES)
def test_sharded_loader_rows_are_the_reference_shards(runs, key):
    """``ShardedLoader``'s rows of the frames and the patch embeddings
    (beside tokens and labels), bit for bit the reference's addressable
    shards."""
    reference, port, _, _ = runs
    keys = [k for k in reference if k.startswith(f"{key}_loader_")]
    assert len(keys) == 3 * T.WORLD
    assert any("frames" in k or "patch_embeds" in k for k in keys)
    for k in keys:
        np.testing.assert_array_equal(port[k], reference[k], err_msg=k)


@pytest.mark.parametrize("key", [k for k in T.FAM_CASES
                                 if k.startswith("whisper")])
def test_whisper_encoder_output_matches_the_reference(runs, key):
    reference, port, _, _ = runs
    want = reference[f"{key}_encode"]
    assert port[f"{key}_encode"].shape == want.shape
    _rel(port[f"{key}_encode"], want, TOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-medium", "internvl2-2b"])
def test_each_family_runs_on_a_two_by_two_policy(runs, arch):
    """Each family ran prefill, decode, ``loss_fn`` and the train step
    under the (2, 2) policy, where the port raised
    ``NotImplementedError`` before: finite values of the expected
    shapes, and ``init_decode_state``'s empty state this rank's block in
    prefill's layout."""
    _, port, _, _ = runs
    key = {"mamba2-1.3b": "mamba2_2x2", "zamba2-2.7b": "zamba2_2x2",
           "whisper-medium": "whisper_2x2",
           "internvl2-2b": "internvl2_2x2"}[arch]
    assert T.FAM_CASES[key][:2] == (arch, (2, 2))
    cfg = registry.get_reduced(arch)
    assert bool(port[f"{key}_state_shapes"])   # init_decode_state's blocks
    logits = port[f"{key}_logits"]
    assert logits.shape == (T.FAM_DECODE + 1, T.FAM_B, 1, cfg.vocab_size)
    assert np.isfinite(logits).all()
    assert np.isfinite(float(port[f"{key}_loss"]))
    assert all(np.isfinite(float(port[f"{key}_train_loss_{s}"]))
               for s in range(T.FAM_STEPS))


def test_checkpoint_from_two_by_two_is_a_one_rank_save(runs, tmp_path):
    """A reduced zamba2 train state saved from (2, 2): its manifest (the
    leaves' shapes, dtypes and sha256s) is a one-rank save's, and it
    restores onto (1, 1) bit for bit."""
    _, _, inputs, work = runs
    key = T.FAM_CKPT_CASE
    cfg = T.fam_config(registry, key)
    tree = T.unflatten(inputs, f"{key}/params/")
    state = train_state_from_jax(cfg, T.lm_state(tree), device="cpu")
    ckpt.save(tmp_path / "one", 0, state)

    def manifest(d):
        return json.loads((d / "step_00000000" / "manifest.json")
                          .read_text())
    got = manifest(work / "fam_ckpt")
    assert got == manifest(tmp_path / "one")
    assert got["leaves"] and all("sha256" in x for x in got["leaves"])
    pol = make_policy(make_host_mesh(device="cpu"), global_batch=T.FAM_B)
    assert pol.one_rank
    shapes = tstep.train_state_shapes(cfg, AdamW(warmup_cosine(1e-3, 1, 10)))
    back = ckpt.restore(work / "fam_ckpt", 0, shapes,
                        place=tstep.state_shardings(pol, shapes))
    for g, w in zip(tree_leaves(back), tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_serve_and_train_entry_points_on_four_ranks(runs, tmp_path):
    """``serve.main --arch zamba2-2.7b`` on the (2, 2) world mesh decodes
    the one-rank run's tokens; ``train.main --arch whisper-medium``
    (bfloat16 compute) ends at the one-rank run's loss, to bfloat16's
    rounding."""
    _, port, _, _ = runs
    one = serve.main(T.FAM_SERVE)
    assert dict(port["serve_mesh"].tolist()) == {"data": 2, "model": 2}
    assert port["serve_sample"].tolist() == one["sample"]
    summ = train.main(T.FAM_TRAIN + ["--ckpt-dir", str(tmp_path / "c")])
    assert abs(float(port["train_final_loss"]) - summ["final_loss"]) \
        <= 2e-2 * abs(summ["final_loss"])


def test_ssm_groups_map_local_heads_by_their_global_index():
    """``_local_groups``: a rank's heads read the B/C groups of their
    global index, whether its block holds whole groups, lies inside one,
    or straddles them."""
    from repro_torch.models import ssm
    cfg = T.fam_config(registry, "mamba2g2_2x2")   # 16 heads, 2 groups
    t = torch.arange(2 * 3, dtype=torch.float32).reshape(1, 2, 3)
    heads = ssm._heads(t, 8)                        # (1, 16, 3) by head
    for first, n in ((0, 16), (0, 8), (8, 8), (4, 4), (12, 4), (6, 4)):
        rows = ssm._local_groups(cfg, t, first, n)
        got = ssm._heads(rows, n // rows.shape[-2])
        torch.testing.assert_close(got, heads[:, first:first + n],
                                   rtol=0, atol=0)


def test_families_keep_their_one_rank_route_without_a_mesh():
    """A one-rank policy (every extent 1) takes no collective: the
    multi-rank paths stay off, so the one-device numbers are unchanged."""
    pol = make_policy(make_host_mesh(device="cpu"), global_batch=2)
    assert pol.one_rank
    cfg = registry.get_reduced("whisper-medium")
    gen = torch.Generator().manual_seed(0)
    params = encdec.init_params(cfg, gen, torch.float32, policy=pol)
    frames = torch.randn((2, 8, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 4), generator=gen)
    with torch.no_grad():
        a, _ = encdec.prefill(cfg, params, {"frames": frames,
                                            "tokens": tokens}, pol)
        b, _ = encdec.prefill(cfg, params, {"frames": frames,
                                            "tokens": tokens})
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    cfg = registry.get_reduced("zamba2-2.7b")
    params = lm.init_params(cfg, gen, torch.float32, policy=pol)
    with torch.no_grad():
        a, _ = lm.prefill(cfg, params, {"tokens": tokens}, pol)
        b, _ = lm.prefill(cfg, params, {"tokens": tokens})
    torch.testing.assert_close(a, b, rtol=0, atol=0)
