"""The port's training path (``models/*.loss_fn``, ``chunked_softmax_xent``,
``train/step.py``) against the reference's on CPU.

Both packages take one state: the reference's ``init_train_state`` tree,
carried across by ``train_state_from_jax``; batches come from the
synthetic stream (numpy, identical in both). Both run under a sharding
policy on a one-device mesh, as ``launch/train.py`` does, at
``compute_dtype=float32``. Bars: the loss within 1e-5 relative; each
gradient leaf within 1e-4 of its largest |reference| entry (float32
products summed in other orders, through a remat'd chunked loss); the
SSM stack's loss at the chunked scan's 2e-4. Three ``make_train_step``
steps hold the loss, the gradient norm and every parameter leaf (1e-4
of its max |reference|) and the in-step monitor's spectra (1e-4, the
spectra being normalised to sum 1) on a report step, and its zeros on
a skip step. The JAX side compiles each function once (module-scoped
fixtures)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.insitu.chain import InSituChain as JChain
from repro.core.insitu.endpoints.spectral_monitor import (
    SpectralMonitorEndpoint as JMonitor)
from repro.data import synthetic
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import warmup_cosine as jwarmup_cosine
from repro.sharding.policy import make_policy as jmake_policy
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.core.insitu.chain import InSituChain
from repro_torch.core.insitu.endpoints.spectral_monitor import (
    SpectralMonitorEndpoint)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import encdec, lm
from repro_torch.models.common import chunked_softmax_xent
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.sharding.policy import make_policy
from repro_torch.train import step as tstep
from repro_torch.tree_util import tree_leaves

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SSM_TOL = 2e-4
B, S, CHUNK = 4, 32, 16


def _policies(batch=B):
    return (jmake_policy(jmake_host_mesh((1, 1)), global_batch=batch),
            make_policy(make_host_mesh(device="cpu"), global_batch=batch))


def _batch(cfg, step=0, batch=B, seq=S, patches=0):
    return synthetic.batch_at(step, global_batch=batch, seq_len=seq,
                              vocab=cfg.vocab_size, seed=0,
                              family=cfg.family, num_patches=patches,
                              patch_dim=jlm.VIT_STUB_DIM,
                              frame_dim=cfg.d_model)


def _rel_close(got, want, tol):
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    assert err <= tol * scale, (err, scale)


def _port_leaves(cfg, jtree):
    """The reference tree's leaves in the port's layout and order."""
    return tree_leaves(params_from_jax(cfg, jax.tree.map(np.asarray, jtree),
                                       device="cpu"))


def _perturbed(cfg, jcfg, seed=0, noise=0.1):
    """Reference params with every leaf perturbed (zero-initialised norms
    and biases take part), numpy leaves."""
    rng = np.random.default_rng(seed)
    init = jencdec.init_params if cfg.family == "encdec" else jlm.init_params
    kw = {"max_target": S} if cfg.family == "encdec" else {}
    tree = jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(seed),
                                         jnp.float32, **kw))
    return jax.tree.map(
        lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)


@pytest.fixture(scope="module")
def qwen():
    jcfg, cfg = jregistry.get_reduced("qwen3-4b"), \
        registry.get_reduced("qwen3-4b")
    return jcfg, cfg, _perturbed(cfg, jcfg)


def test_chunked_xent_matches_the_whole_logits():
    """Chunks of the sequence against one logsumexp over the whole
    (B, S, V) logits; padding labels (-1) count nothing."""
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 12, 8, generator=g)
    w = torch.randn(8, 50, generator=g)
    y = torch.randint(0, 50, (2, 12), generator=g)
    y[:, :3] = -1
    for chunk in (3, 4, 12, 100):
        loss, count = chunked_softmax_xent(h, w, y, chunk=chunk,
                                           final_cap=30.0)
        logits = torch.tanh((h @ w) / 30.0) * 30.0
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 50), y.reshape(-1), ignore_index=-1,
            reduction="sum")
        assert float(count) == 18.0
        assert abs(float(loss) - float(ce)) <= 1e-5 * float(ce)
    with pytest.raises(ValueError, match="chunks"):
        chunked_softmax_xent(h[:, :11], w, y[:, :11], chunk=4)


def test_loss_and_gradients_match_reference(qwen):
    """qwen3-4b reduced: ``loss_fn`` and its gradient under a one-device
    policy (the training path: no flash kernel, remat'd periods and
    chunked loss) against ``jax.value_and_grad`` of the reference's."""
    jcfg, cfg, tree = qwen
    jpol, tpol = _policies()
    batch = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, jpol,
                              loss_chunk=CHUNK), has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    params = params_from_jax(cfg, tree, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = lm.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, tpol,
                        loss_chunk=CHUNK)
    grads = torch.autograd.grad(tl, leaves)
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * S
    want = _port_leaves(cfg, jg)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        _rel_close(g.numpy(), w.numpy(), GRAD_TOL)


@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-1.3b",
                                  "whisper-medium", "internvl2-2b"])
def test_loss_value_matches_reference(arch):
    """The loss of the other families: MoE with its aux term, the SSM
    stack, the enc-dec on frames, the VLM on patch embeddings (their
    labels masked)."""
    jcfg, cfg = jregistry.get_reduced(arch), registry.get_reduced(arch)
    noise = 0.02 if cfg.ssm is not None else 0.1
    tree = _perturbed(cfg, jcfg, noise=noise)
    jpol, tpol = _policies()
    batch = _batch(cfg, patches=8 if cfg.frontend == "vit_stub" else 0)
    jfn = jencdec.loss_fn if cfg.family == "encdec" else jlm.loss_fn
    tfn = encdec.loss_fn if cfg.family == "encdec" else lm.loss_fn
    jl, jm = jax.jit(lambda p: jfn(jcfg, p, {k: jnp.asarray(v) for k, v in
                                             batch.items()}, jpol,
                                   loss_chunk=CHUNK))(
        jax.tree.map(jnp.asarray, tree))
    with torch.no_grad():
        tl, tm = tfn(cfg, params_from_jax(cfg, tree, device="cpu"),
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     tpol, loss_chunk=CHUNK)
    tol = SSM_TOL if cfg.ssm is not None else LOSS_TOL
    assert abs(float(tl) - float(jl)) <= tol * abs(float(jl))
    assert float(tm["tokens"]) == float(jm["tokens"])
    if cfg.moe is not None:
        assert float(jm["aux_loss"]) > 0
        _rel_close(float(tm["aux_loss"]), float(jm["aux_loss"]), LOSS_TOL)


def _chains():
    jhook = JChain([JMonitor(source="grads", nbins=8, max_tensors=4)],
                   mesh=jmake_host_mesh((1, 1))).initialize().as_step_hook()
    thook = InSituChain([SpectralMonitorEndpoint(
        source="grads", nbins=8, max_tensors=4)],
        mesh=make_host_mesh(device="cpu")).initialize().as_step_hook()
    return jhook, thook


STEPS = 3
EVERY = 2


@pytest.fixture(scope="module", params=[1, 2], ids=["mb1", "mb2"])
def three_steps(request, qwen):
    """Three steps of both packages' ``make_train_step`` from one state,
    with the in-step monitor every 2 steps; (reference, port) metrics
    per step and final states."""
    microbatches = request.param
    jcfg, cfg, _ = qwen
    jpol, tpol = _policies()
    jhook, thook = _chains()
    jopt = JAdamW(jwarmup_cosine(1e-3, 1, 10))
    topt = AdamW(warmup_cosine(1e-3, 1, 10))
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jpol, jopt, microbatches=microbatches, loss_chunk=CHUNK,
        compute_dtype=jnp.float32, insitu_chain=jhook, insitu_every=EVERY))
    tfn = tstep.make_train_step(
        cfg, tpol, topt, microbatches=microbatches, loss_chunk=CHUNK,
        compute_dtype=torch.float32, insitu_chain=thook, insitu_every=EVERY)
    jstate = jstep.init_train_state(jcfg, jopt, jax.random.PRNGKey(1))
    tstate = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    jm_all, tm_all = [], []
    for step in range(STEPS):
        batch = _batch(cfg, step)
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
        tstate, tm = tfn(tstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        jm_all.append(jax.tree.map(np.asarray, jm))
        tm_all.append(tm)
    return cfg, jstate, tstate, jm_all, tm_all


def test_train_steps_match_reference(three_steps):
    cfg, jstate, tstate, jm_all, tm_all = three_steps
    for jm, tm in zip(jm_all, tm_all):
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            LOSS_TOL * abs(float(jm["loss"]))
        _rel_close(float(tm["grad_norm"]), float(jm["grad_norm"]), LOSS_TOL)
        _rel_close(float(tm["lr"]), float(jm["lr"]), 1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS
    assert int(tstate["opt"]["count"]) == STEPS
    assert tstate["step"].dtype == torch.int32
    for name, got, want in (
            ("params", tstate["params"], jstate["params"]),
            ("m", tstate["opt"]["m"], jstate["opt"]["m"]),
            ("v", tstate["opt"]["v"], jstate["opt"]["v"])):
        want = _port_leaves(cfg, want)
        got = tree_leaves(got)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == torch.float32, name
            _rel_close(g.numpy(), w.numpy(), GRAD_TOL)


def test_in_step_monitor_reports_and_skips_as_the_reference(three_steps):
    """Report steps (0 and 2): the spectra of the first four gradient
    leaves of at least 64 columns, as the reference's; the skip step
    (1): zeros of the same keys, shapes and dtypes."""
    _, _, _, jm_all, tm_all = three_steps
    for step, (jm, tm) in enumerate(zip(jm_all, tm_all)):
        ji, ti = jm["insitu"], tm["insitu"]
        assert sorted(ti) == sorted(ji) == ["insitu_grad_spectra",
                                            "insitu_highfreq_frac"]
        for k in ji:
            assert tuple(ti[k].shape) == ji[k].shape, k
            assert ti[k].dtype == torch.float32
            if step % EVERY:
                assert float(ti[k].abs().max()) == 0.0
                assert float(np.abs(ji[k]).max()) == 0.0
            else:
                np.testing.assert_allclose(ti[k].numpy(), ji[k], atol=1e-4)
        if step % EVERY == 0:
            assert ti["insitu_grad_spectra"].shape == (4, 8)
            np.testing.assert_allclose(
                ti["insitu_grad_spectra"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_bf16_step_casts_and_keeps_float32_masters(qwen):
    """The default compute dtype: the gradient is taken through a
    bfloat16 copy (its leaves' dtype), the masters stay float32 and the
    loss tracks the float32 step's."""
    _, cfg, tree = qwen
    _, tpol = _policies()
    opt = AdamW(warmup_cosine(1e-3, 1, 10))
    seen = {}

    def hook(payload):
        seen["dtypes"] = {g.dtype for g in tree_leaves(payload["grads"])}
        return {"insitu_x": torch.zeros(())}
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    losses = {}
    for dtype in (torch.bfloat16, torch.float32):
        state = {"params": params_from_jax(cfg, tree, device="cpu"),
                 "step": torch.zeros((), dtype=torch.int32)}
        state["opt"] = opt.init(state["params"])
        fn = tstep.make_train_step(cfg, tpol, opt, loss_chunk=CHUNK,
                                   compute_dtype=dtype, insitu_chain=hook)
        state, m = fn(state, batch)
        losses[dtype] = float(m["loss"])
        assert seen["dtypes"] == {dtype}
        assert {p.dtype for p in tree_leaves(state["params"])} == \
            {torch.float32}
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) <= \
        2e-2 * losses[torch.float32]


def test_skip_shapes_come_from_a_meta_run_of_the_hook():
    calls = []

    def hook(payload):
        calls.append(payload["grads"]["w"].device.type)
        return {"insitu_a": payload["grads"]["w"][:2].sum(0),
                "insitu_b": torch.ones((), dtype=torch.float64)}
    z = tstep.hook_shapes(hook, {"grads": {"w": torch.ones(5, 3)}})
    assert calls == ["meta"]
    assert z == {"insitu_a": ((3,), torch.float32),
                 "insitu_b": ((), torch.float64)}


def test_train_state_from_jax_and_shapes(qwen):
    jcfg, cfg, _ = qwen
    jopt = JAdamW(jwarmup_cosine(1e-3, 1, 10))
    jstate = jax.tree.map(np.asarray, jstep.init_train_state(
        jcfg, jopt, jax.random.PRNGKey(0)))
    state = train_state_from_jax(cfg, jstate, device="cpu")
    shapes = tstep.train_state_shapes(cfg, AdamW(warmup_cosine(1e-3, 1, 10)))
    got = tree_leaves(state)
    want = tree_leaves(shapes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    fresh = tstep.init_train_state(cfg, AdamW(warmup_cosine(1e-3, 1, 10)),
                                   torch.Generator().manual_seed(3))
    again = tstep.init_train_state(cfg, AdamW(warmup_cosine(1e-3, 1, 10)),
                                   torch.Generator().manual_seed(3))
    for a, b in zip(tree_leaves(fresh), tree_leaves(again)):
        assert torch.equal(a, b)


def test_remat_policy_is_item_19(qwen):
    _, cfg, tree = qwen
    with pytest.raises(NotImplementedError, match="item 19"):
        lm.loss_fn(cfg, params_from_jax(cfg, tree, device="cpu"),
                   {k: torch.from_numpy(v) for k, v in _batch(cfg).items()},
                   remat_policy=object())


def test_every_family_trains_one_step():
    """Autograd runs through every family's loss (MoE dispatch, the SSD
    scan, the hybrid's shared block, the enc-dec, the VLM stub) and the
    step moves the parameters."""
    opt = AdamW(warmup_cosine(1e-3, 1, 10))
    pol = make_policy(make_host_mesh(device="cpu"), global_batch=2)
    for arch in sorted(registry.ARCH_MODULES):
        cfg = registry.get_reduced(arch)
        state = tstep.init_train_state(cfg, opt,
                                       torch.Generator().manual_seed(0),
                                       max_target=16)
        before = [p.clone() for p in tree_leaves(state["params"])]
        fn = tstep.make_train_step(cfg, pol, opt, loss_chunk=16)
        batch = {k: torch.from_numpy(v) for k, v in _batch(
            cfg, batch=2, seq=16,
            patches=4 if cfg.frontend == "vit_stub" else 0).items()}
        state, m = fn(state, batch)
        assert np.isfinite(float(m["loss"])), arch
        assert np.isfinite(float(m["grad_norm"])) and \
            float(m["grad_norm"]) > 0, arch
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(before, tree_leaves(state["params"])))
        assert moved > len(before) // 2, arch
