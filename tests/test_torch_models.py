"""The port's decoder LMs (configs, attention, blocks, lm, kvcache)
against the reference on CPU, at the reduced configs of the nine decoder
archs (dense, VLM with patch embeddings, MoE, SSM, hybrid; whisper's
enc-dec is ``tests/test_torch_encdec.py``). Weights are made once by the reference's ``lm.init_params``,
perturbed (so zero-initialised norms and biases are exercised), and
carried across by ``params_from_jax``; inputs are numpy arrays from a
seed. Bar: atol 1e-5 / rtol 1e-4 against the reference; the port's own
prefill-then-decode check keeps ``tests/test_serve.py``'s 2e-3 / 1e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import kvcache as jkv
from repro_torch.configs import registry
from repro_torch.models import attention, blocks, encdec, lm
from repro_torch.models.common import rms_norm, softcap
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import kvcache

ARCHS = ["qwen3-4b", "qwen2.5-14b", "gemma2-27b", "h2o-danube-1.8b"]
# the archs ported with ROADMAP queue 1 item 18: the VLM, MoE, SSM,
# hybrid and enc-dec families
NEW_ARCHS = ["internvl2-2b", "grok-1-314b", "dbrx-132b", "whisper-medium",
             "zamba2-2.7b", "mamba2-1.3b"]
DECODERS = ARCHS + [a for a in NEW_ARCHS if a != "whisper-medium"]
TOL = dict(atol=1e-5, rtol=1e-4)
# SSM and hybrid stacks: the chunked scan's bar (tests/test_ssm_oracle.py)
SSM_TOL = dict(atol=2e-4, rtol=2e-4)


def _tol(cfg):
    return SSM_TOL if cfg.ssm is not None else TOL


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _models(arch, seed=0):
    """(reference cfg, port cfg, reference params, port params). The
    SSM and hybrid stacks get a smaller perturbation: at 0.1 their
    float32 recurrence is ill-conditioned (after zamba2's six reduced
    layers the reference and the port alike lie 1.6e-2 from a float64
    run of the same stack, at 0.02 within 3e-4)."""
    jcfg, cfg = jregistry.get_reduced(arch), registry.get_reduced(arch)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    noise = 0.02 if cfg.ssm is not None else 0.1
    tree = jax.tree.map(
        lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(
        cfg, tree, device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batch(cfg, tokens, seed=2):
    """A prompt batch as numpy arrays: the VLM's carries seeded patch
    embeddings in its first ``num_patches`` positions."""
    batch = {"tokens": tokens}
    if cfg.frontend == "vit_stub":
        batch["patch_embeds"] = np.random.default_rng(seed).standard_normal(
            (tokens.shape[0], cfg.num_patches, lm.VIT_STUB_DIM)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch):
    for get in ("get_config", "get_reduced"):
        assert (dataclasses.asdict(getattr(registry, get)(arch))
                == dataclasses.asdict(getattr(jregistry, get)(arch)))


def test_registry_lists_the_reference_archs():
    assert registry.list_archs() == jregistry.list_archs()


# each config and reduced config is the reference's, and the reduced one
# initialises
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_configs_match_the_reference_and_initialise(arch):
    assert arch in jregistry.ARCH_MODULES
    for get in ("get_config", "get_reduced"):
        assert (dataclasses.asdict(getattr(registry, get)(arch))
                == dataclasses.asdict(getattr(jregistry, get)(arch)))
    cfg = registry.get_reduced(arch)
    gen = torch.Generator().manual_seed(0)
    params = (encdec.init_params(cfg, gen, torch.float32)
              if cfg.family == "encdec"
              else lm.init_params(cfg, gen, torch.float32))
    assert all(bool(torch.isfinite(t).all())
               for t in _leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_project_qkv_matches_reference(arch):
    jcfg, cfg, jp, tp = _models(arch)
    p = jp["blocks"]["l0"]["attn"]
    x = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    want = jattn.project_qkv(jcfg, jax.tree.map(lambda a: a[0], p),
                             jnp.asarray(x), jnp.asarray(pos))
    got = attention.project_qkv(cfg, tp["blocks"][0]["l0"]["attn"],
                                torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)


def _qkv(S, H=4, KV=2, hd=16, B=2, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd)).astype(np.float32)
                 for n in (H, KV, KV))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [None, 50.0])
def test_attention_cpu_branches_match_reference(causal, cap):
    q, k, v = _qkv(64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(attention.attention_direct(tq, tk, tv, causal=causal, cap=cap),
           jattn.attention_direct(jq, jk, jv, causal=causal, cap=cap))
    _close(attention.attention_blockwise(tq, tk, tv, causal=causal, cap=cap,
                                         q_block=16, kv_block=32),
           jattn.attention_blockwise(jq, jk, jv, causal=causal, cap=cap,
                                     q_block=16, kv_block=32))
    _close(attention.attention_banded(tq, tk, tv, window=24, cap=cap,
                                      q_block=16),
           jattn.attention_banded(jq, jk, jv, window=24, cap=cap,
                                  q_block=16))


@pytest.mark.parametrize("cap", [None, 50.0])
def test_banded_attention_takes_a_ragged_last_block(cap):
    """S = 40 in q blocks of 16: the last block takes the 8 positions left
    (the reference's banded attention needs S a multiple of its block, so
    it is held against the reference's direct sliding-window attention
    over the whole sequence)."""
    q, k, v = _qkv(40)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention.attention_banded(tq, tk, tv, window=24, cap=cap,
                                     q_block=16)
    assert got.shape == tq.shape
    _close(got, jattn.attention_direct(*map(jnp.asarray, (q, k, v)),
                                       causal=True, cap=cap, window=24))


@pytest.mark.parametrize("arch,kind,S", [
    ("qwen3-4b", "full", 48),             # direct
    ("h2o-danube-1.8b", "swa", 64),       # banded (S > window 32)
    ("h2o-danube-1.8b", "swa", 24),       # direct with a window
    ("gemma2-27b", "full", 48),           # softcap
    ("gemma2-27b", "bidir", 48),
])
def test_attention_entry_point_matches_reference(arch, kind, S):
    jcfg, cfg = jregistry.get_reduced(arch), registry.get_reduced(arch)
    q, k, v = _qkv(S, H=cfg.num_heads, KV=cfg.num_kv_heads)
    got = attention.attention(*map(torch.from_numpy, (q, k, v)), kind=kind,
                              cfg=cfg)
    want = jattn.attention(*map(jnp.asarray, (q, k, v)), kind=kind,
                           cfg=jcfg)
    _close(got, want)
    # under a one-device policy (the training path) the reference's
    # attention(..., policy=...) result, and no flash launch
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro.sharding.policy import make_policy as jmake_policy
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.policy import make_policy
    launches = flash_attention.launches
    got = attention.attention(
        *map(torch.from_numpy, (q, k, v)), kind=kind, cfg=cfg,
        policy=make_policy(make_host_mesh(device="cpu"), global_batch=2))
    want = jattn.attention(
        *map(jnp.asarray, (q, k, v)), kind=kind, cfg=jcfg,
        policy=jmake_policy(jmake_host_mesh((1, 1)), global_batch=2))
    _close(got, want)
    assert flash_attention.launches == launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same_state(got, want, tol=None):
    assert set(got["caches"]) == set(want["caches"])
    for key, c in want["caches"].items():
        assert got["caches"][key].window == c.window
        for name in ("k", "v", "positions"):
            _close(getattr(got["caches"][key], name), getattr(c, name),
                   **(tol or {}))
    assert set(got["ssm"]) == set(want["ssm"])
    for key, st in want["ssm"].items():
        for g, w in zip(got["ssm"][key], st):
            _close(g, w, **(tol or {}))


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg, jp, tp = _models(arch)
    # 40 > the reduced window (32): SWA layers go banded and roll; 40 is
    # no multiple of the reduced SSM chunk (16): the scan pads
    S = 40 if cfg.window or cfg.ssm else 24
    batch = _batch(cfg, _tokens(cfg, 2, S + 2))
    tokens = batch["tokens"]
    tol = _tol(cfg)
    jl, jstate = jlm.prefill(jcfg, jp, {k: jnp.asarray(v[:, :S] if k ==
                                                       "tokens" else v)
                                        for k, v in batch.items()},
                             cache_len=S + 4)
    tl, tstate = lm.prefill(cfg, tp, {k: torch.from_numpy(
        v[:, :S] if k == "tokens" else v) for k, v in batch.items()},
        cache_len=S + 4)
    _close(tl, jl, **tol)
    _same_state(tstate, jstate, tol)
    for t in (S, S + 1):
        jl, jstate = jlm.decode_step(jcfg, jp, jnp.asarray(tokens[:, t:t + 1]),
                                     jstate)
        tl, tstate = lm.decode_step(cfg, tp, torch.from_numpy(
            tokens[:, t:t + 1]), tstate)
        _close(tl, jl, **tol)
        assert tstate["pos"] == jstate["pos"] == t + 1
    _same_state(tstate, jstate, tol)


def _forward_next_logits(cfg, params, tokens):
    """The port's full-sequence forward, last position: the reference of
    the prefill-then-decode checks (as ``tests/test_serve.py``)."""
    x = lm.embed_inputs(cfg, params, {"tokens": tokens})
    B, S = tokens.shape
    h, _ = blocks.stack_forward(cfg, params["blocks"], x,
                                torch.arange(S).expand(B, S), None,
                                params.get("shared"))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps, plus_one=True)
    return softcap(h[:, -1].float() @ lm.head_weights(cfg, params).float(),
                   cfg.final_softcap)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_matches_forward(arch):
    cfg = registry.get_reduced(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(3),
                            torch.float32)
    B, S = 2, 24
    tokens = torch.from_numpy(_tokens(cfg, B, S + 2, seed=3))
    _, state = lm.prefill(cfg, params, {"tokens": tokens[:, :S]},
                          cache_len=S + 4)
    for t in (S, S + 1):
        logits, state = lm.decode_step(cfg, params, tokens[:, t:t + 1],
                                       state)
        _close(logits[:, 0], _forward_next_logits(cfg, params,
                                                  tokens[:, :t + 1]),
               atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ["qwen3-4b", "h2o-danube-1.8b"])
def test_decode_from_empty_state_matches_forward(arch):
    """init_decode_state + decoding token by token == forward; for the
    SWA arch past the window, so the rolling cache wraps around."""
    cfg = registry.get_reduced(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(4),
                            torch.float32)
    S = cfg.window + 13 if cfg.window else 10
    tokens = torch.from_numpy(_tokens(cfg, 2, S, seed=4))
    state = lm.init_decode_state(cfg, 2, cfg.window or S + 2,
                                 torch.float32, device="cpu")
    for t in range(S):
        logits, state = lm.decode_step(cfg, params, tokens[:, t:t + 1],
                                       state)
    _close(logits[:, 0], _forward_next_logits(cfg, params, tokens),
           atol=3e-3, rtol=1e-3)
    if cfg.window:
        assert state["caches"]["l0"].k.shape[2] == cfg.window


def test_update_cache_per_row_matches_reference():
    rng = np.random.default_rng(5)
    k0 = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    knew = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    for window, pos in ((0, 4), (0, [1, 5, 0]), (6, [7, 2, 11])):
        want = jkv.update_cache(
            jkv.KVCache(jnp.asarray(k0), jnp.asarray(2 * k0),
                        jnp.full((3, 6), -1, jnp.int32), window),
            jnp.asarray(knew), jnp.asarray(2 * knew), jnp.asarray(pos))
        got = kvcache.update_cache(
            kvcache.KVCache(torch.from_numpy(k0.copy()),
                            torch.from_numpy(2 * k0),
                            torch.full((3, 6), -1, dtype=torch.int32),
                            window),
            torch.from_numpy(knew), torch.from_numpy(2 * knew),
            torch.tensor(pos) if isinstance(pos, list) else pos)
        for name in ("k", "v", "positions"):
            _close(getattr(got, name), getattr(want, name))


def test_params_from_jax_unstacks_depth_and_keeps_bf16():
    cfg = registry.get_reduced("gemma2-27b")
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jregistry.get_reduced("gemma2-27b"), jax.random.PRNGKey(0)))
    params = params_from_jax(cfg, tree, device="cpu")
    assert len(params["blocks"]) == blocks.n_groups(cfg) == 2
    assert "head" not in params                       # tied embeddings
    wq = params["blocks"][1]["l1"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        tree["blocks"]["l1"]["attn"]["wq"][1].astype(np.float32))
