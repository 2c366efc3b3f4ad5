"""The port's dense LM (configs, attention, blocks, lm, kvcache) against
the reference on CPU, at the reduced configs of the four dense archs it
serves. Weights are made once by the reference's ``lm.init_params``,
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
from repro_torch.models import attention, blocks, lm
from repro_torch.models.common import rms_norm, softcap
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import kvcache

ARCHS = ["qwen3-4b", "qwen2.5-14b", "gemma2-27b", "h2o-danube-1.8b"]
TOL = dict(atol=1e-5, rtol=1e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _models(arch, seed=0):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, cfg = jregistry.get_reduced(arch), registry.get_reduced(arch)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    tree = jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(
        cfg, tree, device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch):
    for get in ("get_config", "get_reduced"):
        assert (dataclasses.asdict(getattr(registry, get)(arch))
                == dataclasses.asdict(getattr(jregistry, get)(arch)))


@pytest.mark.parametrize("arch", registry.NOT_PORTED)
def test_unported_archs_raise(arch):
    assert arch in jregistry.ARCH_MODULES
    for get in (registry.get_config, registry.get_reduced):
        with pytest.raises(NotImplementedError, match="item 18"):
            get(arch)


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
    with pytest.raises(NotImplementedError, match="policy"):
        attention.attention(*map(torch.from_numpy, (q, k, v)), kind=kind,
                            cfg=cfg, policy=object())


def _same_caches(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].window == want[key].window
        for name in ("k", "v", "positions"):
            _close(getattr(got[key], name), getattr(want[key], name))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg, jp, tp = _models(arch)
    # 40 > the reduced window (32): SWA layers go banded and roll
    S = 40 if cfg.window else 24
    tokens = _tokens(cfg, 2, S + 2)
    jl, jstate = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens[:, :S])},
                             cache_len=S + 4)
    tl, tstate = lm.prefill(cfg, tp, {"tokens": torch.from_numpy(
        tokens[:, :S])}, cache_len=S + 4)
    _close(tl, jl)
    _same_caches(tstate["caches"], jstate["caches"])
    for t in (S, S + 1):
        jl, jstate = jlm.decode_step(jcfg, jp, jnp.asarray(tokens[:, t:t + 1]),
                                     jstate)
        tl, tstate = lm.decode_step(cfg, tp, torch.from_numpy(
            tokens[:, t:t + 1]), tstate)
        _close(tl, jl)
        assert tstate["pos"] == jstate["pos"] == t + 1
    _same_caches(tstate["caches"], jstate["caches"])


def _forward_next_logits(cfg, params, tokens):
    """The port's full-sequence forward, last position: the reference of
    the prefill-then-decode checks (as ``tests/test_serve.py``)."""
    x = lm.embed_inputs(cfg, params, {"tokens": tokens})
    B, S = tokens.shape
    h = blocks.stack_forward(cfg, params["blocks"], x,
                             torch.arange(S).expand(B, S))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps, plus_one=True)
    return softcap(h[:, -1].float() @ lm.head_weights(cfg, params).float(),
                   cfg.final_softcap)


@pytest.mark.parametrize("arch", ARCHS)
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
