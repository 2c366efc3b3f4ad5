"""Decoder blocks and the loop over depth (counterpart of
``repro/models/blocks.py``).

Models repeat a *pattern period* of layers (gemma2 alternates ("swa",
"full"); zamba2 is five "ssm" layers then one "hybrid" slot that invokes
the shared attention block). The reference stacks one period's
parameters with a leading ``n_groups`` axis and runs depth as one
``lax.scan``; here ``params["blocks"]`` is a list of per-period
parameter dicts and depth is a Python loop. Caches and SSM states keep
the reference's stacked layout: one cache (or ``SSMState``) per layer
slot of the period, with a leading ``n_groups`` axis, which the decode
loop reads and updates in place one depth index at a time.

``policy`` (``sharding.policy.Policy`` or None) is threaded to every
layer as in the reference, which constrains the hidden state after each
layer slot. ``stack_forward`` (the training forward) recomputes each
period in the backward pass (``remat``, the reference's
``jax.checkpoint`` around the scan body).

Across ranks a period's parameters are this rank's blocks; the period
takes them through ``Policy.use`` at its start (``_use_period``): the
FSDP axes all-gathered, one period at a time. Under remat that runs
inside the recomputed body, so the backward gathers each period again,
in the same order on every rank (every rank runs the same program), and
the gathers' backward reduce-scatters the gradients. Zamba2's shared
block is gathered the same way at each use (the hybrid slot of every
period), so its gradient sums over the uses; its attention and MLP run
on the local heads and hidden block as the attention layers' do, and the
SSM layers on the local SSD heads (``models/ssm.py``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ShapeOnly, dense_init, matmul,
                                       rms_norm)
from repro_torch.models.common import remat as _remat
from repro_torch.serve.kvcache import (cache_positions, cache_views, read_kv,
                                       update_any_cache)
from repro_torch.sharding.policy import period_specs, sharded


# ---------------------------------------------------------------------------
# Per-period parameter init
# ---------------------------------------------------------------------------

def init_layer_params(cfg, kind: str, gen, dtype) -> Dict[str, Any]:
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=gen.device)

    if kind == "ssm":
        return {"pre_norm": zeros(),
                "ssm": ssm_mod.init_ssm_params(cfg, gen, dtype)}
    if kind == "hybrid":
        # zamba2: a per-use projection of concat(hidden, first embedding)
        # to D; the attention/MLP weights are shared (init_shared_params)
        return {"pre_norm": zeros(),
                "fuse_proj": dense_init(gen, (2 * d, d), dtype,
                                        fan_in=2 * d),
                "ssm": ssm_mod.init_ssm_params(cfg, gen, dtype)}
    p: Dict[str, Any] = {
        "pre_norm": zeros(),
        "attn": attn_mod.init_attn_params(cfg, gen, dtype),
        "pre_mlp_norm": zeros(),
    }
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe_params(cfg, gen, dtype)
    else:
        p["mlp"] = mlp_mod.init_mlp_params(cfg, gen, dtype)
    if cfg.post_norm:  # gemma2 sandwich norms
        p["post_attn_norm"] = zeros()
        p["post_mlp_norm"] = zeros()
    return p


def init_period_params(cfg, gen, dtype) -> Dict[str, Any]:
    return {f"l{i}": init_layer_params(cfg, kind, gen, dtype)
            for i, kind in enumerate(cfg.layer_pattern)}


def init_shared_params(cfg, gen, dtype) -> Optional[Dict[str, Any]]:
    """Zamba2's shared attention+MLP block (one copy, used every
    period); None for archs without a hybrid slot."""
    if "hybrid" not in cfg.layer_pattern:
        return None
    zeros = dict(dtype=dtype, device=gen.device)
    return {
        "pre_norm": torch.zeros((cfg.d_model,), **zeros),
        "attn": attn_mod.init_attn_params(cfg, gen, dtype),
        "pre_mlp_norm": torch.zeros((cfg.d_model,), **zeros),
        "mlp": mlp_mod.init_mlp_params(cfg, gen, dtype),
    }


def n_groups(cfg) -> int:
    period = len(cfg.layer_pattern)
    assert cfg.num_layers % period == 0, (cfg.name, cfg.num_layers, period)
    return cfg.num_layers // period


# ---------------------------------------------------------------------------
# Layer pieces shared by prefill and decode
# ---------------------------------------------------------------------------

def _norm(cfg, x, scale):
    return rms_norm(x, scale, cfg.norm_eps, plus_one=True)


def _mlp_residual(cfg, p, x, policy=None):
    """x + (MLP or MoE)(norm x); returns (x, aux loss)."""
    h = _norm(cfg, x, p["pre_mlp_norm"])
    aux = 0.0
    if "moe" in p:
        out, aux = moe_mod.moe_mlp(cfg, p["moe"], h, policy)
    else:
        out = mlp_mod.mlp(cfg, p["mlp"], h, policy)
    if cfg.post_norm:
        out = _norm(cfg, out, p["post_mlp_norm"])
    return x + out, aux


def _attn_residual(cfg, p, x, attn, policy=None):
    out = attn_mod.out_proj(p["attn"], attn, cfg, policy)
    if cfg.post_norm:
        out = _norm(cfg, out, p["post_attn_norm"])
    return x + out


def _fused(cfg, p, shared, x, x0):
    """The hybrid slot's input to the shared block: fuse_proj over
    concat(x, x0), normed."""
    fused = matmul(torch.cat([x, x0], dim=-1), p["fuse_proj"])
    return _norm(cfg, fused, shared["pre_norm"])


def _shared_tail(cfg, shared, x, attn, policy=None):
    """The shared block after its attention: out-projection and MLP."""
    x = x + attn_mod.out_proj(shared["attn"], attn, cfg, policy)
    return x + mlp_mod.mlp(cfg, shared["mlp"],
                           _norm(cfg, x, shared["pre_mlp_norm"]), policy)


# ---------------------------------------------------------------------------
# Forward (prefill): full-sequence layer application
# ---------------------------------------------------------------------------

def _attn_layer(cfg, p, x, positions, kind, policy=None, *,
                want_cache=False):
    h = _norm(cfg, x, p["pre_norm"])
    q, k, v = attn_mod.project_qkv(cfg, p["attn"], h, positions,
                                   policy=policy)
    out = attn_mod.attention(q, k, v, kind=("swa" if kind == "swa"
                                            else "full"), cfg=cfg,
                             policy=policy)
    x, aux = _mlp_residual(cfg, p, _attn_residual(cfg, p, x, out, policy),
                           policy)
    return x, aux, (_constrain_cache(k, v, policy) if want_cache else None)


def _constrain_cache(k, v, policy):
    """Prefill-emitted K/V in the cache layout (the reference pins them
    before its scan stacks them). Across ranks, K/V sharded on their
    heads are the local heads already; K/V of every head (KV heads not
    dividing the model axis) stay whole here and ``lm.prefill`` cuts the
    finished cache's sequence, after padding or rolling it."""
    if policy is None or sharded(policy):
        return (k, v)
    spec = policy.act_kv_cache(k.shape[2])
    return (policy.constrain(k, spec), policy.constrain(v, spec))


def _ssm_layer(cfg, p, x, policy=None, *, want_state=False):
    h = _norm(cfg, x, p["pre_norm"])
    if want_state:
        out, st = ssm_mod.ssm_mixer(cfg, p["ssm"], h, policy,
                                    want_state=True)
        return x + out, st
    return x + ssm_mod.ssm_mixer(cfg, p["ssm"], h, policy), None


def _shared_block(cfg, shared, p, x, x0, positions, policy=None, *,
                  want_cache=False):
    """Zamba2 hybrid slot: the shared attn+MLP on concat(x, x0), then the
    slot's own SSM layer."""
    q, k, v = attn_mod.project_qkv(cfg, shared["attn"],
                                   _fused(cfg, p, shared, x, x0), positions,
                                   policy=policy)
    out = attn_mod.attention(q, k, v, kind="full", cfg=cfg, policy=policy)
    x = _shared_tail(cfg, shared, x, out, policy)
    x, st = _ssm_layer(cfg, p, x, policy, want_state=want_cache)
    return x, (_constrain_cache(k, v, policy) if want_cache else None), st


@functools.lru_cache(maxsize=64)
def _shared_specs(policy, cfg):
    """The shared block's specs under ``policy``, from its shapes."""
    return policy.tree_specs({"shared": init_shared_params(
        cfg, ShapeOnly(), torch.float32)})["shared"]


def _use_period(cfg, pparams, policy, shared=None):
    """The period's parameters and the shared block as its layers use
    them: across ranks, this rank's blocks with the FSDP axes gathered
    (``Policy.use``)."""
    if not sharded(policy):
        return pparams, shared
    if shared is not None and "hybrid" in cfg.layer_pattern:
        shared = policy.use_tree(shared, _shared_specs(policy, cfg))
    return policy.use_tree(pparams, period_specs(policy, cfg)), shared


def period_forward(cfg, pparams, x, x0, positions, policy=None, shared=None,
                   *, want_cache: bool = False):
    """Apply one pattern period. Returns (x, aux, caches, states): caches
    maps f"l{i}" to an attention slot's (k, v), states an SSM or hybrid
    slot's final ``SSMState``, when ``want_cache``."""
    pparams, shared = _use_period(cfg, pparams, policy, shared)
    aux_total = 0.0
    caches, states = {}, {}
    for i, kind in enumerate(cfg.layer_pattern):
        key, p = f"l{i}", pparams[f"l{i}"]
        if kind == "ssm":
            x, st = _ssm_layer(cfg, p, x, policy, want_state=want_cache)
            if want_cache:
                states[key] = st
        elif kind == "hybrid":
            x, cache, st = _shared_block(cfg, shared, p, x, x0, positions,
                                         policy, want_cache=want_cache)
            if want_cache:
                caches[key], states[key] = cache, st
        else:
            x, aux, cache = _attn_layer(cfg, p, x, positions, kind, policy,
                                        want_cache=want_cache)
            aux_total = aux_total + aux
            if want_cache:
                caches[key] = cache
        if policy is not None:
            x = policy.constrain(x, policy.act_hidden())
    return x, aux_total, caches, states


def stack_forward(cfg, blocks: List[Dict[str, Any]], x, positions,
                  policy=None, shared=None, *, remat: bool = True,
                  remat_policy=None):
    """All periods over depth; with ``remat``, each period's activations
    are recomputed in the backward pass instead of kept, but for what
    ``remat_policy`` saves (``common.checkpoint_policy``: the counterpart
    of the reference's ``jax.checkpoint`` saveable policy). Returns (x,
    summed aux loss, a float32 scalar)."""
    x0 = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(h, gparams):
        h, a, _, _ = period_forward(cfg, gparams, h, x0, positions, policy,
                                    shared)
        return h, a

    for gparams in blocks:
        if remat:
            x, a = _remat(body, x, gparams, policy=remat_policy)
        else:
            x, a = body(x, gparams)
        aux = aux + a
    return x, aux


def stack_prefill(cfg, blocks, x, positions, policy=None, shared=None):
    """Full-sequence pass that also emits every layer's cache and state:
    returns (x, caches, states), each a list over depth of dicts keyed
    f"l{i}"."""
    x0 = x
    caches, states = [], []
    for gparams in blocks:
        x, _, c, s = period_forward(cfg, gparams, x, x0, positions, policy,
                                    shared, want_cache=True)
        caches.append(c)
        states.append(s)
    return x, caches, states


# ---------------------------------------------------------------------------
# Decode: one token through the stack with per-layer caches
# ---------------------------------------------------------------------------

def _decode_attn(cfg, attn_p, h, cache, cur_pos, window=None, policy=None):
    """One token's attention against its cache, which gets the token's
    K/V written in place first (across ranks, into the rank that holds
    the slot where the cache's sequence is sharded)."""
    q, k, v = attn_mod.project_qkv(cfg, attn_p, h, positions_of(cur_pos, h),
                                   policy=policy)
    update_any_cache(cache, k, v, cur_pos, seq_block=seq_block(cfg, policy))
    k_r, v_r = read_kv(cache, k.dtype)
    return attn_mod.decode_attention(q, k_r, v_r, cache_positions(cache),
                                     cur_pos, cfg=cfg, window=window,
                                     policy=policy)


def _ssm_step(cfg, p, x, state: ssm_mod.SSMState, policy=None):
    """x + the SSM layer's one-token step; ``state`` (views into the
    stacked states) is overwritten with the new state."""
    out, new = ssm_mod.ssm_decode_step(cfg, p["ssm"],
                                       _norm(cfg, x, p["pre_norm"]), state,
                                       policy)
    for old, t in zip(state, new):
        old.copy_(t)
    return x + out


def period_decode(cfg, pparams, x, x0, caches, ssm_states, cur_pos,
                  policy=None, shared=None):
    """One-token step through a period. ``caches`` maps f"l{i}" to an
    attention or hybrid slot's cache, ``ssm_states`` an SSM or hybrid
    slot's ``SSMState``; both are updated in place."""
    pparams, shared = _use_period(cfg, pparams, policy, shared)
    for i, kind in enumerate(cfg.layer_pattern):
        key, p = f"l{i}", pparams[f"l{i}"]
        if kind == "ssm":
            x = _ssm_step(cfg, p, x, ssm_states[key], policy)
            continue
        if kind == "hybrid":
            out = _decode_attn(cfg, shared["attn"],
                               _fused(cfg, p, shared, x, x0), caches[key],
                               cur_pos, policy=policy)
            x = _shared_tail(cfg, shared, x, out, policy)
            x = _ssm_step(cfg, p, x, ssm_states[key], policy)
            continue
        out = _decode_attn(cfg, p["attn"], _norm(cfg, x, p["pre_norm"]),
                           caches[key], cur_pos,
                           window=cfg.window if kind == "swa" else None,
                           policy=policy)
        x, _ = _mlp_residual(cfg, p, _attn_residual(cfg, p, x, out, policy),
                             policy)
    return x


def seq_block(cfg, policy):
    """(index, count) of this rank's block of a KV cache's sequence, or
    None where the cache holds every slot (its KV heads shard over the
    model axis, or one rank)."""
    if not sharded(policy) or policy.tp_axis is None \
            or policy.kv_heads_sharded(cfg.num_kv_heads):
        return None
    return policy.tp_index(), policy.tp_size()


def positions_of(cur_pos, x):
    """Rope/mask positions for a one-token step; cur_pos int or (B,)."""
    B, S = x.shape[:2]
    if not torch.is_tensor(cur_pos) or cur_pos.dim() == 0:
        return torch.full((B, S), int(cur_pos), dtype=torch.int32,
                          device=x.device)
    return cur_pos[:, None].expand(B, S).to(torch.int32)


def stack_decode(cfg, blocks, x, caches, ssm_states, cur_pos, policy=None,
                 shared=None):
    """One token through all periods; ``caches`` / ``ssm_states`` map
    f"l{i}" to a cache / ``SSMState`` stacked over depth, updated in
    place. Returns x."""
    x0 = x
    for g, gparams in enumerate(blocks):
        views = {key: cache_views(c, g) for key, c in caches.items()}
        states = {key: ssm_mod.SSMState(*(t[g] for t in st))
                  for key, st in ssm_states.items()}
        x = period_decode(cfg, gparams, x, x0, views, states, cur_pos,
                          policy, shared)
    return x
