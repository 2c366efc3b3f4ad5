"""Decoder blocks and the loop over depth (counterpart of
``repro/models/blocks.py``), for the attention layers of the dense
archs.

Models repeat a *pattern period* of layers (gemma2 alternates ("swa",
"full")). The reference stacks one period's parameters with a leading
``n_groups`` axis and runs depth as one ``lax.scan``; here
``params["blocks"]`` is a list of per-period parameter dicts and depth
is a Python loop. Caches keep the reference's stacked layout: one
``KVCache`` per layer slot of the period, with a leading ``n_groups``
axis, which the decode loop reads and updates one depth index at a
time. MoE, SSM and hybrid layers raise (ROADMAP queue 1 item 18).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import rms_norm
from repro_torch.serve.kvcache import (KVCache, cache_positions, read_kv,
                                       update_cache)


def check_dense(cfg, kind: str) -> None:
    if kind not in ("full", "swa") or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: {'moe' if cfg.moe is not None else kind} layers "
            f"are not ported yet (ROADMAP queue 1 item 18)")


# ---------------------------------------------------------------------------
# Per-period parameter init
# ---------------------------------------------------------------------------

def init_layer_params(cfg, kind: str, gen, dtype) -> Dict[str, Any]:
    check_dense(cfg, kind)
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=gen.device)

    p: Dict[str, Any] = {
        "pre_norm": zeros(),
        "attn": attn_mod.init_attn_params(cfg, gen, dtype),
        "pre_mlp_norm": zeros(),
        "mlp": mlp_mod.init_mlp_params(cfg, gen, dtype),
    }
    if cfg.post_norm:  # gemma2 sandwich norms
        p["post_attn_norm"] = zeros()
        p["post_mlp_norm"] = zeros()
    return p


def init_period_params(cfg, gen, dtype) -> Dict[str, Any]:
    return {f"l{i}": init_layer_params(cfg, kind, gen, dtype)
            for i, kind in enumerate(cfg.layer_pattern)}


def n_groups(cfg) -> int:
    period = len(cfg.layer_pattern)
    assert cfg.num_layers % period == 0, (cfg.name, cfg.num_layers, period)
    return cfg.num_layers // period


# ---------------------------------------------------------------------------
# Forward (prefill): full-sequence layer application
# ---------------------------------------------------------------------------

def _norm(cfg, x, scale):
    return rms_norm(x, scale, cfg.norm_eps, plus_one=True)


def _mlp_residual(cfg, p, x):
    out = mlp_mod.mlp(cfg, p["mlp"], _norm(cfg, x, p["pre_mlp_norm"]))
    if cfg.post_norm:
        out = _norm(cfg, out, p["post_mlp_norm"])
    return x + out


def _attn_residual(cfg, p, x, attn):
    out = attn_mod.out_proj(p["attn"], attn, cfg)
    if cfg.post_norm:
        out = _norm(cfg, out, p["post_attn_norm"])
    return x + out


def _attn_layer(cfg, p, x, positions, kind, *, want_cache=False):
    h = _norm(cfg, x, p["pre_norm"])
    q, k, v = attn_mod.project_qkv(cfg, p["attn"], h, positions)
    out = attn_mod.attention(q, k, v, kind=("swa" if kind == "swa"
                                            else "full"), cfg=cfg)
    x = _mlp_residual(cfg, p, _attn_residual(cfg, p, x, out))
    return x, ((k, v) if want_cache else None)


def period_forward(cfg, pparams, x, positions, *, want_cache: bool = False):
    """Apply one pattern period. Returns (x, caches): caches maps
    f"l{i}" to that layer's (k, v) when ``want_cache``."""
    caches = {}
    for i, kind in enumerate(cfg.layer_pattern):
        check_dense(cfg, kind)
        x, cache = _attn_layer(cfg, pparams[f"l{i}"], x, positions, kind,
                               want_cache=want_cache)
        if want_cache:
            caches[f"l{i}"] = cache
    return x, caches


def stack_forward(cfg, blocks: List[Dict[str, Any]], x, positions):
    """All periods over depth (no remat: the port has no training path
    yet). Returns x."""
    for gparams in blocks:
        x, _ = period_forward(cfg, gparams, x, positions)
    return x


def stack_prefill(cfg, blocks, x, positions):
    """Full-sequence pass that also emits every layer's (k, v): returns
    (x, list over depth of {f"l{i}": (k, v)})."""
    caches = []
    for gparams in blocks:
        x, c = period_forward(cfg, gparams, x, positions, want_cache=True)
        caches.append(c)
    return x, caches


# ---------------------------------------------------------------------------
# Decode: one token through the stack with per-layer caches
# ---------------------------------------------------------------------------

def period_decode(cfg, pparams, x, caches: Dict[str, KVCache], cur_pos):
    """One-token step through a period; ``caches`` maps f"l{i}" to that
    layer's cache, which is updated in place."""
    for i, kind in enumerate(cfg.layer_pattern):
        check_dense(cfg, kind)
        p = pparams[f"l{i}"]
        h = _norm(cfg, x, p["pre_norm"])
        q, k, v = attn_mod.project_qkv(cfg, p["attn"], h,
                                       positions_of(cur_pos, x))
        cache = update_cache(caches[f"l{i}"], k, v, cur_pos)
        k_r, v_r = read_kv(cache)
        out = attn_mod.decode_attention(
            q, k_r, v_r, cache_positions(cache), cur_pos, cfg=cfg,
            window=cfg.window if kind == "swa" else None)
        x = _mlp_residual(cfg, p, _attn_residual(cfg, p, x, out))
    return x


def positions_of(cur_pos, x):
    """Rope/mask positions for a one-token step; cur_pos int or (B,)."""
    B, S = x.shape[:2]
    if not torch.is_tensor(cur_pos) or cur_pos.dim() == 0:
        return torch.full((B, S), int(cur_pos), dtype=torch.int32,
                          device=x.device)
    return cur_pos[:, None].expand(B, S).to(torch.int32)


def stack_decode(cfg, blocks, x, caches: Dict[str, KVCache], cur_pos):
    """One token through all periods; ``caches`` maps f"l{i}" to a cache
    stacked over depth, updated in place. Returns x."""
    for g, gparams in enumerate(blocks):
        views = {key: KVCache(c.k[g], c.v[g], c.positions[g], c.window)
                 for key, c in caches.items()}
        x = period_decode(cfg, gparams, x, views, cur_pos)
    return x
