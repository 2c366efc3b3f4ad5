"""Decoder-only LM: init / prefill / decode (counterpart of
``repro/models/lm.py``), for the dense archs.

* ``init_params(cfg, gen, dtype)``                  — on ``gen``'s device
* ``prefill(cfg, params, batch, cache_len=...)``    — logits + caches
* ``decode_step(cfg, params, tokens, state)``       — one-token serve

``loss_fn`` waits for the training path and the ``vit_stub`` frontend
for the VLM (ROADMAP queue 1 item 18).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import blocks as blk
from repro_torch.models.attention import no_policy
from repro_torch.models.common import embed_init, rms_norm, softcap
from repro_torch.serve.kvcache import KVCache, from_prefill, init_cache


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg, gen: torch.Generator,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, made on its device."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(ROADMAP queue 1 item 18)")
    params: Dict[str, Any] = {
        "embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "blocks": [blk.init_period_params(cfg, gen, dtype)
                   for _ in range(blk.n_groups(cfg))],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                    dtype)
    return params


def head_weights(cfg, params):
    if cfg.tie_embeddings:
        return params["embedding"].T
    return params["head"]


def embed_inputs(cfg, params, batch):
    """tokens (B,S) -> hidden (B,S,D)."""
    emb = params["embedding"]
    x = emb[batch["tokens"].long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


# ---------------------------------------------------------------------------
# Serve: prefill + decode
# ---------------------------------------------------------------------------

def _logits_last(cfg, params, x):
    """Final-position logits only (B,1,V), in float32."""
    h = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps,
                 plus_one=True)
    logits = torch.matmul(h.float(), head_weights(cfg, params).float())
    return softcap(logits, cfg.final_softcap)


def prefill(cfg, params, batch, policy=None, *, cache_len: int = 0):
    """Run the full prompt; return (last-position logits, decode state).

    decode state = {"caches": f"l{i}" -> KVCache stacked over depth,
    "pos": S}; caches are rolled/padded to ``cache_len`` slots. As in
    the reference, the final norm is applied to the whole sequence and
    once more to the last position in ``_logits_last``."""
    no_policy(policy)
    x = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, raw = blk.stack_prefill(cfg, params["blocks"], x, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=True)
    caches = {}
    for i, kind in enumerate(cfg.layer_pattern):
        key = f"l{i}"
        k = torch.stack([c[key][0] for c in raw])
        v = torch.stack([c[key][1] for c in raw])
        for c in raw:
            del c[key]           # free the per-layer K/V as they stack
        window = cfg.window if kind == "swa" and cfg.window else 0
        caches[key] = from_prefill(k, v, window=window, pad_to=cache_len)
    logits = _logits_last(cfg, params, x)
    return logits, {"caches": caches, "pos": S}


def init_decode_state(cfg, batch: int, cache_len: int,
                      dtype=torch.bfloat16, policy=None, *,
                      cache_impl: str = "dense", device="cuda"):
    """Fresh (empty) decode state with dense caches, on ``device``."""
    no_policy(policy)
    if cache_impl != "dense":
        raise NotImplementedError(
            f"cache_impl={cache_impl!r}: only dense caches are ported "
            f"(the int8 cache is ROADMAP queue 1 item 18)")
    G = blk.n_groups(cfg)
    caches = {}
    for i, kind in enumerate(cfg.layer_pattern):
        blk.check_dense(cfg, kind)
        c = init_cache(G * batch, cache_len, cfg.num_kv_heads, cfg.head_dim,
                       dtype, device=device,
                       window=(cfg.window or cache_len) if kind == "swa"
                       else 0)
        caches[f"l{i}"] = KVCache(c.k.unflatten(0, (G, batch)),
                                  c.v.unflatten(0, (G, batch)),
                                  c.positions.unflatten(0, (G, batch)),
                                  c.window)
    return {"caches": caches, "pos": 0}


def decode_step(cfg, params, tokens, state, policy=None):
    """tokens (B,1) integer; state from prefill/init_decode_state, whose
    caches are updated in place. Returns (logits (B,1,V), new state)."""
    no_policy(policy)
    x = embed_inputs(cfg, params, {"tokens": tokens})
    cur_pos = state["pos"]
    x = blk.stack_decode(cfg, params["blocks"], x, state["caches"], cur_pos)
    logits = _logits_last(cfg, params, x)
    return logits, {"caches": state["caches"], "pos": cur_pos + 1}
