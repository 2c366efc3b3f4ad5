"""Decoder-only LM, plus the VLM variant: init / prefill / decode
(counterpart of ``repro/models/lm.py``), for the dense, MoE, SSM, hybrid
and VLM archs (whisper's enc-dec is ``models/encdec.py``).

* ``init_params(cfg, gen, dtype)``                  — on ``gen``'s device
* ``prefill(cfg, params, batch, cache_len=...)``    — logits + caches
* ``decode_step(cfg, params, tokens, state)``       — one-token serve

``loss_fn`` waits for the training path (ROADMAP queue 1 item 18 part
6).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import blocks as blk
from repro_torch.models.attention import no_policy
from repro_torch.models.common import embed_init, rms_norm, softcap
from repro_torch.models.ssm import SSMState, init_ssm_state
from repro_torch.serve.kvcache import (from_prefill, init_cache,
                                       init_quant_cache, split_rows)

VIT_STUB_DIM = 4096  # InternVL2: pixel-shuffled InternViT feature width


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg, gen: torch.Generator,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, made on its device."""
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
    shared = blk.init_shared_params(cfg, gen, dtype)
    if shared is not None:
        params["shared"] = shared
    if cfg.frontend == "vit_stub":
        params["patch_proj"] = embed_init(gen, (VIT_STUB_DIM, cfg.d_model),
                                          dtype)
    return params


def head_weights(cfg, params):
    if cfg.tie_embeddings:
        return params["embedding"].T
    return params["head"]


def embed_inputs(cfg, params, batch):
    """tokens (B,S) [+ patch_embeds (B,P,VIT)] -> hidden (B,S,D).

    For the VLM, the first P positions of the sequence are image
    positions: projected patch embeddings replace the token embeddings
    there (the vision frontend is a stub, as in the reference)."""
    emb = params["embedding"]
    x = emb[batch["tokens"].long()]
    if cfg.frontend == "vit_stub" and "patch_embeds" in batch:
        patches = torch.matmul(batch["patch_embeds"],
                               params["patch_proj"]).to(x.dtype)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
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
    "ssm": f"l{i}" -> SSMState stacked over depth, "pos": S}; caches
    are rolled/padded to ``cache_len`` slots. As in the reference, the
    final norm is applied to the whole sequence and once more to the
    last position in ``_logits_last``."""
    no_policy(policy)
    x = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, raw, raw_states = blk.stack_prefill(cfg, params["blocks"], x,
                                           positions, params.get("shared"))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, plus_one=True)
    states = {key: SSMState(*(torch.stack([s[key][f] for s in raw_states])
                              for f in range(len(SSMState._fields))))
              for key in raw_states[0]}
    del raw_states
    caches = {}
    for i, kind in enumerate(cfg.layer_pattern):
        key = f"l{i}"
        if key not in raw[0]:
            continue
        k = torch.stack([c[key][0] for c in raw])
        v = torch.stack([c[key][1] for c in raw])
        for c in raw:
            del c[key]           # free the per-layer K/V as they stack
        window = cfg.window if kind == "swa" and cfg.window else 0
        caches[key] = from_prefill(k, v, window=window, pad_to=cache_len)
    logits = _logits_last(cfg, params, x)
    return logits, {"caches": caches, "ssm": states, "pos": S}


def init_decode_state(cfg, batch: int, cache_len: int,
                      dtype=torch.bfloat16, policy=None, *,
                      cache_impl: str = "dense", device="cuda"):
    """Fresh (empty) decode state, on ``device``.

    ``cache_impl``: "dense" (``dtype`` K/V) or "int8" (quantized
    storage, half the bytes of bf16 and a quarter of float32)."""
    no_policy(policy)
    if cache_impl not in ("dense", "int8"):
        raise ValueError(f"cache_impl {cache_impl!r}: dense or int8")
    G = blk.n_groups(cfg)

    def mk_cache(window=0):
        if cache_impl == "int8":
            c = init_quant_cache(G * batch, cache_len, cfg.num_kv_heads,
                                 cfg.head_dim, window=window, device=device)
        else:
            c = init_cache(G * batch, cache_len, cfg.num_kv_heads,
                           cfg.head_dim, dtype, window=window, device=device)
        return split_rows(c, G, batch)

    caches, states = {}, {}
    for i, kind in enumerate(cfg.layer_pattern):
        key = f"l{i}"
        if kind in ("ssm", "hybrid"):
            states[key] = SSMState(*(t.unflatten(0, (G, batch)) for t in
                                     init_ssm_state(cfg, G * batch, dtype,
                                                    device=device)))
        if kind == "ssm":
            continue
        caches[key] = mk_cache(window=(cfg.window or cache_len)
                               if kind == "swa" else 0)
    return {"caches": caches, "ssm": states, "pos": 0}


def decode_step(cfg, params, tokens, state, policy=None):
    """tokens (B,1) integer; state from prefill/init_decode_state, whose
    caches and SSM states are updated in place. Returns (logits (B,1,V), new state)."""
    no_policy(policy)
    x = embed_inputs(cfg, params, {"tokens": tokens})
    cur_pos = state["pos"]
    x = blk.stack_decode(cfg, params["blocks"], x, state["caches"],
                         state["ssm"], cur_pos, params.get("shared"))
    logits = _logits_last(cfg, params, x)
    return logits, {"caches": state["caches"], "ssm": state["ssm"],
                    "pos": cur_pos + 1}
