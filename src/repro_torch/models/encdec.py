"""Whisper-style encoder-decoder (counterpart of
``repro/models/encdec.py``), for serving.

The audio conv frontend is a stub, as in the reference: the caller
supplies precomputed frame embeddings (B, T, d_model), the output of the
two conv1d layers, and the encoder adds fixed sinusoidal positions. The
decoder uses learned positions, causal self-attention (KV-cached for
decode) and cross-attention to the encoder output, whose K/V are
computed once at prefill. LayerNorm (scale + bias) and a plain
(non-gated) GELU MLP; no rotary embeddings.

The reference stacks the layers over depth (``enc_layers`` /
``dec_layers`` with a leading layer axis, run by ``lax.scan``); here
they are lists of per-layer dicts and depth is a Python loop. Decode
state keeps the stacked layout: the self-attention cache and the cross
K/V have a leading layer axis. On a CUDA tensor the encoder's attention
(``"bidir"``), the decoder's self-attention (``"full"``) and the
prefill's cross-attention (``"bidir"``, 1500 keys against the prompt's
queries) run the flash kernel; decode's cross-attention stays
``attention_direct``, as in the reference. ``loss_fn`` waits for the
training path (ROADMAP queue 1 item 18 part 6).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (dense_init, embed_init, layer_norm,
                                       sinusoid_positions)
from repro_torch.serve.kvcache import (cache_views, from_prefill,
                                       init_cache, split_rows, update_cache)


def _ln_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def _mlp_init(cfg, gen, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": dense_init(gen, (d, f), dtype),
            "w_down": dense_init(gen, (f, d), dtype)}


def _mlp(p, x):
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def _enc_layer_init(cfg, gen, dtype):
    return {"ln1": _ln_init(cfg.d_model, dtype, gen.device),
            "attn": attn_mod.init_attn_params(cfg, gen, dtype),
            "ln2": _ln_init(cfg.d_model, dtype, gen.device),
            "mlp": _mlp_init(cfg, gen, dtype)}


def _dec_layer_init(cfg, gen, dtype):
    return {"ln1": _ln_init(cfg.d_model, dtype, gen.device),
            "self_attn": attn_mod.init_attn_params(cfg, gen, dtype),
            "ln2": _ln_init(cfg.d_model, dtype, gen.device),
            "cross_attn": attn_mod.init_attn_params(cfg, gen, dtype),
            "ln3": _ln_init(cfg.d_model, dtype, gen.device),
            "mlp": _mlp_init(cfg, gen, dtype)}


def init_params(cfg, gen: torch.Generator, dtype=torch.bfloat16, *,
                max_target: int = 448) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, made on its device."""
    return {
        "embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "pos_embedding": embed_init(gen, (max_target, cfg.d_model), dtype),
        "enc_layers": [_enc_layer_init(cfg, gen, dtype)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer_init(cfg, gen, dtype)
                       for _ in range(cfg.decoder_layers)],
        "enc_final": _ln_init(cfg.d_model, dtype, gen.device),
        "dec_final": _ln_init(cfg.d_model, dtype, gen.device),
    }


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(cfg, params, frames, policy=None):
    """frames (B, T, D) stub embeddings -> encoder states (B, T, D)."""
    attn_mod.no_policy(policy)
    B, T, D = frames.shape
    h = frames + sinusoid_positions(T, D, frames.dtype, frames.device)[None]
    positions = _positions(B, T, frames.device)
    for p in params["enc_layers"]:
        a = _ln(h, p["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, p["attn"], a, positions,
                                       rope=False)
        a = attn_mod.attention(q, k, v, kind="bidir", cfg=cfg)
        h = h + attn_mod.out_proj(p["attn"], a, cfg)
        h = h + _mlp(p["mlp"], _ln(h, p["ln2"], cfg.norm_eps))
    return _ln(h, params["enc_final"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_q(cfg, p, c):
    qc = attn_mod._proj(c, p["cross_attn"]["wq"])
    if cfg.qkv_bias:
        qc = qc + p["cross_attn"]["bq"]
    return qc


def _decoder_stack(cfg, params, x, enc_out, positions, *,
                   want_cache=False):
    """The decoder over the whole prompt. Returns (x, caches): with
    ``want_cache`` a list over layers of ((k, v), (kc, vc)), the
    self-attention's and the cross-attention's K/V."""
    caches = []
    for p in params["dec_layers"]:
        a = _ln(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, p["self_attn"], a, positions,
                                       rope=False)
        a = attn_mod.attention(q, k, v, kind="full", cfg=cfg)
        x = x + attn_mod.out_proj(p["self_attn"], a, cfg)
        qc = _cross_q(cfg, p, _ln(x, p["ln2"], cfg.norm_eps))
        kc = attn_mod._proj(enc_out, p["cross_attn"]["wk"])
        vc = attn_mod._proj(enc_out, p["cross_attn"]["wv"])
        if cfg.qkv_bias:
            kc, vc = kc + p["cross_attn"]["bk"], vc + p["cross_attn"]["bv"]
        cx = attn_mod.attention(qc, kc, vc, kind="bidir", cfg=cfg)
        x = x + attn_mod.out_proj(p["cross_attn"], cx, cfg)
        x = x + _mlp(p["mlp"], _ln(x, p["ln3"], cfg.norm_eps))
        if want_cache:
            caches.append(((k, v), (kc, vc)))
    return x, (caches if want_cache else None)


def prefill(cfg, params, batch, policy=None, *, cache_len: int = 0):
    """Encode, run the decoder prompt; return (last-position logits,
    decode state with the self- and cross-attention caches)."""
    enc_out = encode(cfg, params, batch["frames"], policy)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = (params["embedding"][tokens.long()]
         + params["pos_embedding"][None, :S])
    x, caches = _decoder_stack(cfg, params, x, enc_out, positions,
                               want_cache=True)
    x = _ln(x, params["dec_final"], cfg.norm_eps)

    def stacked(i, j):   # ((k, v), (kc, vc))[i][j] over the layers
        return torch.stack([c[i][j] for c in caches])

    self_cache = from_prefill(stacked(0, 0), stacked(0, 1),
                              pad_to=cache_len)
    cross = (stacked(1, 0), stacked(1, 1))
    del caches
    return _last_logits(cfg, params, x), {"self": self_cache,
                                          "cross": cross, "pos": S}


def _last_logits(cfg, params, x):
    """Final-position logits (B,1,V), in float32 (tied embeddings)."""
    return torch.matmul(x[:, -1:].float(), params["embedding"].T.float())


def init_decode_state(cfg, batch: int, cache_len: int, enc_len: int,
                      dtype=torch.bfloat16, *, device="cuda"):
    """Empty decode state, on ``device``."""
    L = cfg.decoder_layers
    self_cache = split_rows(init_cache(L * batch, cache_len,
                                       cfg.num_kv_heads, cfg.head_dim,
                                       dtype, device=device), L, batch)
    shape = (L, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    cross = (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
    return {"self": self_cache, "cross": cross, "pos": 0}


def decode_step(cfg, params, tokens, state, policy=None):
    """One decoder token against the cached self and cross attention;
    the self-attention cache is written in place. Returns (logits
    (B,1,V), new state)."""
    attn_mod.no_policy(policy)
    cur_pos = state["pos"]
    B = tokens.shape[0]
    n_pos = params["pos_embedding"].shape[0]
    if torch.is_tensor(cur_pos) and cur_pos.dim() == 1:
        pe = params["pos_embedding"][cur_pos.long() % n_pos][:, None]
    else:
        pe = params["pos_embedding"][int(cur_pos) % n_pos][None, None]
    h = params["embedding"][tokens.long()] + pe
    positions = torch.full((B, 1), int(cur_pos), dtype=torch.int32,
                           device=h.device) \
        if not torch.is_tensor(cur_pos) or cur_pos.dim() == 0 \
        else cur_pos[:, None].to(torch.int32)
    kcs, vcs = state["cross"]
    for i, p in enumerate(params["dec_layers"]):
        a = _ln(h, p["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, p["self_attn"], a, positions,
                                       rope=False)
        cache = update_cache(cache_views(state["self"], i), k, v, cur_pos)
        a = attn_mod.decode_attention(q, cache.k, cache.v, cache.positions,
                                      cur_pos, cfg=cfg)
        h = h + attn_mod.out_proj(p["self_attn"], a, cfg)
        qc = _cross_q(cfg, p, _ln(h, p["ln2"], cfg.norm_eps))
        cx = attn_mod.attention_direct(qc, kcs[i], vcs[i], causal=False)
        h = h + attn_mod.out_proj(p["cross_attn"], cx, cfg)
        h = h + _mlp(p["mlp"], _ln(h, p["ln3"], cfg.norm_eps))
    h = _ln(h, params["dec_final"], cfg.norm_eps)
    return _last_logits(cfg, params, h), {**state, "pos": cur_pos + 1}
