"""Whisper-style encoder-decoder (counterpart of
``repro/models/encdec.py``): training loss, prefill and decode.

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
``attention_direct``, as in the reference. Under a sharding policy (the
training path) attention takes the plain paths, and each encoder and
decoder layer is recomputed in the backward pass (``remat``, the
reference's ``jax.checkpoint`` around its scan bodies).

Across ranks (a policy off a one-rank mesh) every argument and result is
this rank's block, as in ``models/lm.py``: frames and tokens its rows,
logits laid out by ``act_logits``. Each encoder and decoder layer takes
its parameters through ``Policy.use`` (the FSDP axes gathered, a layer at
a time, again under remat); heads are tensor-parallel (``project_qkv``
on the local heads, ``out_proj``'s and the MLP's down projection summed
over the model axis). The cross-attention K/V are computed once at
prefill on the local heads (``act_kv_cache``; where the KV heads do not
divide the model axis, repeated to the query heads and cut), and the
self-attention cache is laid out as ``lm``'s is. ``pos_embedding`` and
the norms are replicated. The tied embedding is looked up and projected
by moving rows (``Policy.lookup``, ``Policy.project``), whether the
model axis splits its vocab or, as at whisper's 51865, replicates it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models.common import (ShapeOnly, chunked_softmax_xent,
                                       dense_init, embed_init, embed_lookup,
                                       layer_norm, matmul, remat,
                                       sinusoid_positions, vocab_sharded)
from repro_torch.serve.kvcache import (cache_views, cut_seq, from_prefill,
                                       init_cache, split_rows,
                                       update_any_cache)
from repro_torch.sharding.policy import STACKED, P, sharded


def _ln_init(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def _mlp_init(cfg, gen, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": dense_init(gen, (d, f), dtype),
            "w_down": dense_init(gen, (f, d), dtype)}


def _mlp(p, x, policy=None):
    """GELU MLP; across ranks ``w_up`` is this rank's block of the hidden
    dim and ``w_down``'s product a partial sum over it."""
    multi = sharded(policy)
    if multi:
        x = policy.enter_tp(x)
    out = matmul(F.gelu(matmul(x, p["w_up"]), approximate="tanh"),
                 p["w_down"])
    if multi:
        out = policy.constrain(out, policy.act_hidden(),
                               partial=policy.tp_axis)
    return out


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
                max_target: int = 448, policy=None) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, made on its device. With a
    ``policy`` across ranks each leaf is drawn whole (the one-rank
    init's values) and cut to this rank's block at once."""
    def cut(tree, *path):
        return policy.shard_tree(tree, path) if sharded(policy) else tree

    def leaf(name, value):
        return cut({name: value})[name]
    return {
        "embedding": leaf("embedding", embed_init(
            gen, (cfg.vocab_size, cfg.d_model), dtype)),
        "pos_embedding": leaf("pos_embedding", embed_init(
            gen, (max_target, cfg.d_model), dtype)),
        "enc_layers": [cut(_enc_layer_init(cfg, gen, dtype),
                           "enc_layers", 0)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [cut(_dec_layer_init(cfg, gen, dtype),
                           "dec_layers", 0)
                       for _ in range(cfg.decoder_layers)],
        "enc_final": cut(_ln_init(cfg.d_model, dtype, gen.device),
                         "enc_final"),
        "dec_final": cut(_ln_init(cfg.d_model, dtype, gen.device),
                         "dec_final"),
    }


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


@functools.lru_cache(maxsize=64)
def _specs(policy, cfg):
    """The parameters' specs under ``policy``, from their shapes; a
    stack's entry is one layer's (the per-layer slice of the stacked
    rule)."""
    one = dataclasses.replace(cfg, encoder_layers=1, decoder_layers=1)
    specs = policy.tree_specs(init_params(one, ShapeOnly(), torch.float32))
    return {k: v[0] if k in STACKED else v for k, v in specs.items()}


def _use(policy, cfg, tree, key):
    """The parameters under ``key`` (a stack's: one layer) where they are
    used: across ranks, this rank's blocks with the FSDP axes gathered
    (``Policy.use``; replicated leaves: their gradient all-reduced over
    the batch axes)."""
    if not sharded(policy):
        return tree
    spec = _specs(policy, cfg)[key]
    if torch.is_tensor(tree):
        return policy.use(tree, spec)
    return policy.use_tree(tree, spec)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(cfg, params, frames, policy=None):
    """frames (B, T, D) stub embeddings -> encoder states (B, T, D)."""
    B, T, D = frames.shape
    h = frames + sinusoid_positions(T, D, frames.dtype, frames.device)[None]
    if policy is not None:
        h = policy.constrain(h, policy.act_hidden())
    positions = _positions(B, T, frames.device)

    def layer(h, p):
        p = _use(policy, cfg, p, "enc_layers")
        a = _ln(h, p["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, p["attn"], a, positions,
                                       rope=False, policy=policy)
        a = attn_mod.attention(q, k, v, kind="bidir", cfg=cfg, policy=policy)
        h = h + attn_mod.out_proj(p["attn"], a, cfg, policy)
        h = h + _mlp(p["mlp"], _ln(h, p["ln2"], cfg.norm_eps), policy)
        if policy is not None:
            h = policy.constrain(h, policy.act_hidden())
        return h

    for p in params["enc_layers"]:
        h = remat(layer, h, p)
    return _ln(h, _use(policy, cfg, params["enc_final"], "enc_final"),
               cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_q(cfg, p, c, policy=None):
    if sharded(policy):
        c = policy.enter_tp(c)
    qc = attn_mod._proj(c, p["cross_attn"]["wq"])
    if cfg.qkv_bias:
        qc = qc + p["cross_attn"]["bq"]
    return qc


def _cross_kv(cfg, p, enc_out, policy=None):
    """The cross-attention K/V of ``enc_out`` (across ranks: entered
    through ``enter_tp`` once by the caller)."""
    kc = attn_mod._proj(enc_out, p["cross_attn"]["wk"])
    vc = attn_mod._proj(enc_out, p["cross_attn"]["wv"])
    if cfg.qkv_bias:
        kc, vc = kc + p["cross_attn"]["bk"], vc + p["cross_attn"]["bv"]
    return kc, vc


def _cross_cache(cfg, kc, vc, policy):
    """Cross K/V as the decode steps read them: on this rank's query
    heads' KV heads (where KV heads do not divide the model axis, every
    KV head repeated to the query heads and cut to the local ones)."""
    if not sharded(policy) or attn_mod._local_heads(cfg, policy):
        return kc, vc
    kc, vc = attn_mod.maybe_repeat_kv(cfg, policy, kc, vc)
    whole = P(policy.batch(), None, None, None)
    return tuple(policy.constrain(t, policy.act_heads(), src=whole)
                 for t in (kc, vc))


def _decoder_stack(cfg, params, x, enc_out, positions, policy=None, *,
                   want_cache=False):
    """The decoder over the whole prompt. Returns (x, caches): with
    ``want_cache`` a list over layers of ((k, v), (kc, vc)), the
    self-attention's and the cross-attention's K/V; without, each layer
    is recomputed in the backward pass."""
    enc_in = (policy.enter_tp(enc_out) if sharded(policy)
              and attn_mod._local_heads(cfg, policy) else enc_out)

    def layer(x, p):
        p = _use(policy, cfg, p, "dec_layers")
        a = _ln(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, p["self_attn"], a, positions,
                                       rope=False, policy=policy)
        a = attn_mod.attention(q, k, v, kind="full", cfg=cfg, policy=policy)
        x = x + attn_mod.out_proj(p["self_attn"], a, cfg, policy)
        qc = _cross_q(cfg, p, _ln(x, p["ln2"], cfg.norm_eps), policy)
        kc, vc = _cross_kv(cfg, p, enc_in, policy)
        cx = attn_mod.attention(qc, kc, vc, kind="bidir", cfg=cfg,
                                policy=policy)
        x = x + attn_mod.out_proj(p["cross_attn"], cx, cfg, policy)
        x = x + _mlp(p["mlp"], _ln(x, p["ln3"], cfg.norm_eps), policy)
        if policy is not None:
            x = policy.constrain(x, policy.act_hidden())
        return x, ((k, v), (kc, vc))

    if not want_cache:
        for p in params["dec_layers"]:
            x = remat(lambda x, p: layer(x, p)[0], x, p)
        return x, None
    caches = []
    for p in params["dec_layers"]:
        x, (kv, (kc, vc)) = layer(x, p)
        caches.append((kv, _cross_cache(cfg, kc, vc, policy)))
    return x, caches


def _embed(cfg, params, tokens, policy=None):
    """Token embeddings plus learned positions; across ranks the lookup
    moves rows (``Policy.lookup``)."""
    S = tokens.shape[1]
    emb = params["embedding"]
    spec = (policy.param_spec(("embedding",), emb.shape)
            if sharded(policy) else None)
    pos = _use(policy, cfg, params["pos_embedding"], "pos_embedding")
    return embed_lookup(emb, tokens, policy, spec) + pos[None, :S]


def _head_block(cfg, params, policy):
    """The tied (D, V) head as this rank holds it, and its spec."""
    spec = policy.param_spec(("embedding",), (cfg.vocab_size, cfg.d_model))
    return params["embedding"].T, spec[::-1]


def loss_fn(cfg, params, batch, policy=None, **_):
    """batch: frames (B,T,D), tokens (B,S), labels (B,S) (-1 = pad).
    Returns (loss, metrics). The reference's keywords (``remat``,
    ``loss_chunk``, ...) are accepted and, as there, not read: the
    layers always recompute and the loss runs in chunks of 512. Across
    ranks the loss is the mean over the global batch, the same on every
    rank."""
    enc_out = encode(cfg, params, batch["frames"], policy)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, _ = _decoder_stack(cfg, params, _embed(cfg, params, tokens, policy),
                          enc_out, _positions(B, S, tokens.device), policy)
    x = _ln(x, _use(policy, cfg, params["dec_final"], "dec_final"),
            cfg.norm_eps)
    constrain = ((lambda t: policy.constrain(
        t, policy.act_logits(cfg.vocab_size))) if policy is not None
        else None)
    head = (policy.use(*_head_block(cfg, params, policy))
            if sharded(policy) else params["embedding"].T)
    loss_sum, count = chunked_softmax_xent(
        x, head, batch["labels"], chunk=512, constrain=constrain,
        policy=policy, vocab=cfg.vocab_size)
    if sharded(policy):
        loss_sum = policy.reduce_batch(loss_sum)
        count = policy.reduce_batch(count)
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"loss": loss, "tokens": count}


def prefill(cfg, params, batch, policy=None, *, cache_len: int = 0):
    """Encode, run the decoder prompt; return (last-position logits,
    decode state with the self- and cross-attention caches)."""
    enc_out = encode(cfg, params, batch["frames"], policy)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, caches = _decoder_stack(cfg, params,
                               _embed(cfg, params, tokens, policy), enc_out,
                               _positions(B, S, tokens.device), policy,
                               want_cache=True)
    x = _ln(x, _use(policy, cfg, params["dec_final"], "dec_final"),
            cfg.norm_eps)

    if not caches:       # no decoder layer (a dry run's depth 0)
        return _last_logits(cfg, params, x, policy), {"pos": S}

    def stacked(i, j):   # ((k, v), (kc, vc))[i][j] over the layers
        return torch.stack([c[i][j] for c in caches])

    self_cache = from_prefill(stacked(0, 0), stacked(0, 1),
                              pad_to=cache_len)
    block = blk.seq_block(cfg, policy)
    if block is not None:          # the cache's slots over the ranks
        self_cache = cut_seq(self_cache, *block)
    cross = (stacked(1, 0), stacked(1, 1))
    del caches
    return _last_logits(cfg, params, x, policy), {"self": self_cache,
                                                  "cross": cross, "pos": S}


def _last_logits(cfg, params, x, policy=None):
    """Final-position logits (B,1,V), in float32 (tied embeddings); across
    ranks this rank's block under ``act_logits``, the activations moved
    instead of the table (``Policy.project``)."""
    h = x[:, -1:].float()
    if sharded(policy):
        if vocab_sharded(policy, cfg.vocab_size):
            h = policy.enter_tp(h)
        w, spec = _head_block(cfg, params, policy)
        logits = policy.project(h, w.float(), spec)
    else:
        logits = torch.matmul(h, params["embedding"].T.float())
    if policy is not None:
        logits = policy.constrain(logits, policy.act_logits(cfg.vocab_size))
    return logits


def init_decode_state(cfg, batch: int, cache_len: int, enc_len: int,
                      dtype=torch.bfloat16, policy=None, *, device="cuda"):
    """Empty decode state, on ``device``. Across ranks ``batch`` is the
    global batch and the state this rank's block of it, in the layout
    ``prefill`` leaves."""
    L = cfg.decoder_layers
    n_kv = n_cross = cfg.num_kv_heads
    block = blk.seq_block(cfg, policy)
    if sharded(policy):
        batch = policy.local_batch(batch)
        if policy.tp_axis:
            tp = policy.tp_size()
            n_kv = n_kv // tp if block is None else n_kv
            n_cross = (cfg.num_kv_heads if block is None
                       else cfg.heads_padded) // tp
    cache = init_cache(L * batch, cache_len, n_kv, cfg.head_dim, dtype,
                       device=device)
    if block is not None:
        cache = cut_seq(cache, *block)
    shape = (L, batch, enc_len, n_cross, cfg.head_dim)
    cross = (torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
    return {"self": split_rows(cache, L, batch), "cross": cross, "pos": 0}


def decode_step(cfg, params, tokens, state, policy=None):
    """One decoder token against the cached self and cross attention;
    the self-attention cache is written in place. Returns (logits
    (B,1,V), new state)."""
    cur_pos = state["pos"]
    B = tokens.shape[0]
    pos_emb = _use(policy, cfg, params["pos_embedding"], "pos_embedding")
    n_pos = pos_emb.shape[0]
    if torch.is_tensor(cur_pos) and cur_pos.dim() == 1:
        pe = pos_emb[cur_pos.long() % n_pos][:, None]
    else:
        pe = pos_emb[int(cur_pos) % n_pos][None, None]
    emb = params["embedding"]
    h = embed_lookup(emb, tokens, policy,
                     policy.param_spec(("embedding",), emb.shape)
                     if sharded(policy) else None) + pe
    positions = torch.full((B, 1), int(cur_pos), dtype=torch.int32,
                           device=h.device) \
        if not torch.is_tensor(cur_pos) or cur_pos.dim() == 0 \
        else cur_pos[:, None].to(torch.int32)
    block = blk.seq_block(cfg, policy)
    kcs, vcs = state["cross"]
    for i, p in enumerate(params["dec_layers"]):
        p = _use(policy, cfg, p, "dec_layers")
        a = _ln(h, p["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(cfg, p["self_attn"], a, positions,
                                       rope=False, policy=policy)
        cache = update_any_cache(cache_views(state["self"], i), k, v,
                                 cur_pos, seq_block=block)
        a = attn_mod.decode_attention(q, cache.k, cache.v, cache.positions,
                                      cur_pos, cfg=cfg, policy=policy)
        h = h + attn_mod.out_proj(p["self_attn"], a, cfg, policy)
        qc = _cross_q(cfg, p, _ln(h, p["ln2"], cfg.norm_eps), policy)
        cx = attn_mod.attention_direct(qc, kcs[i], vcs[i], causal=False)
        h = h + attn_mod.out_proj(p["cross_attn"], cx, cfg, policy)
        h = h + _mlp(p["mlp"], _ln(h, p["ln3"], cfg.norm_eps), policy)
    h = _ln(h, _use(policy, cfg, params["dec_final"], "dec_final"),
            cfg.norm_eps)
    return _last_logits(cfg, params, h, policy), {**state,
                                                  "pos": cur_pos + 1}
