"""Decoder-only LM, plus the VLM variant: init / train / prefill /
decode (counterpart of ``repro/models/lm.py``), for the dense, MoE, SSM,
hybrid and VLM archs (whisper's enc-dec is ``models/encdec.py``).

* ``init_params(cfg, gen, dtype)``                  — on ``gen``'s device
* ``loss_fn(cfg, params, batch, policy)``           — train objective
* ``prefill(cfg, params, batch, cache_len=...)``    — logits + caches
* ``decode_step(cfg, params, tokens, state)``       — one-token serve

``policy`` is a ``sharding.policy.Policy`` or None everywhere, as in the
reference; training passes one, so its attention takes the plain paths
(the flash kernel has no backward).

Across ranks (a policy off a one-rank mesh) every argument and result
is this rank's block: ``params`` as ``init_params(..., policy=)`` or
``Policy.shard_tree`` cut them, the batch's rows as ``act_tokens``
cuts them, logits as ``act_logits`` lays them out (``Policy.gather``
makes them whole), caches as ``act_kv_cache``. The dense and MoE
decoders run so; the SSM, hybrid and VLM models raise
``NotImplementedError`` (ROADMAP queue 1 item 18 part 7).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import blocks as blk
from repro_torch.models.common import (chunked_softmax_xent, embed_init,
                                       embed_lookup, matmul, rms_norm,
                                       softcap, vocab_sharded)
from repro_torch.models.ssm import SSMState, init_ssm_state
from repro_torch.serve.kvcache import (cut_seq, from_prefill, init_cache,
                                       init_quant_cache, split_rows)
from repro_torch.sharding.policy import require_dense, sharded

VIT_STUB_DIM = 4096  # InternVL2: pixel-shuffled InternViT feature width


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg, gen: torch.Generator,
                dtype=torch.bfloat16, policy=None) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, made on its device. With a
    ``policy`` across ranks each leaf is drawn whole (every rank draws
    the one-rank init's values) and cut to this rank's block at once, so
    one leaf at a time is ever whole."""
    def cut(tree, *path):
        return policy.shard_tree(tree, path) if sharded(policy) else tree

    params: Dict[str, Any] = {
        "embedding": cut({"embedding": embed_init(
            gen, (cfg.vocab_size, cfg.d_model), dtype)})["embedding"],
        "blocks": [cut(blk.init_period_params(cfg, gen, dtype), "blocks", 0)
                   for _ in range(blk.n_groups(cfg))],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = cut({"head": embed_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype)})["head"]
    shared = blk.init_shared_params(cfg, gen, dtype)
    if shared is not None:
        params["shared"] = cut(shared, "shared")
    if cfg.frontend == "vit_stub":
        params["patch_proj"] = cut({"patch_proj": embed_init(
            gen, (VIT_STUB_DIM, cfg.d_model), dtype)})["patch_proj"]
    return params


def _head_block(cfg, params, policy):
    """The (D, V) head as this rank holds it and its spec (tied: the
    embedding's block, transposed, and its spec reversed)."""
    if cfg.tie_embeddings:
        spec = policy.param_spec(("embedding",),
                                 (cfg.vocab_size, cfg.d_model))
        return params["embedding"].T, spec[::-1]
    return params["head"], policy.param_spec(
        ("head",), (cfg.d_model, cfg.vocab_size))


def head_weights(cfg, params, policy=None):
    """The (D, V) head; across ranks this rank's (D, V/tp) block, the
    FSDP axis gathered (tied: the embedding's rows, transposed)."""
    if sharded(policy):
        return policy.use(*_head_block(cfg, params, policy))
    return params["embedding"].T if cfg.tie_embeddings else params["head"]


def embed_inputs(cfg, params, batch, policy=None):
    """tokens (B,S) [+ patch_embeds (B,P,VIT)] -> hidden (B,S,D).

    For the VLM, the first P positions of the sequence are image
    positions: projected patch embeddings replace the token embeddings
    there (the vision frontend is a stub, as in the reference)."""
    require_dense(cfg, policy)
    x = embed_lookup(params["embedding"], batch["tokens"], policy,
                     policy.param_spec(("embedding",),
                                       (cfg.vocab_size, cfg.d_model))
                     if sharded(policy) else None)
    if cfg.frontend == "vit_stub" and "patch_embeds" in batch:
        patches = matmul(batch["patch_embeds"],
                         params["patch_proj"]).to(x.dtype)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if policy is not None:
        x = policy.constrain(x, policy.act_hidden())
    return x


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def loss_fn(cfg, params, batch, policy=None, *, remat: bool = True,
            remat_policy=None, loss_chunk: int = 512,
            aux_weight: float = 0.01):
    """Causal-LM loss. batch: tokens (B,S), labels (B,S) (-1 = pad).
    Returns (loss, metrics); with ``cfg.moe`` the loss adds
    ``aux_weight`` times the load-balancing loss. Across ranks the
    loss is the mean over the global batch, the same on every rank."""
    x = embed_inputs(cfg, params, batch, policy)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, aux = blk.stack_forward(cfg, params["blocks"], x, positions, policy,
                               params.get("shared"), remat=remat,
                               remat_policy=remat_policy)
    x = rms_norm(x, _final_norm(cfg, params, policy), cfg.norm_eps,
                 plus_one=True)
    constrain = ((lambda t: policy.constrain(
        t, policy.act_logits(cfg.vocab_size))) if policy is not None
        else None)
    loss_sum, count = chunked_softmax_xent(
        x, head_weights(cfg, params, policy), batch["labels"],
        chunk=loss_chunk, constrain=constrain, final_cap=cfg.final_softcap,
        policy=policy, vocab=cfg.vocab_size)
    if sharded(policy):
        loss_sum = policy.reduce_batch(loss_sum)
        count = policy.reduce_batch(count)
    loss = loss_sum / torch.clamp(count, min=1.0)
    metrics = {"loss": loss, "tokens": count, "aux_loss": aux}
    if cfg.moe is not None:
        loss = loss + aux_weight * aux
    return loss, metrics


# ---------------------------------------------------------------------------
# Serve: prefill + decode
# ---------------------------------------------------------------------------

def _final_norm(cfg, params, policy=None):
    w = params["final_norm"]
    if sharded(policy):
        w = policy.use(w, policy.param_spec(("final_norm",), w.shape))
    return w


def _logits_last(cfg, params, x, policy=None):
    """Final-position logits only (B,1,V), in float32 (across ranks this
    rank's block under ``act_logits``)."""
    h = rms_norm(x[:, -1:], _final_norm(cfg, params, policy), cfg.norm_eps,
                 plus_one=True)
    if vocab_sharded(policy, cfg.vocab_size):
        h = policy.enter_tp(h)
    if sharded(policy):      # few rows: the activations move, not the head
        w, spec = _head_block(cfg, params, policy)
        logits = policy.project(h.float(), w.float(), spec)
    else:
        logits = torch.matmul(h.float(),
                              head_weights(cfg, params, policy).float())
    logits = softcap(logits, cfg.final_softcap)
    if policy is not None:
        logits = policy.constrain(logits, policy.act_logits(cfg.vocab_size))
    return logits


def prefill(cfg, params, batch, policy=None, *, cache_len: int = 0):
    """Run the full prompt; return (last-position logits, decode state).

    decode state = {"caches": f"l{i}" -> KVCache stacked over depth,
    "ssm": f"l{i}" -> SSMState stacked over depth, "pos": S}; caches
    are rolled/padded to ``cache_len`` slots. As in the reference, the
    final norm is applied to the whole sequence and once more to the
    last position in ``_logits_last``."""
    x = embed_inputs(cfg, params, batch, policy)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x, raw, raw_states = blk.stack_prefill(cfg, params["blocks"], x,
                                           positions, policy,
                                           params.get("shared"))
    x = rms_norm(x, _final_norm(cfg, params, policy), cfg.norm_eps,
                 plus_one=True)
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
        block = blk.seq_block(cfg, policy)
        if block is not None:          # the cache's slots over the ranks
            caches[key] = cut_seq(caches[key], *block)
    logits = _logits_last(cfg, params, x, policy)
    return logits, {"caches": caches, "ssm": states, "pos": S}


def init_decode_state(cfg, batch: int, cache_len: int,
                      dtype=torch.bfloat16, policy=None, *,
                      cache_impl: str = "dense", device="cuda"):
    """Fresh (empty) decode state, on ``device``.

    ``cache_impl``: "dense" (``dtype`` K/V) or "int8" (quantized
    storage, half the bytes of bf16 and a quarter of float32). Across
    ranks (``policy`` off a one-rank mesh) ``batch`` is the global batch
    and the state this rank's block of it in the policy's cache layout;
    otherwise ``policy`` is not read, as in the reference."""
    if cache_impl not in ("dense", "int8"):
        raise ValueError(f"cache_impl {cache_impl!r}: dense or int8")
    require_dense(cfg, policy)
    G = blk.n_groups(cfg)
    n_kv, block = cfg.num_kv_heads, blk.seq_block(cfg, policy)
    if sharded(policy):
        batch = policy.local_batch(batch)
        if block is None and policy.tp_axis:
            n_kv //= policy.tp_size()

    def mk_cache(window=0):
        if cache_impl == "int8":
            c = init_quant_cache(G * batch, cache_len, n_kv,
                                 cfg.head_dim, window=window, device=device)
        else:
            c = init_cache(G * batch, cache_len, n_kv,
                           cfg.head_dim, dtype, window=window, device=device)
        if block is not None:
            c = cut_seq(c, *block)
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
    x = embed_inputs(cfg, params, {"tokens": tokens}, policy)
    cur_pos = state["pos"]
    x = blk.stack_decode(cfg, params["blocks"], x, state["caches"],
                         state["ssm"], cur_pos, policy, params.get("shared"))
    logits = _logits_last(cfg, params, x, policy)
    return logits, {"caches": state["caches"], "ssm": state["ssm"],
                    "pos": cur_pos + 1}
