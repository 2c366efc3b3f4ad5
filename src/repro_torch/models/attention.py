"""Grouped-query attention with the variants of the dense archs
(counterpart of ``repro/models/attention.py``).

Paths, as in the reference:
  * flash     — with no sharding policy, full-sequence ``"full"``/
                ``"bidir"`` attention on a CUDA tensor runs the
                hand-written CUDA kernel (``kernels/flash_attention.py``),
                head_dim 80 and cross-attention's own key length
                included; the counterpart of the reference's
                ``_use_flash_kernel`` on a TPU. The kernel has no
                backward (nor has the reference's): training runs
                attention under a policy, which takes the paths below.
  * direct    — S·S einsum (short sequences, decode).
  * blockwise — flash-style loop over (q-block × kv-block) with running
                max/denominator in f32.
  * banded    — sliding-window attention over a static-length KV slice
                per q block (h2o-danube, gemma2 local layers).
  * decode    — one query position against a KV cache, masked by the
                absolute position stored in each slot.

Under a ``sharding.policy.Policy``, K/V are repeated up to the padded
query heads where the KV heads do not divide the TP axis
(``maybe_repeat_kv``), and q/k/v and the output are constrained to the
policy's head layout, as in the reference. Across ranks, each rank
computes its own query heads (``wq``'s block of the heads), K/V heads
where they divide the model axis and all of them otherwise (then
repeated and cut to the local heads), and ``out_proj``'s product over
the local heads is a partial sum, summed over the model axis at once.
A KV cache sharded on its sequence (KV heads not dividing the model
axis) is gathered for each decode step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (apply_rope, dense_init, matmul,
                                       rms_norm, softcap)
from repro_torch.sharding.policy import P, sharded


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attn_params(cfg, gen, dtype):
    d, kv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    h = cfg.heads_padded
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype, fan_in=d),
        "wk": dense_init(gen, (d, kv, hd), dtype, fan_in=d),
        "wv": dense_init(gen, (d, kv, hd), dtype, fan_in=d),
        "wo": dense_init(gen, (h, hd, d), dtype, fan_in=h * hd),
    }
    zeros = dict(dtype=dtype, device=gen.device)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), **zeros)
        p["bk"] = torch.zeros((kv, hd), **zeros)
        p["bv"] = torch.zeros((kv, hd), **zeros)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), **zeros)
        p["k_norm"] = torch.zeros((hd,), **zeros)
    return p


def head_mask(cfg, x, policy=None):
    """Zero the padded compute-only heads. x (..., Hp, hd), or this
    rank's block of the heads across ranks."""
    if cfg.heads_padded == cfg.num_heads:
        return x
    n = x.shape[-2]
    first = policy.tp_index() * n if sharded(policy) else 0
    mask = torch.arange(first, first + n, device=x.device) < cfg.num_heads
    return x * mask[:, None].to(x.dtype)


def maybe_repeat_kv(cfg, policy, k, v):
    """When KV heads don't divide the TP axis, repeat K/V up to the padded
    query-head count so every attention product shards cleanly on heads.
    Activation-only (params keep true GQA shapes)."""
    if policy is None or policy.tp_axis is None:
        return k, v
    tp = policy.mesh.shape[policy.tp_axis]
    kv = cfg.num_kv_heads
    if kv % tp == 0:
        return k, v
    reps = cfg.heads_padded // kv
    return (k.repeat_interleave(reps, dim=2),
            v.repeat_interleave(reps, dim=2))


def _proj(x, w):
    """x (..., d) · w (d, n, h) -> (..., n, h), one matmul."""
    return matmul(x, w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _local_heads(cfg, policy) -> bool:
    """Whether K/V heads are this rank's block (else all of them)."""
    if not sharded(policy):
        return True
    if cfg.heads_padded % policy.tp_size():
        raise ValueError(f"{cfg.name}: {cfg.heads_padded} query heads do "
                         f"not split over a model axis of "
                         f"{policy.tp_size()}")
    return policy.kv_heads_sharded(cfg.num_kv_heads)


def project_qkv(cfg, p, x, positions, *, rope: bool = True, policy=None):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd), rope+qk_norm applied.

    Across ranks (``p`` holding this rank's blocks) q has the local
    heads, k/v the local KV heads where they divide the model axis and
    all of them otherwise; ``x`` enters the column-parallel products
    through ``enter_tp``, and the norm scales used on local heads too."""
    def tp(t, local=True):
        return policy.enter_tp(t) if local and sharded(policy) else t

    kv_local = _local_heads(cfg, policy)
    q = _proj(tp(x), p["wq"])
    xkv = tp(x, kv_local)
    k = _proj(xkv, p["wk"])
    v = _proj(xkv, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, tp(p["q_norm"]), cfg.norm_eps, plus_one=True)
        k = rms_norm(k, tp(p["k_norm"], kv_local), cfg.norm_eps,
                     plus_one=True)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p, attn, cfg=None, policy=None):  # (B,S,Hp,hd) -> (B,S,D)
    """Across ranks the product over the local heads is a partial sum,
    summed over the model axis here (the reduction GSPMD places before
    the next use of the hidden state)."""
    if cfg is not None:
        attn = head_mask(cfg, attn, policy)
    wo = p["wo"]
    out = matmul(attn.flatten(-2), wo.reshape(-1, wo.shape[-1]))
    if sharded(policy):
        out = policy.constrain(out, policy.act_hidden(),
                               partial=policy.tp_axis)
    return out


# ---------------------------------------------------------------------------
# Core softmax-attention pieces (grouped heads, f32 accumulation)
# ---------------------------------------------------------------------------

def _group(q, n_kv):
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def _logits(qg, k, scale, cap):
    # qg (B,Q,KV,G,hd) × k (B,S,KV,hd) -> (B,KV,G,Q,S)
    l = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    return softcap(l, cap)


def _pv(probs, v):
    # (B,KV,G,Q,S) × (B,S,KV,hd) -> (B,Q,KV,G,hd)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())


def attention_direct(q, k, v, *, causal: bool, cap: Optional[float] = None,
                     q_offset: int = 0, window: Optional[int] = None,
                     kv_positions=None, q_positions=None):
    """Unblocked attention. q (B,Q,H,hd); k,v (B,S,KV,hd)."""
    B, Q, H, hd = q.shape
    S = k.shape[1]
    n_kv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    logits = _logits(_group(q, n_kv), k, scale, cap)          # (B,KV,G,Q,S)
    if q_positions is None:
        q_positions = q_offset + torch.arange(Q, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(S, device=q.device)
    qpos = (q_positions.reshape(-1, Q) if q_positions.dim() > 1
            else q_positions[None, :])
    kpos = (kv_positions.reshape(-1, S) if kv_positions.dim() > 1
            else kv_positions[None, :])
    mask = torch.ones((qpos.shape[0], Q, S), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (qpos[:, :, None] >= kpos[:, None, :])
    if window is not None:
        mask = mask & ((qpos[:, :, None] - kpos[:, None, :]) < window)
    mask = mask & (kpos[:, None, :] >= 0)                     # unwritten slots
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    return _pv(probs, v).reshape(B, Q, H, hd).to(q.dtype)


def attention_blockwise(q, k, v, *, causal: bool = True,
                        cap: Optional[float] = None,
                        q_block: int = 512, kv_block: int = 1024):
    """Flash-style attention; O(q_block·kv_block) live logits."""
    B, S, H, hd = q.shape
    n_kv = k.shape[2]
    G = H // n_kv
    scale = 1.0 / math.sqrt(hd)
    q_block = min(q_block, S)
    kv_block = min(kv_block, S)
    nq, nk = S // q_block, S // kv_block
    outs = []
    for i in range(nq):
        qg = _group(q[:, i * q_block:(i + 1) * q_block], n_kv)
        m = torch.full((B, n_kv, G, q_block), -1e30, device=q.device)
        l = torch.zeros((B, n_kv, G, q_block), device=q.device)
        acc = torch.zeros((B, q_block, n_kv, G, hd), device=q.device)
        qpos = i * q_block + torch.arange(q_block, device=q.device)
        for j in range(nk):
            sl = slice(j * kv_block, (j + 1) * kv_block)
            logits = _logits(qg, k[:, sl], scale, cap)        # (B,KV,G,Bq,Bk)
            if causal:
                kpos = j * kv_block + torch.arange(kv_block, device=q.device)
                logits = logits.masked_fill(qpos[:, None] < kpos[None, :],
                                            -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr.permute(0, 3, 1, 2)[..., None]
                   + _pv(p, v[:, sl]))
            m = m_new
        denom = l.permute(0, 3, 1, 2)[..., None].clamp_min(1e-30)
        outs.append((acc / denom).reshape(B, q_block, H, hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_banded(q, k, v, *, window: int, cap: Optional[float] = None,
                     q_block: int = 512):
    """Sliding-window attention: per q block, a static-length KV slice of
    window+q_block positions, so compute scales as O(S·W). The last
    block takes what is left of S when q_block does not divide it (the
    reference's reshape needs S a multiple of q_block)."""
    S = q.shape[1]
    q_block = min(q_block, S)
    L = min(window + q_block, S)
    outs = []
    for begin in range(0, S, q_block):
        end = min(begin + q_block, S)
        start = min(max(end - L, 0), S - L)
        q_pos = torch.arange(begin, end, device=q.device)
        kv_pos = start + torch.arange(L, device=q.device)
        outs.append(attention_direct(
            q[:, begin:end], k[:, start:start + L],
            v[:, start:start + L], causal=True, cap=cap, window=window,
            q_positions=q_pos, kv_positions=kv_pos))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Unified entry point used by the blocks
# ---------------------------------------------------------------------------

DIRECT_MAX_SEQ = 2048


def _use_flash_kernel(q, kind: str, policy) -> bool:
    """The reference's rule with the card in the TPU's place: the fused
    kernel only with no policy, on a CUDA tensor, for full-sequence
    ``"full"``/``"bidir"`` attention."""
    return policy is None and q.is_cuda and kind in ("full", "bidir")


def attention(q, k, v, *, kind: str, cfg, policy=None):
    """kind: "full" (causal) | "swa" | "bidir" (encoder/cross)."""
    cap = cfg.attn_softcap
    S = q.shape[1]
    if _use_flash_kernel(q, kind, policy):
        return flash_attention(q, k, v, causal=(kind == "full"),
                               softcap=cap or 0.0)
    kv_local = _local_heads(cfg, policy)
    k, v = maybe_repeat_kv(cfg, policy, k, v)
    if policy is not None:
        # across ranks: q is the local heads already; K/V are too, or
        # (repeated from all KV heads) are cut to them
        kv_src = None if kv_local else P(policy.batch(), None, None, None)
        q = policy.constrain(q, policy.act_heads())
        k, v = (policy.constrain(t, policy.act_heads(), src=kv_src)
                for t in (k, v))
    if kind == "swa" and cfg.window is not None and S > cfg.window:
        out = attention_banded(q, k, v, window=cfg.window, cap=cap)
    elif kind == "bidir":
        if S <= DIRECT_MAX_SEQ:
            out = attention_direct(q, k, v, causal=False, cap=cap)
        else:
            out = attention_blockwise(q, k, v, causal=False, cap=cap)
    elif S <= DIRECT_MAX_SEQ:
        out = attention_direct(q, k, v, causal=True, cap=cap,
                               window=cfg.window if kind == "swa" else None)
    else:
        out = attention_blockwise(q, k, v, causal=True, cap=cap)
    if policy is not None:
        out = policy.constrain(out, policy.act_heads())
    return out


# ---------------------------------------------------------------------------
# Decode (single position, KV cache)
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, kv_positions, cur_pos, *, cfg,
                     window: Optional[int] = None, policy=None):
    """q (B,1,H,hd); caches (B,S,KV,hd); kv_positions (B,S) holding the
    absolute position stored in each slot (-1 = unwritten). ``cur_pos``
    is an int (every row at one position) or a (B,) tensor.

    Across ranks q holds the local heads; caches sharded on the KV heads
    hold the local ones, and caches sharded on the sequence (KV heads
    not dividing the model axis) are gathered whole, repeated to the
    query heads and cut to the local ones."""
    if policy is not None:
        kv_local = _local_heads(cfg, policy)
        spec = policy.act_kv_cache(cfg.num_kv_heads)
        k_cache = policy.constrain(k_cache, spec)
        v_cache = policy.constrain(v_cache, spec)
        if not kv_local:
            whole = P(policy.batch(), None, None, None)
            k_cache, v_cache = (policy.constrain(t, whole, src=spec)
                                for t in (k_cache, v_cache))
            kv_positions = policy.constrain(
                kv_positions, P(policy.batch(), None), src=spec[:2])
            k_cache, v_cache = maybe_repeat_kv(cfg, policy, k_cache,
                                               v_cache)
            k_cache, v_cache = (policy.constrain(t, policy.act_heads(),
                                                 src=whole)
                                for t in (k_cache, v_cache))
    if torch.is_tensor(cur_pos) and cur_pos.dim() == 1:
        q_pos = cur_pos[:, None]
    else:
        # a fill, not a host-to-device copy: no wait on the stream
        q_pos = torch.full((q.shape[0], 1), int(cur_pos), device=q.device)
    return attention_direct(
        q, k_cache, v_cache, causal=True, cap=cfg.attn_softcap,
        window=window, q_positions=q_pos, kv_positions=kv_positions)
