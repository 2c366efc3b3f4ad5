"""KV caches: full and rolling (sliding-window) (counterpart of
``repro/serve/kvcache.py``).

Every cache carries an explicit per-slot ``positions`` tensor (absolute
token position stored in each slot, -1 = unwritten), so one decode
attention path serves both layouts:

* full    — (B, S_max, KV, hd); slot i holds position i.
* rolling — (B, W, KV, hd); position p lands in slot p mod W.

Unlike the reference's functional updates, ``update_cache`` writes the
new token's K/V into the cache tensors in place: a copy of every layer's
cache per decoded token would move the whole cache through device
memory each step. Stacked caches (a leading depth axis, as
``lm.prefill`` makes them) hold views of one tensor per layer slot, so
the in-place writes reach the stack. ``QuantKVCache`` (int8 storage)
waits for the int8 caches (ROADMAP queue 1 item 18).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor            # (..., B, S, KV, hd)
    v: torch.Tensor            # (..., B, S, KV, hd)
    positions: torch.Tensor    # (..., B, S) int32, -1 = unwritten
    window: int = 0            # 0 = full cache; >0 = rolling with width S


def init_cache(batch: int, length: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, *, window: int = 0,
               device="cuda") -> KVCache:
    if window:
        length = min(length, window)
    shape = (batch, length, n_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((batch, length), -1, dtype=torch.int32,
                             device=device),
        window=window,
    )


def from_prefill(k, v, *, window: int = 0, pad_to: int = 0) -> KVCache:
    """Build a cache from prefill-produced K/V (..., B, S, KV, hd)."""
    S = k.shape[-3]
    lead = k.shape[:-3]
    pos = torch.arange(S, dtype=torch.int32, device=k.device).expand(
        *lead, S)
    if window and S > window:
        # keep the last `window` positions, placed at slot p mod window
        tail = torch.arange(S - window, S, device=k.device)
        slots = tail % window
        kr = k.new_zeros((*lead, window, *k.shape[-2:]))
        vr = v.new_zeros((*lead, window, *v.shape[-2:]))
        pr = torch.full((*lead, window), -1, dtype=torch.int32,
                        device=k.device)
        kr[..., slots, :, :] = k[..., S - window:, :, :]
        vr[..., slots, :, :] = v[..., S - window:, :, :]
        pr[..., slots] = tail.to(torch.int32)
        return KVCache(kr, vr, pr, window)
    if pad_to and pad_to > S:
        kp = k.new_zeros((*lead, pad_to, *k.shape[-2:]))
        vp = v.new_zeros((*lead, pad_to, *v.shape[-2:]))
        pp = torch.full((*lead, pad_to), -1, dtype=torch.int32,
                        device=k.device)
        kp[..., :S, :, :] = k
        vp[..., :S, :, :] = v
        pp[..., :S] = pos
        return KVCache(kp, vp, pp, window)
    return KVCache(k, v, pos.contiguous(), window)


def update_cache(cache: KVCache, k_new, v_new, cur_pos) -> KVCache:
    """Write one token's K/V (B, 1, KV, hd) at absolute position
    ``cur_pos``, in place; returns ``cache``.

    ``cur_pos`` is an int (all rows at one position — plain batched
    decode) or a (B,) tensor (per-slot positions — the continuous
    batching engine)."""
    S = cache.k.shape[1]
    if not torch.is_tensor(cur_pos) or cur_pos.dim() == 0:
        pos = int(cur_pos)
        slot = pos % S if cache.window else pos
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
        cache.positions[:, slot] = pos
        return cache
    # per-row positions: one slot per batch row
    cur_pos = cur_pos.long()
    slot = cur_pos % S if cache.window else cur_pos
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.positions[rows, slot] = cur_pos.to(torch.int32)
    return cache


def cache_positions(cache: KVCache) -> torch.Tensor:
    return cache.positions


def read_kv(cache: KVCache):
    """K/V views for attention (dense caches hold them as they are)."""
    return cache.k, cache.v
