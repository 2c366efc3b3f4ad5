"""KV caches: full, rolling (sliding-window) and int8 (counterpart of
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
the in-place writes reach the stack. ``QuantKVCache`` stores K/V as
int8 with one absmax scale per (position, head), as the reference does;
``update_any_cache`` writes either kind and ``read_kv`` dequantizes.

Across ranks (a sharding policy off a one-rank mesh) a cache holds this
rank's block in the policy's layout (``act_kv_cache``): its batch rows,
and its KV heads, or — where the KV heads do not divide the model axis —
its block of the slots (``seq_block``, as ``cut_seq`` makes it). A
write then lands on the rank that holds the slot; the slot is that of
the whole cache (``p mod W`` of the whole width for a rolling one). The
enc-dec's self-attention cache is laid out so too, and its
cross-attention K/V (plain tensors) hold this rank's rows and the KV
heads of its query heads; an SSM layer's state (``models/ssm.SSMState``)
holds this rank's rows and SSD heads. A stacked cache or state made for
``G·batch`` rows is split over ``G`` (``split_rows``) as on one rank.
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
    return _write(cache, {"k": k_new[:, 0], "v": v_new[:, 0]}, cur_pos,
                  None)


def cache_positions(cache: KVCache) -> torch.Tensor:
    return cache.positions


# ---------------------------------------------------------------------------
# Int8-quantized cache (halves the cache's memory and decode traffic)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantKVCache:
    """Per-(position, head) absmax-scaled int8 KV storage."""
    k: torch.Tensor            # (..., B, S, KV, hd) int8
    v: torch.Tensor            # (..., B, S, KV, hd) int8
    k_scale: torch.Tensor      # (..., B, S, KV, 1) bf16
    v_scale: torch.Tensor      # (..., B, S, KV, 1) bf16
    positions: torch.Tensor    # (..., B, S) int32
    window: int = 0


def quantize_kv(x):
    """x (..., hd) -> (int8 values, bf16 scales (..., 1)); the values are
    rounded against the float32 scale, as in the reference."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def init_quant_cache(batch: int, length: int, n_kv: int, head_dim: int,
                     *, window: int = 0, device="cuda") -> QuantKVCache:
    if window:
        length = min(length, window)
    shape = (batch, length, n_kv, head_dim)
    scale = (batch, length, n_kv, 1)
    return QuantKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.zeros(scale, dtype=torch.bfloat16, device=device),
        v_scale=torch.zeros(scale, dtype=torch.bfloat16, device=device),
        positions=torch.full((batch, length), -1, dtype=torch.int32,
                             device=device),
        window=window,
    )


def read_kv(cache, dtype=torch.bfloat16):
    """K/V for attention: an int8 cache dequantized to ``dtype``, a dense
    cache's tensors as they are."""
    if isinstance(cache, QuantKVCache):
        k = (cache.k.float() * cache.k_scale.float()).to(dtype)
        v = (cache.v.float() * cache.v_scale.float()).to(dtype)
        return k, v
    return cache.k, cache.v


def _seq_dim(name: str) -> int:
    return -1 if name == "positions" else -3


def cut_seq(cache, index: int, count: int):
    """Block ``index`` of ``count`` of every tensor's slot dim (a cache
    of the same kind)."""
    def cut(name, t):
        d = _seq_dim(name)
        n = t.shape[d] // count
        if t.shape[d] % count:
            raise ValueError(f"a cache of {t.shape[d]} slots does not split "
                             f"into {count} blocks")
        return t.narrow(d, index * n, n).contiguous()
    return type(cache)(**{
        f.name: (cut(f.name, getattr(cache, f.name))
                 if torch.is_tensor(getattr(cache, f.name))
                 else getattr(cache, f.name))
        for f in dataclasses.fields(cache)})


def _write(cache, values: dict, cur_pos, seq_block):
    """Write ``values`` (field name -> (B, ...) row for one slot) at the
    slot of ``cur_pos`` (an int or a (B,) tensor), in place. With
    ``seq_block`` = (index, count) the cache holds that block of the
    slots and only rows whose slot lies in it are written."""
    S = cache.k.shape[1]
    index, count = seq_block or (0, 1)
    total = S * count
    if not torch.is_tensor(cur_pos) or cur_pos.dim() == 0:
        pos = int(cur_pos)
        slot = (pos % total if cache.window else pos) - index * S
        if not 0 <= slot < S:
            return cache
        rows = slice(None)
        values = dict(values, positions=pos)
    else:
        cur_pos = cur_pos.long()
        slot = (cur_pos % total if cache.window else cur_pos) - index * S
        rows = torch.arange(cache.k.shape[0], device=cache.k.device)
        values = dict(values, positions=cur_pos.to(torch.int32))
        if seq_block is not None:
            mine = (slot >= 0) & (slot < S)
            rows, slot = rows[mine], slot[mine]
            values = {k: (v[mine] if torch.is_tensor(v) and v.dim() else v)
                      for k, v in values.items()}
    for name, v in values.items():
        t = getattr(cache, name)
        t[rows, slot] = v.to(t.dtype) if torch.is_tensor(v) else v
    return cache


def update_any_cache(cache, k_new, v_new, cur_pos, *, seq_block=None):
    """Write one token's K/V into a dense or an int8 cache, in place;
    ``cur_pos`` an int or a (B,) tensor (see ``update_cache``);
    ``seq_block`` (index, count) for a cache holding a block of the
    slots."""
    if not isinstance(cache, QuantKVCache):
        return _write(cache, {"k": k_new[:, 0], "v": v_new[:, 0]},
                      cur_pos, seq_block)
    kq, ks = quantize_kv(k_new[:, 0])
    vq, vs = quantize_kv(v_new[:, 0])
    return _write(cache, {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs},
                  cur_pos, seq_block)


def split_rows(cache, G: int, batch: int):
    """A cache made for G·batch rows, as one stacked (G, batch, ...)."""
    return type(cache)(**{
        f.name: (getattr(cache, f.name).unflatten(0, (G, batch))
                 if torch.is_tensor(getattr(cache, f.name))
                 else getattr(cache, f.name))
        for f in dataclasses.fields(cache)})


def cache_views(cache, g: int):
    """Depth index ``g`` of a cache stacked over depth: a cache of the
    same kind whose tensors are views, so in-place writes reach the
    stack."""
    fields = {f.name: getattr(cache, f.name)
              for f in dataclasses.fields(cache)}
    return type(cache)(**{k: (v[g] if torch.is_tensor(v) else v)
                          for k, v in fields.items()})
