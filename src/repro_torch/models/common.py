"""Shared model building blocks: init, norms, rotary embeddings,
activations, the chunked loss (counterpart of ``repro/models/common.py``).

The init functions draw from an explicit ``torch.Generator`` and make
the tensor on that generator's device; a ``ShapeOnly`` in its place
makes shapes only (tensors on the ``meta`` device, the counterpart of
``jax.eval_shape``). ``remat`` is ``jax.checkpoint``'s counterpart:
activation checkpointing while autograd records.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import collectives as C


class ShapeOnly:
    """Stands in for a ``torch.Generator`` in the init functions: every
    tensor is made on the ``meta`` device (no memory, no draws)."""
    device = torch.device("meta")


def _draw(gen, shape):
    return torch.randn(shape, device=gen.device, dtype=torch.float32,
                       generator=gen if isinstance(gen, torch.Generator)
                       else None)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               fan_in: Optional[int] = None):
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan, 1))
    return _draw(gen, shape).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    return _draw(gen, shape).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6, *, plus_one: bool = False):
    """RMSNorm in f32 accumulation. ``plus_one`` = gemma-style (1+scale)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.float()
    if plus_one:
        s = 1.0 + s
    return (y * s).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(theta, exponent)             # (hd/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, N, hd) with positions (..., S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(length: int, dim: int, dtype=torch.float32,
                       device=None):
    """Whisper-style fixed sinusoidal embeddings (T, D)."""
    log_timescale = math.log(10000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        dim // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32,
                          device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)],
                     dim=1).to(dtype)


# ---------------------------------------------------------------------------
# Activations / misc
# ---------------------------------------------------------------------------

def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "geglu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def matmul(a, b):
    """``a @ b`` in the two operands' promoted dtype (``jnp.einsum``'s
    rule: float32 frames against bfloat16 weights compute in float32)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def remat(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward pass
    instead of kept (``jax.checkpoint``) when autograd records; a plain
    call otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def chunked_softmax_xent(hidden, head_w, labels, *, chunk: int,
                         constrain=None, final_cap: Optional[float] = None,
                         policy=None, vocab: Optional[int] = None):
    """Cross-entropy over a large vocab computed seq-chunk at a time.

    The (B, S, V) logits never exist whole: each chunk's float32 head
    product, softcap, logsumexp and gold gather run under ``remat``, so
    live memory stays at (B, chunk, V) and the backward recomputes them.
    Labels < 0 are padding. Returns the summed loss and the token count
    (float32 scalars), over this rank's rows.

    Under a policy across ranks whose model axis shards the vocab
    (``vocab`` the whole vocab, ``head_w`` this rank's (D, V/tp) block;
    ``hidden`` is replicated over the model axis), each rank holds its
    slice of the logits: ``lse`` takes the max and the sum of
    exponentials across the model axis, and the gold logit comes from
    the rank that owns the label's column."""
    B, S, D = hidden.shape
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    if chunk * n_chunks != S:
        raise ValueError(f"chunked_softmax_xent: sequence {S} does not "
                         f"split into {n_chunks} chunks")
    tp = vocab_sharded(policy, vocab or head_w.shape[-1])
    group = policy._group(policy.tp_axis) if tp else None

    def chunk_loss(h_c, y_c):
        if tp:
            h_c = policy.enter_tp(h_c)
        logits = softcap(h_c.float() @ head_w.float(), final_cap)
        if constrain is not None:
            logits = constrain(logits)
        n = logits.shape[-1]
        vocab = n * policy.tp_size() if tp else n
        # a negative label indexes from the end, as take_along_axis
        # does; its term is masked out
        idx = torch.where(y_c < 0, y_c + vocab, y_c).long()
        if tp:
            m = C.reduce_max(logits.amax(dim=-1), group)
            se = C.reduce_sum(torch.exp(logits - m[..., None]).sum(dim=-1),
                              group)
            lse = m + torch.log(se)
            local = idx - policy.tp_index() * n
            own = (local >= 0) & (local < n)
            gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
            gold = C.reduce_sum(torch.where(own, gold, 0.0), group)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, idx[..., None])[..., 0]
        mask = (y_c >= 0).float()
        return ((lse - gold) * mask).sum(), mask.sum()

    loss = count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        l, n = remat(chunk_loss, hidden[:, sl], labels[:, sl])
        loss, count = loss + l, count + n
    return loss, count


def vocab_sharded(policy, vocab: int) -> bool:
    """Whether the policy runs across ranks with the vocab (embedding
    rows, head columns, logits) split over the model axis."""
    return (policy is not None and not policy.one_rank
            and policy.tp_axis is not None and policy.tp_size() > 1
            and vocab % policy.tp_size() == 0)


def embed_lookup(emb, tokens, policy=None, spec=None):
    """``emb[tokens]``. Across ranks ``emb`` is this rank's block under
    ``spec`` and ``tokens`` its rows: ``Policy.lookup`` finds them, and
    the rows of a vocab split over the model axis sum over it."""
    if policy is None or policy.one_rank:
        return emb[tokens.long()]
    rows = policy.lookup(emb, tokens, spec)
    return policy.constrain(rows, policy.act_hidden(), partial=spec[0])
