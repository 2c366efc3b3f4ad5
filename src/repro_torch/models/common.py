"""Shared model building blocks: init, norms, rotary embeddings,
activations (counterpart of ``repro/models/common.py``).

The init functions draw from an explicit ``torch.Generator`` and make
the tensor on that generator's device. ``chunked_softmax_xent`` comes
with the training path (ROADMAP queue 1 item 18 part 6).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               fan_in: Optional[int] = None):
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(0.02).to(dtype)


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
