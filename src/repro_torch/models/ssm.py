"""Mamba2 (SSD, state-space duality) mixer (counterpart of
``repro/models/ssm.py``).

Chunked SSD (Dao & Gu 2024, §6): the sequence is split into chunks of
length Q; within a chunk the quadratic "attention-like" form runs as
batched matmuls, and a loop over chunks carries the (H, N, P) recurrent
state between them. Decode is the recurrence ``h' = a·h + dt·B⊗x``,
``y = C·h + D·x``, O(1) a token.

As in the reference: S is padded to a multiple of the chunk with dt = 0
(decay 1, no input, so y and the final state stay exact), the
intra-chunk decay mask is applied before the ``exp`` (the masked
differences are positive and would overflow), and softplus and the
decays run in float32. One difference of form, not of value: the
reference builds the chunk states' product (B, nc, Q, H, N, P) and sums
it over Q, which XLA fuses; eager PyTorch would materialise it (17 GB at
mamba2-1.3b's full width, batch 4, 2048 tokens), so here Q is
contracted inside the einsum.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _proj
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.sharding.policy import require_dense


class SSMState(NamedTuple):
    h: torch.Tensor          # (..., B, H, N, P) recurrent state, float32
    conv: torch.Tensor       # (..., B, K-1, H, P) rolling conv inputs
    conv_B: torch.Tensor     # (..., B, K-1, G, N)
    conv_C: torch.Tensor     # (..., B, K-1, G, N)


def dims(cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    H = di // s.head_dim
    return di, H, s.head_dim, s.n_groups, s.d_state, s.d_conv


def init_ssm_params(cfg, gen, dtype):
    d = cfg.d_model
    di, H, Pd, G, N, K = dims(cfg)
    dev = gen.device
    return {
        "wz": dense_init(gen, (d, H, Pd), dtype, fan_in=d),
        "wx_in": dense_init(gen, (d, H, Pd), dtype, fan_in=d),
        "wB": dense_init(gen, (d, G, N), dtype, fan_in=d),
        "wC": dense_init(gen, (d, G, N), dtype, fan_in=d),
        "wdt": dense_init(gen, (d, H), dtype, fan_in=d),
        "conv_x": dense_init(gen, (K, H, Pd), dtype, fan_in=K),
        "conv_B": dense_init(gen, (K, G, N), dtype, fan_in=K),
        "conv_C": dense_init(gen, (K, G, N), dtype, fan_in=K),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev))
                 .to(dtype),
        "ssm_D": torch.ones((H,), dtype=dtype, device=dev),
        "dt_bias": torch.full((H,), math.log(math.e - 1), dtype=dtype,
                              device=dev),                 # softplus ~ 1
        "ssm_norm": torch.zeros((H, Pd), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (H, Pd, d), dtype, fan_in=H * Pd),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along axis 1. x (B,S,...), w (K,...).

    With ``state`` (B,K-1,...) prepended (decode/streaming); returns
    (y, new_state)."""
    K = w.shape[0]
    if state is None:
        xp = torch.cat([x.new_zeros((x.shape[0], K - 1) + x.shape[2:]), x],
                       dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, k:k + S] * w[k] for k in range(K))
    return y, xp[:, S:S + K - 1]


def _heads(t, hg: int):
    """(..., G, N) -> (..., H, N): group g's row for heads g·hg .. +hg."""
    return t.repeat_interleave(hg, dim=-2)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    xh (B,S,H,P) · dt (B,S,H) · A (H,) negative decay rates ·
    Bm/Cm (B,S,G,N). Returns (y (B,S,H,P), final state (B,H,N,P)), in
    float32.
    """
    B, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    nc = S // Q
    hg = H // G

    xc = xh.reshape(B, nc, Q, H, Pd).float()
    dtc = dt.reshape(B, nc, Q, H).float()
    Bc = Bm.reshape(B, nc, Q, G, N).float()
    Cc = Cm.reshape(B, nc, Q, G, N).float()

    dA = dtc * A                                          # (B,nc,Q,H) <= 0
    cum = torch.cumsum(dA, dim=2)                         # within-chunk
    total = cum[:, :, -1, :]                              # (B,nc,H)

    # ---- intra-chunk (quadratic within Q) --------------------------------
    # L[i,j] = exp(cum_i - cum_j) for i >= j, masked before the exp
    Lm = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    Lm = torch.exp(Lm.masked_fill(~mask[:, :, None], -1e30))
    CB = torch.einsum("bcqgn,bcsgn->bcqsg", Cc, Bc)       # (B,nc,Qi,Qj,G)
    M = CB.repeat_interleave(hg, dim=-1) * Lm * dtc[:, :, None, :, :]
    del Lm, CB
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, xc)
    del M

    # ---- chunk states: Q contracted inside the product -------------------
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchnp", _heads(Bc, hg),
                          xc * (dtc * decay_to_end)[..., None])

    # ---- inter-chunk recurrence over nc ----------------------------------
    h = xh.new_zeros((B, H, N, Pd), dtype=torch.float32)
    decay = torch.exp(total)                              # (B,nc,H)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                  # state *before*
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # (B,nc,H,N,P)

    # ---- inter-chunk contribution ---------------------------------------
    y = y + torch.einsum("bcqhn,bchnp->bcqhp",
                         _heads(Cc, hg) * torch.exp(cum)[..., None], h_prev)
    return y.reshape(B, S, H, Pd), h


def _inputs(cfg, p, x, state=None):
    """The mixer's projections and convolutions: (z, xh, Bm, Cm, dt, A,
    conv tails); dt through softplus in float32."""
    z = _proj(x, p["wz"])
    xh, conv = _causal_conv(_proj(x, p["wx_in"]), p["conv_x"],
                            None if state is None else state.conv)
    Bm, conv_B = _causal_conv(_proj(x, p["wB"]), p["conv_B"],
                              None if state is None else state.conv_B)
    Cm, conv_C = _causal_conv(_proj(x, p["wC"]), p["conv_C"],
                              None if state is None else state.conv_C)
    xh, Bm, Cm = F.silu(xh), F.silu(Bm), F.silu(Cm)
    dt = F.softplus(_proj(x, p["wdt"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                   # (H,) < 0
    return z, xh, Bm, Cm, dt, A, (conv, conv_B, conv_C)


def _gate_out(cfg, p, y, xh, z, x_dtype):
    y = y + xh.float() * p["ssm_D"].float()[:, None]
    y = y.to(x_dtype) * F.silu(z)                         # gated
    y = rms_norm(y, p["ssm_norm"], cfg.norm_eps, plus_one=True)
    return torch.matmul(y.flatten(-2), p["out_proj"].flatten(0, 1))


def ssm_mixer(cfg, p, x, policy=None, *, want_state: bool = False):
    """Full-sequence Mamba2 mixer. x (B,S,D) -> (B,S,D) [, final
    SSMState]."""
    require_dense(cfg, policy)
    z, xh, Bm, Cm, dt, A, tails = _inputs(cfg, p, x)
    if policy is not None:
        xh = policy.constrain(xh, policy.act_heads())
        z = policy.constrain(z, policy.act_heads())
    S = xh.shape[1]
    Q = min(cfg.ssm.chunk, S)
    pad = (-S) % Q
    if pad:   # dt = 0 on the pad steps
        xh_p, dt_p, Bm_p, Cm_p = (
            F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            for t in (xh, dt, Bm, Cm))
    else:
        xh_p, dt_p, Bm_p, Cm_p = xh, dt, Bm, Cm
    y, h_last = _ssd_chunked(xh_p, dt_p, A, Bm_p, Cm_p, Q)
    if pad:
        y = y[:, :S]
    out = _gate_out(cfg, p, y, xh, z, x.dtype)
    if policy is not None:
        out = policy.constrain(out, policy.act_hidden())
    if want_state:
        return out, SSMState(h_last, *tails)
    return out


def init_ssm_state(cfg, batch: int, dtype=torch.float32, *,
                   device="cuda") -> SSMState:
    di, H, Pd, G, N, K = dims(cfg)
    return SSMState(
        h=torch.zeros((batch, H, N, Pd), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, K - 1, H, Pd), dtype=dtype, device=device),
        conv_B=torch.zeros((batch, K - 1, G, N), dtype=dtype, device=device),
        conv_C=torch.zeros((batch, K - 1, G, N), dtype=dtype, device=device),
    )


def ssm_decode_step(cfg, p, x, state: SSMState, policy=None):
    """Single-token recurrence. x (B,1,D) -> (B,1,D), new state (the
    reference constrains nothing here; ``policy`` is accepted as it is
    there)."""
    require_dense(cfg, policy)
    di, H, Pd, G, N, K = dims(cfg)
    hg = H // G
    z, xh, Bm, Cm, dt, A, tails = _inputs(cfg, p, x, state)
    dt = dt[:, 0]                                         # (B,H)
    a = torch.exp(dt * A)                                 # (B,H)

    xf = xh.float()[:, 0]                                 # (B,H,P)
    Bh = _heads(Bm.float()[:, 0], hg)                     # (B,H,N)
    Ch = _heads(Cm.float()[:, 0], hg)

    h_new = (state.h * a[:, :, None, None]
             + (dt[:, :, None] * Bh)[..., None] * xf[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", Ch, h_new)
    out = _gate_out(cfg, p, y[:, None], xh, z, x.dtype)
    return out, SSMState(h_new, *tails)
