"""Plain PyTorch versions of every kernel (counterpart of
``repro/kernels/ref.py``): ``torch.fft`` oracles for the FFT and
bandpass kernels, softmax attention for the flash kernel."""
from __future__ import annotations

import math

import torch


def fft_ref(re, im, *, inverse: bool = False):
    """Batched FFT along the last axis on split planes via torch.fft."""
    x = torch.complex(re.float(), im.float())
    out = torch.fft.ifft(x, dim=-1) if inverse else torch.fft.fft(x, dim=-1)
    return out.real.float().contiguous(), out.imag.float().contiguous()


def bandpass_ref(re, im, mask):
    """Masked planes plus kept/total energy; the plain version of the
    bandpass kernel."""
    m = mask.float()
    p = re.float() ** 2 + im.float() ** 2
    return re * m, im * m, torch.sum(p * m), torch.sum(p)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        softcap: float = 0.0):
    """Plain softmax attention with GQA head sharing, causal mask and
    optional logit softcap; the plain version of the flash kernel.
    q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd) in q's dtype."""
    S, H, hd = q.shape[1:]
    G = H // k.shape[2]
    qf = q.float() / math.sqrt(hd)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
