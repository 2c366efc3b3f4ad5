"""Fused flash attention (forward): the CUDA kernel
``csrc/flash_attention.cu`` (port of the Pallas kernel
``repro/kernels/flash_attention.py``), on Hopper's tensor cores: float32
as three TF32 products (``mma.sync``), bf16 on ``wgmma``.

On CUDA tensors the wrapper launches the kernel or raises; on CPU
tensors it computes the plain version, ``ref.flash_attention_ref``.
``flash_attention.launches`` counts kernel launches. The kernel has no
backward, as the reference's has none: a CUDA call made while autograd
records and any of q, k, v requires grad raises, so an output without a
gradient never passes for one (training runs attention under a sharding
policy, which takes the plain paths).

Two shapes go past the reference's Pallas kernel, which asserts S a
multiple of its block and reshapes K/V to the query's S: head_dim 80
(zamba2's shared block) on the float32 route, and a key length of its
own for non-causal calls (whisper's cross-attention, 1500 encoder keys
against the decoder's queries). The reference computes both through
``attention_direct`` off the TPU; the port is held to that.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128)
# head dims the bf16 (wgmma) route builds: its swizzled tiles take rows
# of 32, 64 or 128 bytes, or 64-column blocks of wider heads; 80 is
# neither
BF16_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(t) -> bool:
    align = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s % align for s in t.stride()[:-1]))


def _kernel_layout(t):
    """``t`` with a contiguous head dimension, aligned row starts and a
    16-byte aligned start, as the kernel reads it through its strides (a
    copy into fresh storage only if needed)."""
    if not _aligned(t):
        t = t.clone(memory_format=torch.contiguous_format)
    if not _aligned(t):
        raise ValueError("flash_attention: tensor storage not 16-byte "
                         "aligned")
    return t


def _check(q, k, v, causal, block_q, block_k):
    if block_q < 1 or block_k < 1:
        raise ValueError(f"flash_attention: block sizes must be positive, "
                         f"got {block_q}, {block_k}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention: q, k, v must share one CUDA "
                         f"device, got {[str(d) for d in devices]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 q/k/v of "
                        f"one dtype required, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q (B, Sq, H, hd) and k/v "
                         f"(B, Sk, KV, hd) required, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if causal and k.shape[1] != S:
        raise ValueError(f"flash_attention: a causal call needs as many "
                         f"keys as queries, got {k.shape[1]} keys for {S}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and hd not in BF16_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} runs in float32 "
                         f"only; bfloat16 takes {BF16_HEAD_DIMS}")
    if B * S * k.shape[1] == 0:
        raise ValueError(f"flash_attention: empty input {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")


def flash_attention(q, k, v, *, causal: bool = True, softcap: float = 0.0,
                    block_q: int = 256, block_k: int = 256):
    """q (B, Sq, H, hd) · k/v (B, Sk, KV, hd), H = G·KV → out (B, Sq, H,
    hd).

    Softmax attention with scale 1/sqrt(hd), an optional causal mask and
    the fused logit softcap (``softcap`` 0 = none). K/V heads are shared
    by query-head groups (no repeat). A causal call needs Sk == Sq; a
    non-causal one attends every query to all Sk keys.
    ``block_q``/``block_k`` are the reference's TPU tiling hint: checked,
    and not used, since the kernel runs one tile shape for every call
    (128 query rows a CTA against 64-key tiles); any Sq and Sk work."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal=causal, softcap=softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward, and q, k or "
            "v requires grad; training runs attention under a sharding "
            "policy (models.attention takes its direct/blockwise paths "
            "then), or call it under torch.no_grad()")
    _check(q, k, v, causal, block_q, block_k)
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    B, S, H, hd = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.library()
    _build.check(lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, k.shape[1], H, k.shape[2], hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), float(softcap),
        1.0 / math.sqrt(hd), _DTYPES[q.dtype], _build.stream(q.device)),
        "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
