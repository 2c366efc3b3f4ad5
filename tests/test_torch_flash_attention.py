"""The port's flash-attention wrapper on CPU tensors (its plain version,
``ref.flash_attention_ref``) against the reference's Pallas kernel in
interpret mode and its jnp oracle, on the same numpy inputs. The CUDA
kernel itself is held against the same plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Bars: the reference's,
atol 2e-5 / rtol 1e-4 in float32 and 3e-2 in bf16
(``tests/test_flash_attention.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention

RNG = np.random.default_rng(12)


def _qkv(B, S, H, KV, hd):
    return tuple(RNG.standard_normal((B, S, n, hd)).astype(np.float32)
                 for n in (H, KV, KV))


def _check(q, k, v, *, causal=True, softcap=0.0, block=128):
    before = flash_attention.launches
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          softcap=softcap).numpy()
    assert flash_attention.launches == before      # CPU: no kernel launch
    pallas = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                       softcap=softcap, block_q=block, block_k=block,
                       interpret=True)
    oracle = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, softcap=softcap)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 256, 8, 1, 32),     # MQA
    (2, 128, 16, 8, 128),   # gemma-ish
    (1, 64, 4, 1, 16),      # the reduced configs' head_dim
])
def test_flash_wrapper_matches_pallas(B, S, H, KV, hd):
    _check(*_qkv(B, S, H, KV, hd))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_wrapper_variants(causal, softcap):
    _check(*_qkv(1, 256, 4, 2, 64), causal=causal, softcap=softcap,
           block=64)


def test_flash_wrapper_bf16():
    q, k, v = _qkv(1, 256, 4, 2, 64)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    for want in (jax_flash(jq, jk, jv, block_q=128, block_k=128,
                           interpret=True),
                 jref.flash_attention_ref(jq, jk, jv)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=3e-2, rtol=3e-2)


def test_plain_version_takes_any_sequence_length():
    # the kernel masks a ragged S itself; its plain version is what it is
    # held against on the card, so it must agree with the oracle there too
    q, k, v = _qkv(1, 37, 4, 2, 16)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
