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


# The CUDA kernel computes float32 attention as three TF32 products on
# the tensor cores; the arithmetic is held here, on the CPU, against the
# reference. An operand x splits into hi = x rounded to TF32 (10 mantissa
# bits, to nearest, ties away from zero: cvt.rna.tf32.f32) and lo = x - hi,
# of which the tensor core reads the top 19 bits (truncation); a.b is
# hi.hi + hi.lo + lo.hi with float32 sums.
def _tf32_rna(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _tf32_trunc(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xffffe000)).view(np.float32)


def _matmul_tf32(a, b, *, products):
    """a @ b (float32, batched) as the kernel's tensor cores take it:
    three TF32 products, or one (hi.hi)."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    out = np.matmul(a_hi, b_hi)
    if products == 3:
        a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
        out = np.matmul(a_lo, b_hi) + np.matmul(a_hi, b_lo) + out
    return out.astype(np.float32)


def _attention_tf32(q, k, v, *, causal, products):
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qs = (q * np.float32(1.0 / np.sqrt(hd))).transpose(0, 2, 1, 3)
    kt = np.repeat(k, G, axis=2).transpose(0, 2, 3, 1)
    vv = np.repeat(v, G, axis=2).transpose(0, 2, 1, 3)
    s = _matmul_tf32(qs, kt, products=products)
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, np.float32(-1e30))
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    o = _matmul_tf32(p, vv, products=products) / p.sum(-1, keepdims=True)
    return o.transpose(0, 2, 1, 3).astype(np.float32)


def test_tf32_rounding_helpers():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], np.float32)
    np.testing.assert_array_equal(
        _tf32_rna(x), np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                -(1.0 + 2.0 ** -10), 1.0], np.float32))
    np.testing.assert_array_equal(_tf32_trunc(x[1:2]), [1.0])
    # hi + lo is x exactly, lo under half a TF32 unit
    y = RNG.standard_normal(1000).astype(np.float32)
    hi = _tf32_rna(y)
    assert np.array_equal(hi + (y - hi), y)
    assert np.all(np.abs(y - hi) <= np.abs(y) * 2.0 ** -11)


@pytest.mark.parametrize("causal", [True, False])
def test_three_tf32_products_hold_the_reference_bar(causal):
    # scaled logits (q x 4: std 4, |s| up to ~20), where one TF32
    # product's ~5e-4 relative error shows
    q, k, v = _qkv(1, 256, 4, 2, 128)
    q = q * np.float32(4.0)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                                block_q=128, block_k=128, interpret=True))
    got = _attention_tf32(q, k, v, causal=causal, products=3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    one = _attention_tf32(q, k, v, causal=causal, products=1)
    excess = np.abs(one - want) - 1e-4 * np.abs(want)
    assert excess.max() > 2e-5, excess.max()


# Shapes past the reference's Pallas kernel (it asserts S a multiple of
# its block and reshapes K/V to the query's S): head_dim 80 (zamba2's
# shared block) and non-causal calls with a key length of their own
# (whisper's cross-attention). Off the TPU the reference computes both
# through attention_direct, which the plain version is held to.
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_plain_version_at_head_dim_80(causal, softcap):
    from repro.models.attention import attention_direct
    q, k, v = _qkv(2, 75, 8, 8, 80)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          softcap=softcap).numpy()
    want = attention_direct(*map(jnp.asarray, (q, k, v)), causal=causal,
                            cap=softcap or None)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("Sq,Sk", [(64, 1500), (1, 37), (130, 7)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_plain_version_with_a_key_length_of_its_own(Sq, Sk, softcap):
    from repro.models.attention import attention_direct
    q = RNG.standard_normal((2, Sq, 4, 64)).astype(np.float32)
    k, v = (RNG.standard_normal((2, Sk, 2, 64)).astype(np.float32)
            for _ in range(2))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                          softcap=softcap).numpy()
    want = attention_direct(*map(jnp.asarray, (q, k, v)), causal=False,
                            cap=softcap or None)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)


def test_causal_with_another_key_length_is_refused():
    q, k, v = _qkv(1, 64, 4, 4, 16)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k[:, :32]),
                        torch.from_numpy(v[:, :32]))
    with pytest.raises(ValueError, match="causal"):
        ref.flash_attention_ref(torch.from_numpy(q[:, :32]),
                                torch.from_numpy(k), torch.from_numpy(v))
