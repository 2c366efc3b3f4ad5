"""The port's whisper encoder-decoder (``models/encdec.py``) against the
reference's on CPU, at the reduced whisper config, on the same numpy
weights (carried across by ``params_from_jax``, depth unstacked) and
inputs: ``encode``, ``prefill`` with its self- and cross-attention
caches, ``decode_step``, and the reference's own prefill/decode
consistency check (``tests/test_serve.py``) run on the port. Bars:
atol 1e-5 / rtol 1e-4 against the reference; the consistency check
keeps the reference's 2e-3 / 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import encdec as jed
from repro_torch.configs import registry
from repro_torch.models import encdec
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-4)
B, T, S = 2, 24, 12


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = (jregistry.get_reduced("whisper-medium"),
                 registry.get_reduced("whisper-medium"))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jed.init_params(
        jcfg, jax.random.PRNGKey(6), jnp.float32, max_target=64))
    tree = jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)
    frames = (0.02 * rng.standard_normal((B, T, cfg.d_model))).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 2)).astype(np.int32)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(cfg, tree, device="cpu"), frames, tokens)


def test_params_unstack_encoder_and_decoder_depth(models):
    jcfg, cfg, jp, tp, _, _ = models
    assert len(tp["enc_layers"]) == cfg.encoder_layers == 2
    assert len(tp["dec_layers"]) == cfg.decoder_layers == 2
    _close(tp["dec_layers"][1]["cross_attn"]["wk"],
           jp["dec_layers"]["cross_attn"]["wk"][1], atol=0, rtol=0)


def test_encode_matches_reference(models):
    jcfg, cfg, jp, tp, frames, _ = models
    _close(encdec.encode(cfg, tp, torch.from_numpy(frames)),
           jed.encode(jcfg, jp, jnp.asarray(frames)))


def test_prefill_and_decode_match_reference(models):
    jcfg, cfg, jp, tp, frames, tokens = models
    jl, js = jed.prefill(jcfg, jp, {"frames": jnp.asarray(frames),
                                    "tokens": jnp.asarray(tokens[:, :S])},
                         cache_len=S + 4)
    tl, ts = encdec.prefill(cfg, tp, {"frames": torch.from_numpy(frames),
                                      "tokens": torch.from_numpy(
                                          tokens[:, :S])}, cache_len=S + 4)
    _close(tl, jl)
    for name in ("k", "v", "positions"):
        _close(getattr(ts["self"], name), getattr(js["self"], name))
    for got, want in zip(ts["cross"], js["cross"]):
        _close(got, want)
    for t in (S, S + 1):
        jl, js = jed.decode_step(jcfg, jp, jnp.asarray(tokens[:, t:t + 1]),
                                 js)
        tl, ts = encdec.decode_step(cfg, tp, torch.from_numpy(
            tokens[:, t:t + 1]), ts)
        _close(tl, jl)
        assert ts["pos"] == js["pos"] == t + 1
    _close(ts["self"].k, js["self"].k)


def test_prefill_then_decode_matches_longer_decoder_pass(models):
    """The reference's test_whisper_prefill_decode_consistency on the
    port: prefill(S) then one decode step == the decoder over S + 1."""
    _, cfg, _, tp, frames, tokens = models
    frames, tokens = torch.from_numpy(frames), torch.from_numpy(tokens)
    _, state = encdec.prefill(cfg, tp, {"frames": frames,
                                        "tokens": tokens[:, :S]},
                              cache_len=S + 4)
    logits, _ = encdec.decode_step(cfg, tp, tokens[:, S:S + 1], state)
    enc_out = encdec.encode(cfg, tp, frames)
    x = tp["embedding"][tokens[:, :S + 1].long()] + \
        tp["pos_embedding"][None, :S + 1]
    h, _ = encdec._decoder_stack(cfg, tp, x, enc_out,
                                 torch.arange(S + 1).expand(B, S + 1))
    h = encdec._ln(h, tp["dec_final"], cfg.norm_eps)
    _close(logits[:, 0], h[:, -1] @ tp["embedding"].T, atol=2e-3,
           rtol=1e-3)


def test_decode_from_empty_state_matches_reference(models):
    jcfg, cfg, jp, tp, frames, tokens = models
    state = encdec.init_decode_state(cfg, B, 8, T, torch.float32,
                                     device="cpu")
    jstate = jed.init_decode_state(jcfg, B, 8, T, jnp.float32)
    # the cross K/V of each layer, as prefill makes them
    _, full = encdec.prefill(cfg, tp, {"frames": torch.from_numpy(frames),
                                       "tokens": torch.from_numpy(
                                           tokens[:, :1])})
    state["cross"] = full["cross"]
    jstate["cross"] = tuple(jnp.asarray(c.numpy()) for c in full["cross"])
    for t in range(3):
        tl, state = encdec.decode_step(cfg, tp, torch.from_numpy(
            tokens[:, t:t + 1]), state)
        jl, jstate = jed.decode_step(jcfg, jp, jnp.asarray(
            tokens[:, t:t + 1]), jstate)
        _close(tl, jl)
