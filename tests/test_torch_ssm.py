"""The port's Mamba2 mixer (``models/ssm.py``) against the reference's on
CPU, on the same numpy weights and inputs: the chunked SSD scan (every
chunk length, grouped heads), ``ssm_mixer`` with its final state at a
length that is not a multiple of the chunk, and ``ssm_decode_step`` from
that state. Bar: the reference's own SSM bar, 2e-4
(``tests/test_ssm_oracle.py``), since the chunked scan sums in other
orders than the reference's einsums."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.configs import registry
from repro_torch.models import ssm

TOL = dict(atol=2e-4, rtol=2e-4)
# the reference's functions, compiled once a shape (eager JAX dispatch
# would spend most of the file's time)
ref_scan = jax.jit(jssm._ssd_chunked, static_argnums=5)
ref_mixer = jax.jit(jssm.ssm_mixer, static_argnums=0,
                    static_argnames="want_state")
ref_step = jax.jit(jssm.ssm_decode_step, static_argnums=0)


def _scan_inputs(B, S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(0.05, 0.5, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((B, S, G, N)).astype(np.float32),
            rng.standard_normal((B, S, G, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("H,G", [(4, 1), (6, 2)], ids=["one-group",
                                                      "grouped"])
def test_ssd_chunked_matches_reference(chunk, H, G):
    args = _scan_inputs(2, 32, H, 8, G, 6)
    want_y, want_h = ref_scan(*map(jnp.asarray, args), chunk)
    got_y, got_h = ssm._ssd_chunked(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def _layer(arch, seed=0):
    """(reference cfg, port cfg, reference params, port params) of one
    SSM layer, perturbed so the zero norms and unit D are exercised."""
    jcfg, cfg = jregistry.get_reduced(arch), registry.get_reduced(arch)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jssm.init_ssm_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    tree = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in tree.items()}
    return (jcfg, cfg, {k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close_state(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
@pytest.mark.parametrize("S", [37, 48, 5])
def test_ssm_mixer_and_final_state_match_reference(arch, S):
    # 37: padded to 48 with dt = 0; 48: three whole chunks; 5: one short
    jcfg, cfg, jp, tp = _layer(arch)
    x = np.random.default_rng(1).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want, wstate = ref_mixer(jcfg, jp, jnp.asarray(x), want_state=True)
    got, state = ssm.ssm_mixer(cfg, tp, torch.from_numpy(x),
                               want_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_state(state, wstate)
    assert torch.equal(ssm.ssm_mixer(cfg, tp, torch.from_numpy(x)), got)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_decode_steps_match_reference(arch):
    jcfg, cfg, jp, tp = _layer(arch, seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, 23, cfg.d_model)).astype(np.float32)
    _, wstate = ref_mixer(jcfg, jp, jnp.asarray(x[:, :20]),
                          want_state=True)
    _, state = ssm.ssm_mixer(cfg, tp, torch.from_numpy(x[:, :20]),
                             want_state=True)
    for t in range(20, 23):
        want, wstate = ref_step(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                wstate)
        got, state = ssm.ssm_decode_step(cfg, tp, torch.from_numpy(
            x[:, t:t + 1]), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close_state(state, wstate)


def test_decode_from_empty_state_matches_the_mixer():
    """Token-by-token recurrence from init_ssm_state == the chunked
    mixer over the same tokens (the port's own consistency)."""
    _, cfg, _, tp = _layer("mamba2-1.3b", seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32))
    want, wstate = ssm.ssm_mixer(cfg, tp, x, want_state=True)
    state = ssm.init_ssm_state(cfg, 2, device="cpu")
    for t in range(x.shape[1]):
        got, state = ssm.ssm_decode_step(cfg, tp, x[:, t:t + 1], state)
        torch.testing.assert_close(got[:, 0], want[:, t], **TOL)
    for g, w in zip(state, wstate):
        torch.testing.assert_close(g, w, **TOL)
