"""The port's mixture of experts (``models/moe.py``) against the
reference's on CPU, on the same numpy weights and inputs: the capacity
rule, ``moe_mlp`` at reduced grok-1 and dbrx (nothing dropped, and a
tight capacity that drops tokens: the same tokens dropped), the aux
loss, a router with ties, and two runs bit-identical. Bar: atol 1e-5 /
rtol 1e-4, float32 products summed in other orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import moe as jmoe
from repro_torch.configs import registry
from repro_torch.models import moe
from repro_torch.models.common import activation

TOL = dict(atol=1e-5, rtol=1e-4)


def _cfgs(arch, cf=None):
    jcfg, cfg = jregistry.get_reduced(arch), registry.get_reduced(arch)
    if cf is not None:
        jcfg, cfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
            for c in (jcfg, cfg))
    return jcfg, cfg


def _params(jcfg, seed=0):
    tree = jax.tree.map(np.array, jmoe.init_moe_params(
        jcfg, jax.random.PRNGKey(seed), jnp.float32))
    return tree, {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _x(cfg, B, S, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("arch", ["grok-1-314b", "dbrx-132b"])
@pytest.mark.parametrize("T", [1, 64, 200, 4096, 40000])
def test_capacity_matches_reference(arch, T):
    jcfg, cfg = _cfgs(arch)
    assert moe.capacity(T, cfg) == jmoe.capacity(T, jcfg)
    full = registry.get_config(arch)
    assert moe.capacity(T, full) == jmoe.capacity(
        T, jregistry.get_config(arch))


@pytest.mark.parametrize("arch", ["grok-1-314b", "dbrx-132b"])
@pytest.mark.parametrize("cf", [None, 0.05], ids=["default", "tight"])
def test_moe_mlp_matches_reference(arch, cf):
    jcfg, cfg = _cfgs(arch, cf)
    tree, p = _params(jcfg)
    x = _x(cfg, 4, 96)
    want, want_aux = jmoe.moe_mlp(jcfg, tree, jnp.asarray(x))
    got, aux = moe.moe_mlp(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ["grok-1-314b", "dbrx-132b"])
def test_tight_capacity_drops_the_same_tokens(arch):
    # 384 tokens, 2 picks each over 4 experts against C = 128: picks drop
    jcfg, cfg = _cfgs(arch, 0.05)
    tree, p = _params(jcfg, seed=2)
    x = _x(cfg, 4, 96, seed=3).reshape(-1, cfg.d_model)
    T, E, K = x.shape[0], cfg.moe.num_experts, cfg.moe.top_k
    C = moe.capacity(T, cfg)
    probs = jax.nn.softmax(jnp.asarray(x) @ tree["router"], -1)
    gates, ids = jax.lax.top_k(probs, K)
    gates = gates / gates.sum(-1, keepdims=True)
    _, (je, jc, jtok, jgate, jkeep) = jmoe._group_dispatch(
        jnp.asarray(x), ids, gates, C, E)
    _, (te, tc, order, tgate, tkeep) = moe._group_dispatch(
        torch.from_numpy(x), torch.from_numpy(np.array(ids)).long(),
        torch.from_numpy(np.array(gates)), C, E)
    assert 0 < int((~tkeep).sum()) < T * K          # some, not all, drop
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(
        (torch.arange(T).repeat_interleave(K)[order]).numpy(),
        np.asarray(jtok))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_router_ties_break_to_the_lower_expert():
    jcfg, cfg = _cfgs("grok-1-314b", 8.0)
    tree, p = _params(jcfg, seed=4)
    # experts 1 and 2 get the same router column: every token's
    # probabilities tie between them
    tree["router"][:, 2] = tree["router"][:, 1]
    p["router"][:, 2] = p["router"][:, 1]
    x = _x(cfg, 2, 64, seed=5)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model))
                           @ tree["router"], -1)
    want_v, want_i = jax.lax.top_k(probs, 2)
    got_v, got_i = moe.top_k(torch.from_numpy(np.array(probs)), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert (np.asarray(probs)[:, 1] == np.asarray(probs)[:, 2]).all()
    want, want_aux = jmoe.moe_mlp(jcfg, tree, jnp.asarray(x))
    got, aux = moe.moe_mlp(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_no_drop_matches_per_expert_oracle():
    """Every expert applied to every token, weighted by the normalised
    top-k gates: what the capacity buffer computes when nothing drops."""
    _, cfg = _cfgs("dbrx-132b", 16.0)
    gen = torch.Generator().manual_seed(6)
    p = moe.init_moe_params(cfg, gen, torch.float32)
    x = torch.from_numpy(_x(cfg, 2, 40, seed=7))
    got, _ = moe.moe_mlp(cfg, p, x)
    xt = x.reshape(-1, cfg.d_model)
    gates, ids = moe.top_k(torch.softmax(xt @ p["router"], -1),
                           cfg.moe.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    act = activation(cfg.act)
    want = torch.zeros_like(xt)
    for e in range(cfg.moe.num_experts):
        y = (act(xt @ p["moe_gate"][e]) * (xt @ p["moe_up"][e])) \
            @ p["moe_down"][e]
        want += (gates * (ids == e)).sum(-1, keepdim=True) * y
    torch.testing.assert_close(got, want.reshape(x.shape), **TOL)


def test_two_runs_are_bit_identical():
    jcfg, cfg = _cfgs("grok-1-314b", 0.05)
    _, p = _params(jcfg, seed=8)
    x = torch.from_numpy(_x(cfg, 4, 96, seed=9))
    a, aux_a = moe.moe_mlp(cfg, p, x)
    b, aux_b = moe.moe_mlp(cfg, p, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
