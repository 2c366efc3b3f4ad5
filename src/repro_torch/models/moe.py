"""Capacity-based top-k mixture of experts (counterpart of
``repro/models/moe.py``).

Tokens sort by assigned expert, land in a static (E, C, D) capacity
buffer (C = T·k/E·capacity_factor, rounded up to 128), the expert MLPs
run as one batched matmul over the expert dim, and results gather back
with the router's combine weights. Overflow drops, as in the reference.
As in the reference the tokens split into G = the policy's
data-parallel size dispatch groups (1 without a policy, and where G
does not divide the tokens), each with its own capacity; ``groups=``
sets G on one rank (the reference's grouping, to hold a run across
ranks against).

Across ranks a group is one data rank's tokens, replicated over the
model axis (the reference's ``xt`` spec), so routing and dispatch run
on the rank without communication. Tensor-parallel experts (grok) take
this rank's block of the expert hidden dim: the buffer enters the
column-parallel gate/up products through ``enter_tp`` and the down
product is a partial sum, summed over the model axis. Expert-parallel
experts (dbrx, ``ep_mode``) take this rank's block of the experts: the
buffer is cut to them and the outputs gathered back over the model
axis, which is what the buffer specs (E over the model axis, tokens
replicated on it) lower to; the load-balancing loss sums its token
counts over the data axis.

Where the reference's XLA ops and PyTorch's differ, the port pins the
reference's semantics: the sort by expert is stable (``jnp.argsort``
is), the top-k breaks ties towards the lower expert index
(``jax.lax.top_k`` does), and the combine sums each token's K
contributions in a fixed order (a gather to (T, K, D) and a sum over K,
not an atomic scatter-add), so that a run repeats bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init
from repro_torch.sharding.policy import P, sharded


def init_moe_params(cfg, gen, dtype):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": dense_init(gen, (d, e), dtype, fan_in=d),
        "moe_gate": dense_init(gen, (e, d, f), dtype, fan_in=d),
        "moe_up": dense_init(gen, (e, d, f), dtype, fan_in=d),
        "moe_down": dense_init(gen, (e, f, d), dtype, fan_in=f),
    }


def capacity(tokens_per_group: int, cfg) -> int:
    c = int(tokens_per_group * cfg.moe.top_k * cfg.moe.capacity_factor
            // cfg.moe.num_experts)
    return max(c + (-c) % 128, 128)      # round up to a multiple of 128


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, ties to
    the lower index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_dispatch(xt, expert_ids, gate_vals, C: int, E: int):
    """xt (T, D) · expert_ids (T, K) · gate_vals (T, K) -> buf (E, C, D),
    plus the metadata of the combine."""
    T, K = expert_ids.shape
    dev = xt.device
    flat_expert = expert_ids.reshape(-1)
    flat_token = torch.arange(T, device=dev).repeat_interleave(K)
    flat_gate = gate_vals.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]

    # rank of each pick among its expert's picks (the reference's
    # cumsum of one-hots): its place in the sorted run of that expert
    # (a scatter of ones, not bincount: its E bins are a static shape,
    # so the dispatch traces on fake tensors, launch/dryrun.py)
    counts = torch.zeros(E, dtype=sorted_expert.dtype,
                         device=dev).scatter_add_(
        0, sorted_expert, torch.ones_like(sorted_expert))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_expert = (torch.arange(T * K, device=dev)
                     - starts[sorted_expert])
    keep = pos_in_expert < C

    scatter_e = torch.where(keep, sorted_expert, E - 1)
    scatter_c = torch.where(keep, pos_in_expert, C - 1)
    contrib = torch.where(keep[:, None], xt[sorted_token], 0)
    # kept picks own distinct (e, c) slots; dropped ones write zeros to a
    # spare row, so a plain copy gives the reference's scatter-add
    slot = torch.where(keep, scatter_e * C + scatter_c, E * C)
    buf = xt.new_zeros((E * C + 1, xt.shape[-1]))
    buf.index_copy_(0, slot, contrib.to(xt.dtype))
    return (buf[:E * C].view(E, C, -1),
            (scatter_e, scatter_c, order, sorted_gate, keep))


def _group_combine(out_buf, meta, T: int, K: int):
    scatter_e, scatter_c, order, sorted_gate, keep = meta
    gathered = out_buf[scatter_e, scatter_c]                   # (TK, D)
    gathered = torch.where(keep[:, None], gathered, 0)
    weighted = gathered.float() * sorted_gate[:, None]
    # back to (token, pick) order, then each token's K picks in order
    unsorted = torch.empty_like(weighted)
    unsorted[order] = weighted
    return unsorted.view(T, K, -1).sum(dim=1)


def moe_mlp(cfg, p, x, policy=None, *, groups=None):
    """x (B,S,D) -> (B,S,D), plus the load-balancing auxiliary loss.
    ``groups`` overrides G (one rank only)."""
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    multi = sharded(policy)
    if groups is not None and multi:
        raise ValueError("moe_mlp: groups= is for one rank; across ranks G "
                         "is the data-parallel size")
    T = B * S * (policy.dp_size if multi else 1)      # the global tokens
    G = groups or (policy.dp_size if policy is not None else 1)
    if T % G:
        G = 1
    Tg = T // G
    local = (B * S) // Tg            # groups on this rank
    C = capacity(Tg, cfg)
    act = activation(cfg.act)

    xt = x.reshape(local, Tg, D)
    if policy is not None:
        xt = policy.constrain(xt, (policy.batch(), None, None))
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                  # (G, Tg, E)
    gate_vals, expert_ids = top_k(probs, K)                # (G, Tg, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch eq. 4), over all tokens
    top1 = torch.nn.functional.one_hot(expert_ids[..., 0], E).float()
    if multi:                  # token counts summed over the data axis
        density = policy.reduce_batch(top1.sum(dim=(0, 1))) / T
        router_mean = policy.reduce_batch(probs.sum(dim=(0, 1))) / T
    else:
        density, router_mean = top1.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
    aux_loss = E * torch.sum(density * router_mean)

    parts = [_group_dispatch(xt[g], expert_ids[g], gate_vals[g], C, E)
             for g in range(local)]
    buf = torch.stack([b for b, _ in parts])               # (G, E, C, D)
    spec = ((policy.batch(), policy.ep_axis, None, None)
            if policy is not None else None)
    whole = P(policy.batch(), None, None, None) if policy is not None \
        else None
    if policy is not None:
        if multi and policy.ep_axis:       # this rank's experts
            buf = policy.constrain(buf, spec, src=whole)
        else:
            buf = policy.constrain(buf, spec)
    if multi and not policy.ep_axis:       # TP experts: column-parallel
        buf = policy.enter_tp(buf)
    wg, wu, wd = p["moe_gate"], p["moe_up"], p["moe_down"]
    h = act(_expert_mm(buf, wg)) * _expert_mm(buf, wu)
    out_buf = _expert_mm(h, wd)
    if policy is not None:
        if multi and policy.ep_axis:       # every expert back
            out_buf = policy.constrain(out_buf, whole, src=spec)
        else:
            out_buf = policy.constrain(out_buf, spec,
                                       partial=None if policy.ep_axis
                                       else policy.tp_axis)
    out = torch.stack([_group_combine(out_buf[g], parts[g][1], Tg, K)
                       for g in range(local)])
    if policy is not None:
        out = policy.constrain(out, (policy.batch(), None, None))
    return out.reshape(B, S, D).to(x.dtype), aux_loss


def _expert_mm(buf, w):
    """(G, E, C, a) · (E, a, b) -> (G, E, C, b), one batched matmul a
    group."""
    return torch.stack([torch.bmm(b, w) for b in buf])
