"""Capacity-based top-k mixture of experts (counterpart of
``repro/models/moe.py``), on one device.

Tokens sort by assigned expert, land in a static (E, C, D) capacity
buffer (C = T·k/E·capacity_factor, rounded up to 128), the expert MLPs
run as one batched matmul over the expert dim, and results gather back
with the router's combine weights. Overflow drops, as in the reference.
The reference splits the tokens into G = the policy's data-parallel
size dispatch groups; the port executes on a one-rank mesh, where G is
1 with a policy or without, and constrains where the reference does.

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
    counts = torch.bincount(sorted_expert, minlength=E)
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


def moe_mlp(cfg, p, x, policy=None):
    """x (B,S,D) -> (B,S,D), plus the load-balancing auxiliary loss."""
    B, S, D = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    C = capacity(T, cfg)
    act = activation(cfg.act)

    xt = x.reshape(T, D)
    if policy is not None:     # the reference's (G, Tg, D) at G = 1
        xt = policy.constrain(xt[None], (policy.batch(), None, None))[0]
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_vals, expert_ids = top_k(probs, K)                    # (T, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch eq. 4), over all tokens
    density = torch.nn.functional.one_hot(expert_ids[:, 0], E).float() \
        .mean(dim=0)
    aux_loss = E * torch.sum(density * probs.mean(dim=0))

    buf, meta = _group_dispatch(xt, expert_ids, gate_vals, C, E)
    if policy is not None:
        spec = (policy.batch(), policy.ep_axis, None, None)
        buf = policy.constrain(buf[None], spec)[0]
    h = act(torch.bmm(buf, p["moe_gate"])) * torch.bmm(buf, p["moe_up"])
    out_buf = torch.bmm(h, p["moe_down"])
    if policy is not None:
        out_buf = policy.constrain(out_buf[None], spec)[0]
    out = _group_combine(out_buf, meta, T, K)
    if policy is not None:
        out = policy.constrain(out[None], (policy.batch(), None, None))[0]
    return out.reshape(B, S, D).to(x.dtype), aux_loss
