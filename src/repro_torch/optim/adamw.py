"""AdamW with a warmup+cosine schedule and global-norm clipping
(counterpart of ``repro/optim/adamw.py``).

Optimizer state mirrors the parameter tree (``m``/``v`` in float32), so
the policy's parameter placements apply to it verbatim. Master
parameters are float32; the train step takes a ``compute_dtype`` copy
for the forward and backward (mixed precision).

The update runs under ``torch.no_grad()`` and writes ``m``, ``v`` and
the parameters in place (the reference returns new arrays and its jit
donates the old ones: the same memory, without a second copy of the
state), in groups of leaves through PyTorch's multi-tensor
(``_foreach``) operations, with the reference's float32 arithmetic:
gradients upcast before clipping, bias corrections ``1 - b ** count``
in float32, decoupled weight decay, the result cast back to each
parameter's dtype. ``count`` is a host int32 scalar, so the schedule
and the corrections are computed on the host without a device sync.

Across ranks every leaf is this rank's block and the update is
elementwise on it; only the clipping norm needs the other ranks:
``update(..., policy=, specs=)`` takes it as the sum of squares over
every block, each leaf counted once (``global_norm``'s ``axes``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.sharding import collectives as C
from repro_torch.sharding.policy import _names, spec_leaves
from repro_torch.tree_util import tree_leaves, tree_map


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1) -> Callable:
    """step -> learning rate (a float32 scalar tensor): linear warmup to
    ``peak_lr``, then cosine decay to ``floor_frac * peak_lr``."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (step + 1) / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return schedule


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0

    def init(self, params) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32)}

    def update(self, grads, state, params, *, policy=None, specs=None):
        """One step. ``grads`` and ``params`` are trees of one structure;
        ``state`` is ``init``'s. Returns (params, state, metrics), the
        first two being the inputs' tensors updated in place (``count``
        anew); metrics hold ``grad_norm`` (a device scalar, before
        clipping) and ``lr``. Across ranks ``policy`` and the leaves'
        ``specs`` (a tree of the same structure) make the norm the
        whole model's."""
        count = state["count"] + 1
        cf = count.to(torch.float32)
        lr = self.schedule(count - 1)
        # float32 host scalars, as Python floats (exact): the kernels take
        # them as float32 scalars, so nothing waits for the device
        lr_f = float(lr)
        bc1 = float(1 - _f32(self.b1) ** cf)
        bc2 = float(1 - _f32(self.b2) ** cf)
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            gs, ps = tree_leaves(grads), tree_leaves(params)
            ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
            gnorm = global_norm(gs, policy=policy,
                                specs=None if specs is None
                                else spec_leaves(specs))
            scale = None if self.grad_clip is None else torch.clamp(
                self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            for idx in _groups(ps):
                p, m, v = ([t[i] for i in idx] for t in (ps, ms, vs))
                g = [gs[i].float() for i in idx]
                if scale is not None:
                    g = torch._foreach_mul(g, scale)
                torch._foreach_mul_(m, b1)
                torch._foreach_add_(m, g, alpha=1 - b1)
                torch._foreach_mul_(v, b2)
                torch._foreach_addcmul_(v, g, g, value=1 - b2)
                del g
                denom = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, self.eps)
                step = torch._foreach_div(m, bc1)
                torch._foreach_div_(step, denom)
                del denom
                torch._foreach_add_(step, [t.float() for t in p],
                                    alpha=self.weight_decay)
                torch._foreach_mul_(step, lr_f)
                if all(t.dtype == torch.float32 for t in p):
                    torch._foreach_sub_(p, step)
                else:
                    for t, u in zip(p, step):
                        t.copy_(t.float() - u)
        return params, {"m": state["m"], "v": state["v"], "count": count}, \
            {"grad_norm": gnorm, "lr": lr}


# leaves updated together: one multi-tensor launch a group instead of one
# a leaf, the temporaries bounded (2^28 elements, 1 GiB of float32)
GROUP_ELEMENTS = 1 << 28


def _groups(leaves):
    """Consecutive index groups of ``leaves``, each of at most
    GROUP_ELEMENTS elements (a larger leaf alone)."""
    group, n = [], 0
    for i, t in enumerate(leaves):
        if group and n + t.numel() > GROUP_ELEMENTS:
            yield group
            group, n = [], 0
        group.append(i)
        n += t.numel()
    if group:
        yield group


def global_norm(tree, *, policy=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in float32
    (each leaf's norm by one multi-tensor launch). Across ranks
    (``policy`` off a one-rank mesh, ``specs`` the leaves' specs in
    leaf order) each leaf is a block: the squares are summed over the
    axes its spec shards it on, and nowhere else, so a leaf replicated
    on an axis counts once."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    if policy is None or policy.one_rank:
        return torch.linalg.vector_norm(torch.stack(norms))
    by_axes = {}
    for n, spec in zip(norms, specs):
        axes = tuple(sorted({a for e in spec for a in _names(e)
                             if policy.size(a) > 1}))
        by_axes.setdefault(axes, []).append(n)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for axes, ns in sorted(by_axes.items()):
        sq = torch.stack(ns).square().sum()
        for a in axes:
            sq = C._all_reduce(sq, policy._group(a))
        total = total + sq
    return torch.sqrt(total)
