"""Train-step factory: microbatch gradient accumulation, remat, mixed
precision, optimizer apply, in-situ hook point (counterpart of
``repro/train/step.py``).

``train_step(state, batch)`` takes the gradient through the float32
master parameters cast to ``compute_dtype`` (bfloat16 by default, as in
the reference): the cast copy's leaves are the leaves autograd
differentiates, so the gradients come in ``compute_dtype``. With
``microbatches`` > 1 the batch splits along its leading axis, the
microbatches' gradients are summed in float32 and divided by their
count. The optimizer then updates the float32 masters in place
(``optim/adamw.py``). The model runs under the step's sharding policy,
so attention takes the plain paths (the flash kernel has no backward).

In-situ integration (the paper's technique as a first-class feature):
``insitu_chain`` is an optional hook (``InSituChain.as_step_hook()``,
core/insitu/chain.py) run on the step's tensors — spectral gradient
monitoring on the device with no host round trip — every
``insitu_every`` steps; its small outputs go in ``metrics["insitu"]``.
It sees the step's gradients before the optimizer clips them and the
parameters before they update, as in the reference. On the other steps
it is skipped and ``metrics["insitu"]`` holds zeros of the same keys,
shapes and dtypes (the reference's ``lax.cond`` skip branch: its
``jax.eval_shape`` of the hook is the hook run here on ``meta``
tensors, so the hook must be a function of its payload alone).

State: ``{"params", "opt": {"m", "v", "count"}, "step"}``, the
reference's tree; ``count`` and ``step`` are host int32 scalars.

Across ranks (a policy off a one-rank mesh) the state's leaves are this
rank's blocks (``init_train_state(..., policy=)``, ``state_shardings``)
and the batch is this rank's rows of the global batch
(``data.pipeline.ShardedLoader``). The gradient reductions run inside
the backward, each where its forward collective stands
(``Policy.use``, ``sharding/collectives.py``): the FSDP leaves'
gradients reduce-scatter over the data axis, the leaves replicated over
it all-reduce (DP), and a leaf replicated over the model axis but used
on the local heads all-reduces over it (``enter_tp``); every gradient
leaf is then this rank's block of the whole model's gradient. The
microbatches are the reference's: microbatch i is rows [i·B/M,
(i+1)·B/M) of the global batch, so the step gathers the rows and cuts
each microbatch over the data ranks again. The in-step monitor reads
the whole leaves it names (``hook.reads``), gathered for it; the
optimizer's clipping norm sums over every block (``AdamW.update``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models import encdec, lm
from repro_torch.models.common import ShapeOnly
from repro_torch.sharding.policy import sharded, spec_leaves
from repro_torch.tree_util import (tree_leaves, tree_leaves_with_path,
                                   tree_map, tree_unflatten)


def model_loss_fn(cfg):
    return encdec.loss_fn if cfg.family == "encdec" else lm.loss_fn


def cast_params(params, dtype):
    return tree_map(
        lambda p: p.to(dtype) if p.dtype in (torch.float32, torch.bfloat16)
        else p, params)


def _meta(tree):
    return tree_map(lambda t: torch.empty_like(t, device="meta")
                    if torch.is_tensor(t) else t, tree)


def hook_shapes(hook: Callable, payload: Dict[str, Any]):
    """The keys, shapes and dtypes ``hook(payload)`` returns, from one
    run of the hook on ``meta`` tensors."""
    return {k: (v.shape, v.dtype) for k, v in hook(_meta(payload)).items()}


def make_train_step(cfg, policy, opt, *, microbatches: int = 1,
                    remat_policy=None, loss_chunk: int = 512,
                    compute_dtype=torch.bfloat16,
                    insitu_chain: Optional[Callable] = None,
                    insitu_every: int = 1) -> Callable:
    loss_fn = model_loss_fn(cfg)
    skip_shapes = {}           # the hook's outputs, from its first skip
    multi = sharded(policy)
    if multi:
        shapes = train_state_shapes(cfg, opt)["params"]
        specs = policy.tree_specs(shapes)

    def value_and_grad(params_c, mb):
        """(loss, metrics, grads) of ``loss_fn`` at ``params_c``; grads in
        the leaves' dtype, zeros where a leaf takes no part."""
        leaves = tree_leaves(params_c)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, params_c, mb, policy, remat=True,
                                    remat_policy=remat_policy,
                                    loss_chunk=loss_chunk)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params_c, grads)

    def split_micro(batch, i):
        def sp(x):
            if multi:          # the global rows, cut again below
                x = policy.gather(x, policy.act_rows(x.dim()))
            B = x.shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            x = x[i * n:(i + 1) * n]
            return policy.named(policy.act_rows(x.dim()))(x) if multi else x
        return {k: sp(v) for k, v in batch.items()}

    def monitor_payload(grads, params):
        """The hook's payload; across ranks each leaf it reads gathered
        whole, the others left out (None)."""
        payload = {"grads": grads, "params": params}
        if not multi:
            return payload
        for source, selected in getattr(insitu_chain, "reads", ()):
            keep = set(selected(shapes))
            whole = [policy.gather(leaf, spec) if path in keep else None
                     for (path, leaf), spec in
                     zip(tree_leaves_with_path(payload[source]),
                         spec_leaves(specs))]
            payload[source] = tree_unflatten(shapes, whole)
        return payload

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params_c = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()),
            cast_params(state["params"], compute_dtype))

        if microbatches == 1:
            loss, metrics, grads = value_and_grad(params_c, batch)
        else:
            g_acc = None
            loss_sum = torch.zeros((), dtype=torch.float32)
            for i in range(microbatches):
                l, _m, g = value_and_grad(params_c, split_micro(batch, i))
                g = [t.float() for t in tree_leaves(g)]
                g_acc = g if g_acc is None else [
                    a.add_(b) for a, b in zip(g_acc, g)]
                loss_sum = loss_sum.to(l.device) + l
            grads = tree_unflatten(params_c,
                                   [g / microbatches for g in g_acc])
            loss = loss_sum / microbatches
            metrics = {"loss": loss}
        del params_c
        metrics = dict(metrics)

        if insitu_chain is not None:
            # the in-situ chain over the step's device tensors, every
            # `insitu_every` steps; zeros of its outputs otherwise
            payload = dict(monitor_payload(grads, state["params"]),
                           step=state["step"])
            if int(state["step"]) % insitu_every == 0:
                metrics["insitu"] = insitu_chain(payload)
            else:
                if not skip_shapes:
                    skip_shapes.update(hook_shapes(insitu_chain, payload))
                device = tree_leaves(grads)[0].device
                metrics["insitu"] = {
                    k: torch.zeros(shape, dtype=dtype, device=device)
                    for k, (shape, dtype) in skip_shapes.items()}

        new_params, new_opt, opt_metrics = opt.update(
            grads, state["opt"], state["params"],
            **({"policy": policy, "specs": specs} if multi else {}))
        metrics.update(opt_metrics)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def _init_params(cfg, gen, param_dtype, max_target, policy=None):
    if cfg.family == "encdec":
        return encdec.init_params(cfg, gen, param_dtype,
                                  max_target=max_target, policy=policy)
    return lm.init_params(cfg, gen, param_dtype, policy=policy)


def init_train_state(cfg, opt, gen, *, param_dtype=torch.float32,
                     max_target: int = 448, policy=None):
    """A fresh train state: parameters drawn from ``gen`` (a
    ``torch.Generator`` seeded by the caller) on its device, zero
    optimizer moments, step 0. With a ``policy`` across ranks, this
    rank's blocks of the one-rank init's values."""
    params = _init_params(cfg, gen, param_dtype, max_target, policy)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def train_state_shapes(cfg, opt, *, param_dtype=torch.float32,
                       max_target: int = 448):
    """The train state's tree with ``meta`` tensors (shapes and dtypes,
    no memory) in its parameter and moment leaves."""
    params = _init_params(cfg, ShapeOnly(), param_dtype, max_target)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _host_scalar(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr))


def state_gathers(policy, state_shapes):
    """The whole train state's gathers (a ``ckpt.save(gather=)`` tree of
    per-leaf callables taking this rank's block to the whole leaf;
    collective), the scalars as they are."""
    def whole(x):
        return x
    return {
        "params": policy.tree_gathers(state_shapes["params"]),
        "opt": {
            "m": policy.tree_gathers(state_shapes["opt"]["m"]),
            "v": policy.tree_gathers(state_shapes["opt"]["v"]),
            "count": whole,
        },
        "step": whole,
    }


def state_shardings(policy, state_shapes):
    """The whole train state's placement (a ``state_place`` tree of
    per-leaf callables for ``ckpt.restore``/``run_with_restarts``): the
    parameter rules apply to ``m``/``v`` too; the scalars stay on the
    host."""
    return {
        "params": policy.tree_shardings(state_shapes["params"]),
        "opt": {
            "m": policy.tree_shardings(state_shapes["opt"]["m"]),
            "v": policy.tree_shardings(state_shapes["opt"]["v"]),
            "count": _host_scalar,
        },
        "step": _host_scalar,
    }
