"""Carry the reference's parameters across: ``params_from_jax`` takes the
tree that ``repro.models.lm.init_params`` (or ``encdec.init_params``)
makes, as numpy arrays, and returns the port's parameters;
``train_state_from_jax`` does the same for a whole train state
(``repro.train.step.init_train_state``'s tree). The two packages'
random inits cannot match, so the parity tests build weights once and
hand them to both.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.blocks import n_groups
from repro_torch.sharding.policy import sharded


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _host(a) -> torch.Tensor:
    return _tensor(a, "cpu")


def params_from_jax(cfg, tree: Dict[str, Any], *, device="cuda",
                    policy=None) -> Dict[str, Any]:
    """The reference's ``lm.init_params`` or ``encdec.init_params`` tree
    (numpy leaves) → the port's parameters, on ``device`` (the CUDA
    device unless the caller passes ``"cpu"``): the leading depth axis
    of ``"blocks"`` (``n_groups``), ``"enc_layers"`` and
    ``"dec_layers"`` is unstacked into a list of per-period (per-layer)
    dicts; every other leaf (``shared``, ``patch_proj``, SSM and MoE
    weights among them) is carried as it is. With a ``policy`` across
    ranks, each leaf is this rank's block of it."""
    depth = {"blocks": n_groups(cfg) if cfg.family != "encdec" else 0,
             "enc_layers": cfg.encoder_layers,
             "dec_layers": cfg.decoder_layers}
    out = {}
    for key, sub in tree.items():
        if key in depth:
            out[key] = [_map(sub, lambda a, g=g: a[g])
                        for g in range(depth[key])]
        else:
            out[key] = sub
    if sharded(policy):
        out = policy.shard_tree(_map(out, _host))
        return _map(out, lambda t: t.to(device))
    return _map(out, lambda a: _tensor(a, device))


def train_state_from_jax(cfg, state: Dict[str, Any], *, device="cuda",
                         policy=None) -> Dict[str, Any]:
    """The reference's train state ``{"params", "opt": {"m", "v",
    "count"}, "step"}`` (numpy leaves) → the port's: parameters and
    moments on ``device`` in the port's layout (this rank's blocks with
    a ``policy`` across ranks), ``count`` and ``step`` as host int32
    scalars (``train/step.py``)."""
    def scalar(a):
        return torch.from_numpy(np.array(a, dtype=np.int32))
    opt = state["opt"]

    def conv(tree):
        return params_from_jax(cfg, tree, device=device, policy=policy)
    return {"params": conv(state["params"]),
            "opt": {"m": conv(opt["m"]), "v": conv(opt["v"]),
                    "count": scalar(opt["count"])},
            "step": scalar(state["step"])}
