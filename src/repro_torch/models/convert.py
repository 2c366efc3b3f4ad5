"""Carry the reference's parameters across: ``params_from_jax`` takes the
tree that ``repro.models.lm.init_params`` (or ``encdec.init_params``)
makes, as numpy arrays, and returns the port's parameters. The two packages' random inits cannot
match, so the parity tests build weights once and hand them to both.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.blocks import n_groups


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg, tree: Dict[str, Any], *,
                    device="cuda") -> Dict[str, Any]:
    """The reference's ``lm.init_params`` or ``encdec.init_params`` tree
    (numpy leaves) → the port's parameters, on ``device`` (the CUDA
    device unless the caller passes ``"cpu"``): the leading depth axis
    of ``"blocks"`` (``n_groups``), ``"enc_layers"`` and
    ``"dec_layers"`` is unstacked into a list of per-period (per-layer)
    dicts; every other leaf (``shared``, ``patch_proj``, SSM and MoE
    weights among them) is carried as it is."""
    depth = {"blocks": n_groups(cfg) if cfg.family != "encdec" else 0,
             "enc_layers": cfg.encoder_layers,
             "dec_layers": cfg.decoder_layers}
    out = {}
    for key, sub in tree.items():
        if key in depth:
            out[key] = [_map(sub, lambda a, g=g: _tensor(a[g], device))
                        for g in range(depth[key])]
        else:
            out[key] = _map(sub, lambda a: _tensor(a, device))
    return out
