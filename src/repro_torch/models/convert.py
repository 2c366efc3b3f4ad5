"""Carry the reference's parameters across: ``params_from_jax`` takes the
tree that ``repro.models.lm.init_params`` makes, as numpy arrays, and
returns the port's parameters. The two packages' random inits cannot
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
    """The reference's ``lm.init_params`` tree (numpy leaves) → the
    port's parameters, on ``device`` (the CUDA device unless the caller
    passes ``"cpu"``): the leading ``n_groups`` axis of ``"blocks"`` is
    unstacked into a list of per-period dicts."""
    extra = set(tree) - {"embedding", "blocks", "final_norm", "head"}
    if extra:
        raise NotImplementedError(
            f"{cfg.name}: parameters {sorted(extra)} belong to layers not "
            f"ported yet (ROADMAP queue 1 item 18)")
    out = {k: _tensor(v, device) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_map(tree["blocks"], lambda a, g=g: _tensor(a[g],
                                                                 device))
                     for g in range(n_groups(cfg))]
    return out
