"""Gated (SwiGLU/GeGLU) and plain MLP blocks (counterpart of
``repro/models/mlp.py``).

Across ranks the gate and up projections are column-parallel (this
rank's block of the hidden dim; the input enters through ``enter_tp``)
and the down projection row-parallel: its product is a partial sum,
summed over the model axis."""
from __future__ import annotations

from repro_torch.models.common import activation, dense_init
from repro_torch.sharding.policy import sharded


def init_mlp_params(cfg, gen, dtype, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_up": dense_init(gen, (d, f), dtype, fan_in=d),
        "w_down": dense_init(gen, (f, d), dtype, fan_in=f),
    }
    if cfg.act in ("silu", "geglu"):
        p["w_gate"] = dense_init(gen, (d, f), dtype, fan_in=d)
    return p


def mlp(cfg, p, x, policy=None):
    act = activation(cfg.act)
    if sharded(policy):
        x = policy.enter_tp(x)
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if "w_gate" in p else act(up)
    if policy is not None:
        h = policy.constrain(h, policy.act_mlp())
    out = h @ p["w_down"]
    if policy is not None:
        out = policy.constrain(out, policy.act_hidden(),
                               partial=policy.tp_axis)
    return out
