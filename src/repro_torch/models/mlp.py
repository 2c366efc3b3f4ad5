"""Gated (SwiGLU/GeGLU) and plain MLP blocks (counterpart of
``repro/models/mlp.py``)."""
from __future__ import annotations

from repro_torch.models.common import activation, dense_init


def init_mlp_params(cfg, gen, dtype, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_up": dense_init(gen, (d, f), dtype, fan_in=d),
        "w_down": dense_init(gen, (f, d), dtype, fan_in=f),
    }
    if cfg.act in ("silu", "geglu"):
        p["w_gate"] = dense_init(gen, (d, f), dtype, fan_in=d)
    return p


def mlp(cfg, p, x):
    act = activation(cfg.act)
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if "w_gate" in p else act(up)
    return h @ p["w_down"]
