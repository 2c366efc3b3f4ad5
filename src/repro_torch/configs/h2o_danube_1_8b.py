"""H2O-Danube 1.8B [arXiv:2401.16818]: llama+mistral mix with sliding-window
attention — the SWA rolling cache makes long_500k decoding O(window)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    rope_theta=10000.0,
    window=4096,
    layer_pattern=("swa",),
    act="silu",
    subquadratic=True,   # pure SWA -> long_500k runs with rolling cache
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG)
