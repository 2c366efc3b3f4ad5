"""Qwen3 4B [hf:Qwen/Qwen3-*]: GQA with per-head q/k RMSNorm, SwiGLU."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    rope_theta=1000000.0,
    qk_norm=True,
    layer_pattern=("full",),
    act="silu",
    subquadratic=False,
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG)
