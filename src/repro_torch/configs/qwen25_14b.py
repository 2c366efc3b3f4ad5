"""Qwen2.5 14B [hf:Qwen/Qwen2.5-*]: GQA with QKV bias, SwiGLU, RMSNorm."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    pad_heads_to=48,     # 40 ∤ 16-way TP; padded heads are zero-masked

    d_ff=13824,
    vocab_size=152064,
    rope_theta=1000000.0,
    qkv_bias=True,
    layer_pattern=("full",),
    act="silu",
    subquadratic=False,
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG)
