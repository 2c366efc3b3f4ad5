"""Mamba2 1.3B [arXiv:2405.21060]: attention-free SSD (state-space duality).
d_inner = 2·d_model = 4096, head_dim 64 -> 64 SSD heads, d_state 128."""
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,              # no attention heads (attn-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG)
