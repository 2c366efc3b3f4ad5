"""Zamba2 2.7B [arXiv:2411.15242]: Mamba2 backbone with a *shared*
attention+MLP block invoked every 6th layer on concat(hidden, embeddings)
through a per-use fuse projection. long_500k decode keeps the shared
block's KV cache sequence-sharded over the idle data axis."""
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,          # MHA in the shared block
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    rope_theta=10000.0,
    layer_pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "hybrid"),
    act="gelu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    attn_every=6,
    tie_embeddings=True,
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG, num_layers=6)
