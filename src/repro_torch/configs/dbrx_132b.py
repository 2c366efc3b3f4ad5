"""DBRX 132B [hf:databricks/dbrx-base]: fine-grained 16-expert top-4 MoE.

MoE sharding mode "ep": E=16 equals the model axis, so experts shard one
per model-axis slice and token dispatch becomes the EP all-to-all."""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500000.0,
    layer_pattern=("full",),
    act="silu",
    moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25, mode="ep"),
    subquadratic=False,
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG)
