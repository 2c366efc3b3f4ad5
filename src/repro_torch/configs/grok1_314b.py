"""Grok-1 314B [hf:xai-org/grok-1]: 8-expert top-2 MoE, GQA, logit caps.

MoE sharding mode "tp": E=8 does not divide the 16-way model axis, so
expert weights are tensor-parallel (F over model) and FSDP over data —
see sharding/policy.py."""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    rope_theta=10000.0,
    attn_softcap=30.0,
    final_softcap=30.0,
    layer_pattern=("full",),
    act="gelu",
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25, mode="tp"),
    subquadratic=False,
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG)
