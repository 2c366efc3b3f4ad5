"""InternVL2 2B [arXiv:2404.16821]: InternLM2-1.8B language backbone; the
InternViT vision frontend is a STUB (input_specs() provides precomputed,
pixel-shuffled patch embeddings) per the assignment."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1000000.0,
    layer_pattern=("full",),
    act="silu",
    frontend="vit_stub",
    num_patches=256,
    subquadratic=False,
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG, num_patches=8)
