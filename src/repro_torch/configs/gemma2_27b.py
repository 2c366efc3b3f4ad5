"""Gemma 2 27B [arXiv:2408.00118]: alternating local(4096)/global attention,
attention + final logit softcapping, GQA, GeGLU, sandwich RMSNorms."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    rope_theta=10000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    window=4096,
    layer_pattern=("swa", "full"),
    act="geglu",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=False,  # global layers are full attention -> skip long_500k
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG)
