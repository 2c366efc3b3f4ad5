"""Whisper medium [arXiv:2212.04356]: 24+24 enc-dec, MHA, plain GELU MLP,
LayerNorm. The conv audio frontend is a STUB — input_specs() provides
precomputed frame embeddings (B, T, d_model)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs import registry

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,            # per stack
    encoder_layers=24,
    decoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,          # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    qkv_bias=True,
    layer_pattern=("full",),
    act="gelu",
    norm_eps=1e-5,
    tie_embeddings=True,
    frontend="audio_stub",
    max_source_positions=1500,
    subquadratic=False,
)


def reduced() -> ModelConfig:
    return registry.reduce_common(CONFIG)
