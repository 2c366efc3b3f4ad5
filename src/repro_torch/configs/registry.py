"""Architecture registry (counterpart of ``repro/configs/registry.py``).

The port serves the dense decoder archs whose every feature its modules
cover: qk-norm (qwen3), qkv-bias and padded heads (qwen2.5), attention
and final softcaps, sliding windows, post-norms and embedding scale
(gemma2, h2o-danube). The other archs of the reference need MoE, SSM,
hybrid, encoder-decoder or VLM layers, which are still to port
(ROADMAP queue 1 item 18); asking for one raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

ARCH_MODULES: Dict[str, str] = {
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen2.5-14b": "repro_torch.configs.qwen25_14b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
}
# archs of the reference whose layers the port does not have yet
NOT_PORTED = ("internvl2-2b", "grok-1-314b", "dbrx-132b", "whisper-medium",
              "zamba2-2.7b", "mamba2-1.3b")


def list_archs() -> List[str]:
    return list(ARCH_MODULES)


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: its MoE, SSM, hybrid, "
            f"enc-dec or VLM layers are ROADMAP queue 1 item 18")
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def reduce_common(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a dense config to smoke-test size, keeping its features."""
    base = dict(
        num_layers=len(cfg.layer_pattern) * 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 * cfg.num_kv_heads // cfg.num_heads),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=(32 if cfg.window else None),
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
