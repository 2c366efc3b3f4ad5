"""Architecture registry (counterpart of ``repro/configs/registry.py``).

Every arch of the reference: the dense decoders (qwen3, qwen2.5,
gemma2, h2o-danube), the VLM (internvl2, a stub vision frontend), the
MoE decoders (grok-1, dbrx), the SSM and hybrid stacks (mamba2, zamba2)
and the encoder-decoder (whisper, served through ``models/encdec.py``).
Each module exposes ``CONFIG`` (the published configuration) and
``reduced()`` (a tiny same-family config for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ARCH_MODULES: Dict[str, str] = {
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen2.5-14b": "repro_torch.configs.qwen25_14b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
}


def list_archs() -> List[str]:
    return list(ARCH_MODULES)


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def cells(arch: str) -> List[ShapeConfig]:
    """The dry-run cells for one arch. ``long_500k`` runs only for
    sub-quadratic archs (SSM / hybrid / SWA), as in the reference."""
    cfg = get_config(arch)
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out


def all_cells() -> List[tuple]:
    return [(a, s.name) for a in list_archs() for s in cells(a)]


def reduce_common(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to smoke-test size, keeping its family features."""
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
    if cfg.moe is not None:
        base["moe"] = dataclasses.replace(cfg.moe, num_experts=4,
                                          top_k=min(cfg.moe.top_k, 2))
    if cfg.ssm is not None:
        base["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=8,
                                          chunk=16)
    if cfg.family == "encdec":
        base["encoder_layers"] = 2
        base["decoder_layers"] = 2
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
